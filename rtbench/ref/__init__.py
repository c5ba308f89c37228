"""The benchmark's reference: a frozen copy of ray_tpu_torch's plain
PyTorch path (scene compile, plain traversal, integrator), taken when the
port's first benchmark was written, cut to what its configurations reach.

It imports nothing of the port.  It keeps the brute-force test of small
flattened scenes and the 8-wide two-level walk, the numpy SAH builder,
DIFFUSE / PRINCIPLED / EMISSIVE materials, sphere and emissive-triangle
lights, a constant environment and uncompressed textures; anything else
raises (``scene/scene.py``).  Its own additions: ``render_tile`` takes a
tensor ``iteration`` (one sample a lane, for a batch of chosen (pixel,
iteration) pairs) and ``PassSettings.state_bf16`` (the control: the path
state stored in bfloat16); ``raygen.rays_at`` gives the primary rays of
any lanes."""
