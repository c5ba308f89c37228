#!/usr/bin/env python3
"""Run the port's frames on one CUDA card and check them.

    python3 chip_smoke.py

Drives ``ray_tpu_torch`` (never JAX, never ``ray_tpu``) through the entry
points a user calls — a scene → ``Scene.finalize()`` → ``render_tile`` at
1920x1080, 1 spp, depth 5, for fwd+bwd the bench loss through autograd,
and ``create_renderer`` → ``Renderer.render`` → ``pixels`` — on five
scenes:

* the flagship ``cornell_scene("emissive_quad")`` (24 triangles: every
  trace goes to ``trace_brute``);
* ``cornell_sphere``: the flagship plus a rough diffuse UV sphere (376
  triangles, 59 nodes: every trace goes to ``trace_bvh``);
* ``colonnade_scene``, bench.py's big scene: 324,642 instanced triangles
  over 8,388 unique in 81 instances, a texture, PRINCIPLED materials, 12
  sphere lights: every trace goes to ``trace_tlas``.  Forward at bench.py's
  big-scene settings without remat (compaction after bounce 2), and
  fwd+bwd at bench.py's ``settings_big`` (the same with ``remat=True``:
  path replay), rendered as a 2x2 grid of 960x540 tiles as bench.py does;
* the colonnade finalized with ``instancing="flatten"`` (the 324,642
  triangles in one BVH2 from the native builder, 67,138 8-wide rows):
  every trace goes to ``trace_tlas`` over the flatten ``wrows`` (the wide
  route, ``trace_wide``), at the same settings and grid;
* ``colonnade_scene(n_cols=5)`` finalized with ``instancing="flatten",
  pallas_binned=True`` (169,890 triangles in 469 subtree slabs): every
  trace goes to ``trace_binned``, at the same settings and grid;

and the shading slice's five: the scenes of ``ray_tpu``'s CPU goldens
(``tests/goldens_cpu``; ``ray_tpu_torch.utils.test_scenes.GOLDEN_SCENES``)
— ``rect_disk`` (rect and disk lights), ``sphere_spot_line`` (sphere,
spot and line lights), ``dir_env`` (a directional light and a constant
environment over 2,210 triangles: the wide route), ``tri_glass`` (an
emissive quad and a REFRACTIVE box) — and ``alpha_box`` (a rect-lit
Cornell box whose tall box has principled alpha 0.5: Mix(Transparent,
principled), both transparency marches);

and the traversal slice's six (``SLICE``): ``cornell_tlas`` (the flagship
finalized with ``instancing="tlas"``: 24 unique triangles, no
``wrows_tlas``, so every trace takes ``trace_tlas_bin``, the binary
two-level walk, and its TRI lights are instanced), ``cornell_vis`` (the
flagship and three instances of a box, each hidden from one ray type) in
flatten mode (the masked ``trace_bvh``) and tlas mode (``trace_tlas_bin``
with ray masks), ``sphere_vis`` (``cornell_sphere`` with a
camera-invisible sphere) in flatten mode (the masked wide route) and tlas
mode (``trace_tlas`` with ray masks), and ``env_map`` (``dir_env`` under a
512x256 latlong environment map: importance-sampled environment NEE);

and the sky and texture slice's four (``SKY``): ``physical_sky``
(``samples/05_physical_sky.py``'s scene: a 2-triangle floor under the
physical sky baked at 256x128 with clouds, moon, stars and cirrus, and
the sun as a directional light: ``trace_brute``), ``tex_features``
(``env_map``'s layout with an RGBE environment map, a BC1 base, BC4
roughness and BC5 normal map on an anisotropic, turned PRINCIPLED ball,
a raw ground texture: the wide route of ``trace_tlas``), ``sphere_hlbvh``
(``cornell_sphere`` finalized ``fast_build=True``: the HLBVH tree on
``trace_bvh``) and the flagship with ``output_sh`` (``trace_brute``);

and the cache and denoising slice's (``SBVH``): ``cornell_sphere`` and
the instanced colonnade finalized with ``spatial_splits=True`` (the SBVH
under ``trace_bvh`` and ``trace_tlas``; the colonnade's ~41 s numpy
finalize runs in a worker process, ``chip_smoke.py --sbvh-scene PATH``,
beside the card's phases), the flagship through ``create_renderer`` with
``use_spatial_cache=True`` (the spatial radiance cache and
``radcache_accumulate``), ``samples/04_denoising.py``'s ``main()`` and the
NLM and UNet denoisers at 1080p;

and the last slice's (``LIGHTMAP``, the sharded paths): lightmaps baked
through ``bake_lightmap`` at 1024x1024 (the flagship's back wall:
``trace_brute``; ``cornell_sphere``'s sphere: ``trace_bvh``), the
flagship at 1080p through ``render_sharded`` and
``render_sharded_balanced`` and the sharded train step
(``ray_tpu_torch.parallel.train``) on a 1-rank NCCL tile mesh,
``samples/02_multichip.py``'s ``main()`` through ``render_sharded``, and
the RNG's PMJ02 table mode.

Phases:

1. the card's name and power limit (``nvidia-smi``); exits non-zero when
   CUDA is absent;
2. builds the eight CUDA sources of ``ray_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and prints the build seconds;
3. holds each kernel bit-exact against its plain PyTorch version: the
   gather probe's ``gather_table`` on the probe's own inputs, on a table
   with NaNs and -0 and on 2,073,600 random lanes; the RNG's
   ``rng_draw`` (``scrambled_2d_rand`` in computed and table mode, ``dim``
   and ``sample`` each an int and per lane, and ``pixel_seed``) over a
   frame's 2,073,600 lanes (``rng_cases``); the traces on the
   traversal tests' generator scenes (at 2M rays brute 8/24/40 triangles,
   BVH 100/300/500 and 512 in leaves of one (511 nodes, the largest
   tables), TLAS 6 and 64 instances of one mesh and a 12,600-row
   table of five meshes, one run with a ray mask; at 300,000 rays binned
   clouds of 20,000 and 120,000 triangles, with the sort key), on inputs
   that stress exactness (``stress_cases``: the triangle test's edge
   cases for ``trace_brute`` and ``trace_bvh`` — det exactly 0 and
   subnormal, U and V whose products round to -0, rays through vertices
   and along edges, t exactly at t_min and t_max, t_min < 0, equal t, inf
   and NaN components, a stack of 2, max_leaf 15, all lanes inactive —
   ``edge_cases``; a binned grid cloud whose
   subtree boxes share faces under axis-aligned rays, so that the sid
   tie-break decides, and its stack cut below the need; trace_tlas on
   width-56 and width-88 tables with a ray mask and a short stack; rays
   inside boxes, zero and NaN direction components, NaN origins, t_min >
   0), in both modes, and on the inputs of all 12 launches of one frame of
   the flagship and ``cornell_sphere`` and of one 960x540 tile of each
   colonnade (the binned tile's sort keys too), and every launch of one
   frame of ``tri_glass``, ``dir_env`` and ``alpha_box`` (the marches'
   traces included); the slice's kernels on its generator cases at
   2,073,600 rays (``slice_generator_cases``: ``trace_tlas_bin`` on 24
   non-uniformly scaled instances with RAY_CAMERA / RAY_SHADOW masks, on
   stress rays and with a stack of 3; the masked ``trace_bvh`` and wide
   route with random masks; ``trace_tlas`` at ``max_leaf`` 6 and 7, whose
   rows it pads) and on every launch of one frame of each ``SLICE``
   scene, and of one frame of each ``SKY`` scene; every launch of a
   1080p frame of each ``SBVH`` scene (the colonnade's 2x2 grid), with
   its finalize seconds against the SAH one's; ``radcache_accumulate``
   on ``COLLIDE`` (64 entries, 20,000 lanes) and on each of
   ``ACC_STRESS`` (``accumulate_stress_case``), twice, the runs
   bit-identical, and its 100,000-lane segment timed beside
   ``index_add_``;
4. holds a 64x48 tile of each scene rendered on the card against the same
   tile on the port's plain CPU path (the colonnade's covers columns,
   terrain and floor; the alpha box's lies on the box, which stands in the
   floor's plane, and the same box lifted 2 mm is held beside it; the
   slice's at ``SLICE_TILES``, the sky slice's at ``SKY_TILES``), and the
   sky bake at 64x32 on the card against the CPU (``SKY_BAKE_SHARE`` of
   texels within ``SKY_BAKE_REL``, the worst printed); the ``SBVH``
   scenes' tiles (the colonnade's CPU copy loaded from the worker's
   file);
5. the forward main paths: ``FRAMES`` frames of each scene after a warm-up
   frame, the launch counts set to 0 just before each and read just after
   (6 closest-hit + 6 any-hit launches a tile of its kernel, none of the
   others, and one binned sort key a ``trace_binned`` launch; a colonnade
   frame is 4 tiles): Mray/s, frame ms and spread, peak memory; and one
   more instanced colonnade line at grid 1x1; ``SHADING_FRAMES`` frames of
   each shading scene (6 closest-hit and 6 any-hit launches a frame, and
   one closest-hit launch a march trace; a scene with transparency
   launches no any-hit trace), with the launches a frame split into
   closest-hit, any-hit and march, and the marches' host syncs a frame;
   each ``SLICE`` scene's frames (``cornell_tlas`` ``FRAMES``, the others
   ``SHADING_FRAMES``; the colonnades' 2x2 lines ``COLONNADE_FRAMES``), and
   the ``cornell_tlas`` frame against the flatten flagship's at one
   iteration (means within ``TLAS_VS_FLATTEN_REL``); ``SKY_FRAMES`` frames
   of each ``SKY`` scene, the SH frame's L0 band against 0.282095 x its
   color; ``samples/05_physical_sky``'s ``main()`` on the port's API
   (``create_renderer`` → 16 samples → ``pixels(AGX)`` at 256x256, its TGA
   in ``OUT_DIR``); ``SBVH_FRAMES`` frames of each ``SBVH`` scene;
   then the goldens: each golden scene through ``create_renderer`` at the
   golden's 64x64, pass settings and 400 samples, through ``pixels`` to
   uint8, against the committed ``.npz``: ≥ 28 dB PSNR, ≤ 40 fireflies
   (``tests/test_cpu_goldens.py``'s gate), dB, fireflies and seconds
   printed;
6. the fwd+bwd paths: ``BWD_FRAMES`` frames of each Cornell scene, the
   bench loss differentiated w.r.t. the float material columns and
   ``env_col`` (leaf tensors, as ``bench.py`` sets them): Mray/s, frame ms
   split into forward and backward, peak memory, launch counts, gradients
   finite and non-zero for ``base_color`` and ``env_col``; a 64x48 fwd+bwd
   tile of ``cornell_sphere`` on the card against the CPU path's
   gradients; the flagship frame with remat against stored residuals (loss
   bit-identical, gradients within 1e-4 of each column's scale); a
   ``tri_glass`` (1x1) and an ``alpha_box`` (2x2) fwd+bwd 1080p frame each
   with stored residuals and with remat (loss bit-identical, gradients
   finite and non-zero for ``base_color`` and ``env_col``, each launching
   its forward's traces, marches included, and none in backward), and the
   two policies' gradient columns within ``REMAT_NOISE_MULT`` times the
   largest gap between two of ``REMAT_NOISE_RUNS`` stored-residual runs at
   1080p (or 1e-4) and within 1e-4 on a 480x270 tile with deterministic
   reductions; ``cornell_tlas`` (1x1)
   and ``env_map`` (2x2) fwd+bwd with stored residuals over
   ``SLICE_BWD_FRAMES`` frames, each with a 64x48 gradient tile card vs
   CPU; ``tex_features`` (2x2) likewise over ``SKY_BWD_FRAMES``;
7. the colonnade's fwd+bwd: ``COLONNADE_BWD_FRAMES`` 2x2 frames with remat
   (each tile its own backward, the gradients summed; 24 + 24
   ``trace_tlas`` launches a frame, none in backward), one frame with
   ``remat_save_trace=False`` (the backward launches them again), the same
   frames with stored residuals, and a 64x48 remat gradient tile on the
   card against the CPU path;
8. the renderer: ``create_renderer`` → 8 samples of the flagship at
   1920x1080 → ``pixels`` with AgX (LUT) and filmic, then 8 adaptive
   samples (ms a sample, Mray/s, 6 + 6 ``trace_brute`` launches a sample);
   a 64x48 adaptive renderer on the card against the CPU; the README
   quickstart at 512x512, 16 samples; then the cache and denoising:
   ``CACHE_SAMPLES`` cached samples of the flagship at 1920x1080 (update
   pass, resolve, query sample ms; warm entries; the longest accumulate
   segment; every ``radcache_accumulate`` launch bit-exact against the
   plain version on its inputs copied to the CPU; the mean within
   ``CACHE_MEAN_REL`` of an uncached renderer's; two runs of
   ``CACHE_DET_SAMPLES`` samples bit-identical), a 64x48 cached renderer
   card vs CPU, ``samples/04_denoising``'s ``main()`` (its TGAs in
   ``OUT_DIR``) with NLM and UNet card vs CPU on its buffers, NLM and UNet
   at 1080p (ms, peak memory); then the lightmaps: each ``LIGHTMAP`` bake
   at 1024x1024 (rasterizer host s, every trace launch of an iteration
   bit-exact against the plain version, ms an iteration, Mray/s, peak
   memory, 6 + 6 launches an iteration, the SH L0 band against 0.282095 x
   color) and a ``LIGHTMAP_CHECK`` bake card vs CPU; a 1-rank NCCL group
   through a ``file://`` store and its tile mesh: the sharded and the
   balanced flagship frame bit-identical to ``render_tile`` and timed in
   turns with it, the sharded train step at 1080p (loss bit-identical to
   an unsharded step's, gradients within the atomics' noise), sample 02;
   one PMJ02 table draw over 2,073,600 lanes card vs CPU, timed beside
   the computed mode; then the sky bake at ``SKY_BAKE``:
   forward ms, its CUDA kernel count, fwd+bwd ms w.r.t.
   ``atmosphere_density`` and ``clouds_density`` and the backward's peak
   memory, beside the sky scene's finalize;
9. profiles one forward and one fwd+bwd flagship frame and one forward
   960x540 tile (the top-right one) of the instanced and of the binned
   colonnade with ``torch.profiler``: device time, its share of the
   unprofiled frame (of a quarter of the 2x2 frame for a tile); the RNG's
   cost: the draws of one flagship frame, one draw over a frame's lanes
   through the kernel (back to back, and in one CUDA graph: device time)
   beside the plain int64 route and the bound, and ``pixel_seed`` alike;
   op tables in ``OUT_DIR``;
10. times each kernel (CUDA events) at its frame's (a colonnade: its
   tile's) launch shapes beside its plain version (``trace_binned``'s on
   one launch of each mode: it takes seconds) and its bound, ``gather_table``
   at the probe's size and a frame's beside its plain version and
   ``index_select``, and ``trace_tlas`` over the binned scene's ``wrows``
   on the binned tile's rays (the wide route that scene takes without
   ``pallas_binned``), and the binned tile's sort keys (kernel, plain,
   bound); the slice's kernels on the launches of a ``cornell_tlas``
   (``trace_tlas_bin``), a ``cornell_vis`` flatten (``trace_bvh_vis``) and
   a ``sphere_vis`` flatten frame (``trace_tlas_vis``), each masked
   kernel beside its unmasked one on the same rays; ``radcache_accumulate``
   on the last update pass's lanes beside its plain version and
   ``index_add_`` (both back to back, as every kernel, and in one CUDA
   graph: device time), and the whole ``accumulate_segments`` call beside
   the plain version (mask + ``index_add_`` x2); and prints one
   ``kernels`` JSON line (18 entries), the card line, and last the
   ``{"ok": true, ...}`` line.

Any failed check exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

WIDTH, HEIGHT = 1920, 1080
# frame counts, cut as the script grows to keep it inside its time limit
# (the spread of each line is printed): FRAMES 10 -> 6, the colonnades'
# 2x2 forward lines 10 -> 3 -> 2, their fwd+bwd 3 -> 2 -> 1
FRAMES = 6
COLONNADE_FRAMES = 2
BWD_FRAMES = 5
COLONNADE_BWD_FRAMES = 1  # bench.py runs 3
FRAMES_1X1 = 3
GRID = (2, 2)  # bench.py renders the big scene as 2x2 tiles
OUT_DIR = pathlib.Path(__file__).resolve().parent / "chiprun_out"
KERNELS = {
    "trace_brute": dict(source="ray_tpu_torch/csrc/trace_brute.cu",
                        replaces="ray_tpu/ops/traverse_pallas.py:57"),
    "trace_bvh": dict(source="ray_tpu_torch/csrc/trace_bvh.cu",
                      replaces="ray_tpu/ops/traverse_pallas.py:204"),
    "trace_tlas": dict(source="ray_tpu_torch/csrc/trace_tlas.cu",
                       replaces="ray_tpu/ops/traverse_pallas.py:501"),
    "trace_binned": dict(source="ray_tpu_torch/csrc/trace_binned.cu",
                         replaces="ray_tpu/ops/traverse_pallas.py:939"),
    # the traversal slice: the masked instantiations of trace_bvh.cu (the
    # per-triangle test of ray_tpu's XLA walk _traverse) and of
    # trace_tlas.cu (the has_vis leaf test of _traverse_wide), and the
    # binary two-level walk _traverse_tlas (XLA in ray_tpu)
    "trace_bvh_vis": dict(source="ray_tpu_torch/csrc/trace_bvh.cu",
                          replaces="ray_tpu/ops/traverse.py:118"),
    "trace_tlas_vis": dict(source="ray_tpu_torch/csrc/trace_tlas.cu",
                           replaces="ray_tpu/ops/traverse.py:236"),
    "trace_tlas_bin": dict(source="ray_tpu_torch/csrc/trace_tlas_bin.cu",
                           replaces="ray_tpu/ops/traverse.py:844"),
}
# the CUDA sources to build, one nvcc each
SOURCES = ("trace_brute", "trace_bvh", "trace_tlas", "trace_tlas_bin",
           "trace_binned", "gather_table", "radcache_accumulate", "rng_draw")
# the wrapper each kernel family launches through (the masked ones: their
# unmasked wrapper with the masks as keywords)
WRAPPER = {"trace_bvh_vis": "trace_bvh", "trace_tlas_vis": "trace_tlas"}
# the gather probe's table length (scripts/test_pallas_gather.py N)
GATHER_TABLE = 1024
GATHER = dict(source="ray_tpu_torch/csrc/gather_table.cu",
              replaces="scripts/test_pallas_gather.py:31")
# the RNG's draw and pixel seed (XLA in ray_tpu: no TPU kernel)
RNG = dict(source="ray_tpu_torch/csrc/rng_draw.cu",
           replaces="ray_tpu/ops/rng.py:184, :248 (XLA)")
# the seeds each RNG case's lanes start with, and the frame seeds of
# pixel_seed: 0, 1, 2^31 and 2^32 - 1
RNG_SEEDS = (0, 1, 1 << 31, (1 << 32) - 1)
# trace_binned's sort-key kernel: the first-subtree pre-pass of
# trace_flat_binned (XLA in ray_tpu, beside its pallas_call)
SORTKEY = dict(source="ray_tpu_torch/csrc/trace_binned.cu",
               replaces="ray_tpu/ops/traverse_pallas.py:1255")
# the binned scene: the largest colonnade whose subtree partition fits in
# 512 slabs (S = 469)
BINNED_COLS = 5
# the binned generator clouds (tests/test_traverse_pallas.py:196-246)
BINNED_CLOUDS = (20_000, 120_000)
# rays of each exactness stress case (stress_cases)
STRESS_RAYS = 100_000
# the colonnade's instance layout (colonnade_scene): columns, terrain, floor
COLONNADE_COLUMNS, COLONNADE_TERRAIN = 64, 16
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# one ray-triangle test: 46 float multiply/add/subtract/divide (compares
# are not counted); one child box: 6 subtract, 6 multiply, 1 slack
# multiply, two boxes a node step
OPS_PER_TEST = 46
OPS_PER_NODE_STEP = 2 * 13
# a wide node step tests 8 child boxes; an instance entry transforms the
# origin (18 ops) and the direction (15) and takes 3 reciprocals
OPS_PER_WIDE_NODE_STEP = 8 * 13
OPS_PER_INST_ENTRY = 36
# the binned walk tests one subtree box (13 ops) per subtree it walks:
# what these inputs need, whatever finds the subtree
OPS_PER_BOX_TEST = 13
# every lane reads t_max, active (5 B) and writes t, u, v, prim, backface
# (17 B); an active lane also reads ro, rd, t_min (28 B).  trace_tlas also
# writes the instance row (4 B) and reads a ray mask when given (4 B)
BYTES_PER_LANE = 22
BYTES_PER_ACTIVE_LANE = 28
TLAS_EXTRA_BYTES_PER_LANE = 4
# the sort key: every lane reads active and writes its key (5 B), an
# active lane reads ro, rd, t_min, t_max (32 B); the boxes are read once
SORTKEY_BYTES_PER_LANE = 5
SORTKEY_BYTES_PER_ACTIVE_LANE = 32
# zeroed ray counters a timed closure cycles through (trace_binned's
# persistent warps take their rays from one; the wrapper zeroes a fresh
# one a launch)
COUNTER_POOL = 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    import torch

    if a.dtype == torch.bool or a.dtype == torch.int32:
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    return float((a - b).abs().max())


def cornell_sphere():
    """The flagship Cornell box plus a rough diffuse UV sphere (376
    triangles), from the public API."""
    from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
    from ray_tpu_torch.utils.geometry import make_uv_sphere
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    sc, cam = cornell_scene("emissive_quad")
    m = sc.add_material(MaterialDesc(type=ShadingNode.DIFFUSE,
                                     base_color=(0.2, 0.3, 0.8), roughness=0.5))
    v, idx, n, uv = make_uv_sphere(center=(0.4, -0.64, -0.3), radius=0.35,
                                   rings=12, segments=16)
    sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
    return sc, cam


def flagship():
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    return cornell_scene("emissive_quad")


def colonnade():
    from ray_tpu_torch.utils.test_scenes import colonnade_scene

    return colonnade_scene()


def colonnade_binned():
    from ray_tpu_torch.utils.test_scenes import colonnade_scene

    return colonnade_scene(n_cols=BINNED_COLS)


# how each scene is finalized (beside the device)
FINALIZE = {
    "colonnade flatten": dict(instancing="flatten"),
    "colonnade binned": dict(instancing="flatten", pallas_binned=True),
    "cornell_sphere sbvh": dict(spatial_splits=True),
}


# generator two-level scenes: (meshes, instances of each)
TLAS_CASES = {
    "6 instances": (((12, 16),), 6),
    "64 instances": (((12, 16),), 64),
    # five meshes of 5,800-6,300 triangles, 8 instances each: 12,600 rows,
    # past ray_tpu's T_MAX_TLAS_ROWS (8,192)
    "5 meshes": (((40, 80), (44, 72), (36, 90), (50, 60), (30, 100)), 8),
}


def generator_case(kernel, n_tris, n_rays, seed, device, max_leaf=None):
    """The traversal tests' random scene and rays (tests/test_traverse_pallas.py
    ``_scene`` / ``_rays``): the arguments of ``trace_brute`` (packed
    (T, 9) triangles) or of ``trace_bvh`` (a BVH2 with max_leaf 4 or 8 and
    the scene's stack size, depth + 4; ``max_leaf`` overrides the leaf
    size); for ``trace_tlas`` ``n_tris`` is a
    ``TLAS_CASES`` entry and the rays are tests/test_traverse_tlas_pallas.py's
    (origins in a cube around the instances, every 17th lane inactive); for
    ``trace_binned`` the slab tables of the BVH2 (max_leaf 4) and the rays
    of the other kernels."""
    import numpy as np
    import torch

    from ray_tpu_torch.scene.bvh import (
        build_bvh2, bvh_depth, pack_bvh_soa, tri_bounds)

    r = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    if kernel == "trace_tlas":
        from ray_tpu_torch.utils.test_scenes import instanced_scene

        meshes, n_inst = n_tris
        scene = instanced_scene(meshes, n_inst, seed).finalize(device=device)
        ro = r.uniform(-4.0, 4.0, (n_rays, 3)).astype(np.float32)
        rd = r.normal(size=(n_rays, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        active = np.ones(n_rays, bool)
        active[::17] = False
        return (scene.bvh_soa["wrows_tlas"], int(scene.bvh_soa["winst_base"]),
                t(ro), t(rd), torch.zeros(n_rays, device=device),
                torch.full((n_rays,), 1e30, device=device), t(active), None,
                scene.max_leaf, scene.stack_size)
    base = (r.rand(n_tris, 1, 3) - 0.5) * 10.0
    size = max(0.8, 12.0 / np.sqrt(n_tris))
    tris = (base + (r.rand(n_tris, 3, 3) - 0.5) * size).astype(np.float32)
    r = np.random.RandomState(seed + 1)
    ro = (r.rand(n_rays, 3).astype(np.float32) - 0.5) * 12.0
    target = (r.rand(n_rays, 3).astype(np.float32) - 0.5) * 6.0
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rays = (t(ro), t(rd.astype(np.float32)),
            torch.zeros(n_rays, device=device),
            torch.full((n_rays,), 1e30, device=device),
            torch.ones(n_rays, dtype=torch.bool, device=device))
    if kernel == "trace_brute":
        return (t(tris.reshape(n_tris, 9)),) + rays
    v = tris.reshape(-1, 3)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    lo, hi = tri_bounds(v, idx)
    if kernel == "trace_binned":
        # the native builder (from 8,192 triangles on), max_leaf 4
        from ray_tpu_torch.scene.binned import pack_binned_scene
        from ray_tpu_torch.scene.bvh import pack_tri_soa

        bvh = build_bvh2(lo, hi, max_leaf=4)
        binned = pack_binned_scene(bvh, pack_tri_soa(v, idx[bvh.prim_indices]))
        return ({k: t(a) for k, a in binned.items()},) + rays + (4,)
    if max_leaf is None:
        max_leaf = 4 if n_tris <= 100 else 8
    bvh = build_bvh2(lo, hi, max_leaf=max_leaf)
    return ((t(pack_bvh_soa(bvh)["packed"]),
             t(v[idx[bvh.prim_indices]].reshape(n_tris, 9)))
            + rays + (max_leaf, bvh_depth(bvh) + 4))


def stress_rays(n_rays, lo, hi, seed, device):
    """Rays that stress exactness over the box [lo, hi]: a third axis-aligned
    (+-x, +-y, +-z) from outside with the other two coordinates on the
    half-integer lattice (entries tie on shared faces), a quarter starting
    inside the box, a sixth with one zero direction component, 1% a NaN
    direction component, 1% a NaN origin; t_min > 0 on 30%, a finite t_max
    on 20%, every 11th lane inactive.  (ro, rd, t_min, t_max, active)."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    span = hi - lo
    ro = (lo + r.rand(n_rays, 3) * span).astype(np.float32)
    rd = r.normal(size=(n_rays, 3)).astype(np.float32)
    kind = r.rand(n_rays)
    axis_al = kind < 1 / 3
    axis = r.randint(0, 3, n_rays)
    sign = np.where(r.rand(n_rays) < 0.5, -1.0, 1.0).astype(np.float32)
    lattice = (np.floor(lo) + r.randint(0, 2 * int(span) + 1, (n_rays, 3))
               / 2.0).astype(np.float32)
    ro[axis_al] = lattice[axis_al]
    rd[axis_al] = 0.0
    rows = np.nonzero(axis_al)[0]
    ro[rows, axis[rows]] = np.where(sign[rows] > 0, lo - 2.0, hi + 2.0)
    rd[rows, axis[rows]] = sign[rows]
    zero = (kind >= 1 / 3) & (kind < 1 / 2)
    rd[zero, axis[zero]] = 0.0
    rd[~axis_al] /= np.linalg.norm(rd[~axis_al], axis=1, keepdims=True)
    rd[(kind >= 0.98) & (kind < 0.99), 1] = np.nan
    ro[kind >= 0.99, 0] = np.nan
    t_min = np.where(r.rand(n_rays) < 0.3, r.rand(n_rays) * 3.0, 0.0)
    t_max = np.where(r.rand(n_rays) < 0.8, 1e30, r.rand(n_rays) * span * 2)
    active = np.ones(n_rays, bool)
    active[::11] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(ro), t(rd), t(t_min.astype(np.float32)),
            t(t_max.astype(np.float32)), t(active))


def grid_cloud(n, fill, seed):
    """Unit cubes (12 triangles each) on a random ``fill`` share of the
    cells of an n^3 integer lattice: neighbouring cubes share faces, and so
    do the subtree boxes of its partition.  (T, 3, 3) f32."""
    import numpy as np

    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                       np.float32)
    faces = np.array([(0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6), (0, 4, 5),
                      (0, 5, 1), (3, 2, 6), (3, 6, 7), (0, 3, 7), (0, 7, 4),
                      (1, 5, 6), (1, 6, 2)])
    cells = np.stack(np.meshgrid(*(np.arange(n),) * 3, indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float32)
    cells = cells[np.random.RandomState(seed).rand(len(cells)) < fill]
    return (cells[:, None, None, :] + corners[faces][None]).reshape(-1, 3, 3)


# the edge-case triangles (edge_tris): the huge one's legs and the tiny
# one's size, as powers of two
EDGE_HUGE = (62, 58)
EDGE_TINY = -68


def edge_tris(n_random, seed):
    """(T, 9) f32 triangles for the Möller–Trumbore edge cases, and the
    number of special ones leading the table: two degenerate ones (p1 = p0,
    and p2 on the line of p0 p1: det is exactly 0), a huge one at the
    origin (legs 2^62 and 2^58: det near 2^120, so a ray starting 2^-90
    from its p0 has U, V whose products with 1 / det round to +-0), a tiny
    one (2^-68: det subnormal, 1 / det = +-inf), a copy of the first random
    triangle (equal t: the lower index must win) and that triangle wound
    the other way; then ``n_random`` of the traversal tests' random
    triangles, the first two of them sharing an edge."""
    import numpy as np

    r = np.random.RandomState(seed)
    rnd = ((r.rand(n_random, 1, 3) - 0.5) * 8.0
           + (r.rand(n_random, 3, 3) - 0.5) * 3.0)
    rnd[1] = rnd[0][[2, 1, 0]]
    rnd[1, 1] = 2 * rnd[0, 0] - rnd[0, 1]
    hx, hy = 2.0 ** EDGE_HUGE[0], 2.0 ** EDGE_HUGE[1]
    s = 2.0 ** EDGE_TINY
    special = np.array([
        [[1.0, 2.0, 0.5], [1.0, 2.0, 0.5], [2.0, -1.0, 0.0]],
        [[-1.0, 0.0, 1.0], [1.0, 1.0, 1.0], [5.0, 3.0, 1.0]],
        [[0.0, 0.0, 0.0], [hx, 0.0, 0.0], [0.0, hy, 0.0]],
        [[0.0, 0.0, 0.0], [s, 0.0, s], [0.0, s, 0.5 * s]],
        rnd[0],
        rnd[0][[0, 2, 1]],
    ])
    tris = np.concatenate([special, rnd]).astype(np.float32)
    return tris.reshape(-1, 9), len(special)


def edge_rays(tris, special, n_rays, seed, device):
    """Rays aimed at the triangles of ``edge_tris`` to meet the test's edge
    cases.  Each lane picks a triangle (half the lanes one of the rows
    ``special``: edge_tris's special triangles, in whatever order the
    table holds them) and a point on it by barycentrics: a vertex, an edge
    (u + v = 1 among them), the centre, just outside an edge, or anywhere.
    It starts at that point, or 1 or 3 before it along a random direction
    (a sixth axis-aligned, a sixth with a zero component), or 1 past it (t
    = -1); a tenth of the lanes aimed at the huge triangle start 2^-90 from
    its p0 instead.  Then t_min = t (the plain arithmetic's own t of the
    aimed triangle) on 10% of the lanes, t_max = t on 10%, t_min < 0 on
    15%, and t_min = -4 with t_max one step above t on 10%; 2% get an inf
    and 2% a NaN direction component, 1% a NaN origin; every 13th lane is
    inactive.  (ro, rd, t_min, t_max, active) on ``device``."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import traverse

    r = np.random.RandomState(seed)
    T = tris.shape[0]
    p = tris.reshape(T, 3, 3).astype(np.float64)
    special = np.asarray(special)
    k = np.where(r.rand(n_rays) < 0.5,
                 special[r.randint(0, len(special), n_rays)],
                 r.randint(0, T, n_rays))
    bary = np.array([[0, 0], [1, 0], [0, 1], [0.5, 0.5], [0.25, 0.75],
                     [0.5, 0], [0, 0.5], [1 / 3, 1 / 3], [-1e-6, 0.5],
                     [0.5, 0.5 + 1e-6]], np.float64)
    pick = r.randint(0, len(bary) + 2, n_rays)
    b = np.empty((n_rays, 2))
    known = pick < len(bary)
    b[known] = bary[pick[known]]
    anywhere = pick == len(bary)
    b[anywhere] = r.uniform(-0.2, 1.2, (int(anywhere.sum()), 2))
    edge = pick == len(bary) + 1
    b[edge, 0] = r.rand(int(edge.sum()))
    b[edge, 1] = 1.0 - b[edge, 0]
    p0 = p[k, 0]
    target = p0 + b[:, :1] * (p[k, 1] - p0) + b[:, 1:] * (p[k, 2] - p0)
    d = r.normal(size=(n_rays, 3))
    kind = r.rand(n_rays)
    axis = r.randint(0, 3, n_rays)
    al = kind < 1 / 6
    d[al] = 0.0
    d[al, axis[al]] = np.where(r.rand(int(al.sum())) < 0.5, -1.0, 1.0)
    zero = (kind >= 1 / 6) & (kind < 1 / 3)
    d[zero, axis[zero]] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.choose(r.randint(0, 4, n_rays), [0.0, 1.0, 3.0, -1.0])
    o = target - dist[:, None] * d
    near_p0 = (k == special[2]) & (r.rand(n_rays) < 0.1)
    o[near_p0] = (r.choice([-1.0, 1.0], (int(near_p0.sum()), 3))
                  * 2.0 ** -90 * r.rand(int(near_p0.sum()), 3))
    ro = torch.from_numpy(o.astype(np.float32))
    rd = torch.from_numpy(d.astype(np.float32))
    # the plain arithmetic's t of the aimed triangle
    t_tris = torch.from_numpy(tris)[torch.from_numpy(k)]
    inf = torch.full((n_rays,), float("inf"))
    _, t_aim, _, _, _ = traverse._tri_c(*ro.unbind(1), *rd.unbind(1), t_tris,
                                        torch.zeros(n_rays), inf)
    t_min = torch.zeros(n_rays)
    t_max = torch.full((n_rays,), 1e30)
    u = torch.from_numpy(r.rand(n_rays))
    at_min, at_max = u < 0.1, (u >= 0.1) & (u < 0.2)
    neg, above = (u >= 0.2) & (u < 0.35), (u >= 0.35) & (u < 0.45)
    t_min[at_min] = t_aim[at_min]
    t_max[at_max] = t_aim[at_max]
    t_min[neg] = -torch.from_numpy(r.rand(n_rays).astype(np.float32))[neg]
    # t_max one step above t (below 0 for the rays that start past it)
    t_min[above] = -4.0
    t_max[above] = torch.nextafter(t_aim[above],
                                   torch.tensor(float("inf")))
    odd = torch.from_numpy(r.rand(n_rays))
    rd[odd < 0.02, 0] = float("inf")
    rd[(odd >= 0.02) & (odd < 0.04), 1] = float("nan")
    ro[(odd >= 0.04) & (odd < 0.05), 2] = float("nan")
    active = torch.ones(n_rays, dtype=torch.bool)
    active[::13] = False
    return tuple(a.contiguous().to(device)
                 for a in (ro, rd, t_min, t_max, active))


def edge_cases(n_rays, device):
    """{label: (kernel, args)} of the triangle test's edge cases
    (``edge_tris`` / ``edge_rays``): ``trace_brute`` on the 6 special
    triangles and 26 random ones, ``trace_bvh`` on the 6 and 196 random
    ones in a BVH2 of max_leaf 15, with the scene's stack and with a stack
    of 2 (overflow), and an all-inactive launch of each."""
    import numpy as np
    import torch

    from ray_tpu_torch.scene.bvh import (
        build_bvh2, bvh_depth, pack_bvh_soa, tri_bounds)

    tris, n_special = edge_tris(26, 3)
    rays = edge_rays(tris, np.arange(n_special), n_rays, 4, device)
    off = rays[:4] + (torch.zeros_like(rays[4]),)
    t_dev = torch.from_numpy(tris).to(device)
    cases = {"brute edge triangles": ("trace_brute", (t_dev, *rays)),
             "brute all inactive": ("trace_brute", (t_dev, *off))}
    big, n_special = edge_tris(196, 3)
    v = big.reshape(-1, 3)
    idx = np.arange(v.shape[0], dtype=np.int32).reshape(-1, 3)
    bvh = build_bvh2(*tri_bounds(v, idx), max_leaf=15)
    leaf = np.ascontiguousarray(v[idx[bvh.prim_indices]].reshape(-1, 9))
    nodes = torch.from_numpy(pack_bvh_soa(bvh)["packed"]).to(device)
    # the special triangles' rows in leaf order
    special = np.argsort(bvh.prim_indices)[:n_special]
    rays = edge_rays(leaf, special, n_rays, 5, device)
    off = rays[:4] + (torch.zeros_like(rays[4]),)
    leaf = torch.from_numpy(leaf).to(device)
    stack = bvh_depth(bvh) + 4
    cases["bvh edge triangles, max_leaf 15"] = ("trace_bvh", (
        nodes, leaf, *rays, 15, stack))
    cases["bvh edge triangles, stack 2"] = ("trace_bvh", (
        nodes, leaf, *rays, 15, 2))
    cases["bvh all inactive"] = ("trace_bvh", (nodes, leaf, *off, 15, stack))
    return cases


def stress_cases(n_rays, device):
    """{label: (kernel, args)} of the exactness stress inputs: the triangle
    test's edge cases (``edge_cases``), a binned grid cloud (ties in
    t_enter), its stack cut below the partition's need (the overflow
    path), and trace_tlas on a width-56 two-level table (with a ray mask)
    and a width-88 flatten table, all with ``stress_rays``."""
    import numpy as np
    import torch

    from ray_tpu_torch.scene.binned import pack_binned_scene
    from ray_tpu_torch.scene.bvh import build_bvh2, pack_tri_soa, tri_bounds
    from ray_tpu_torch.utils.test_scenes import instanced_scene

    n = 14
    tris = grid_cloud(n, 0.35, 5)
    v = tris.reshape(-1, 3)
    idx = np.arange(v.shape[0], dtype=np.int32).reshape(-1, 3)
    bvh = build_bvh2(*tri_bounds(v, idx), max_leaf=4)
    tab = pack_binned_scene(bvh, pack_tri_soa(v, idx[bvh.prim_indices]))
    binned = {k: torch.from_numpy(a).to(device) for k, a in tab.items()}
    rays = stress_rays(n_rays, 0.0, float(n), 11, device)
    shallow = dict(binned, stack_arr=binned["stack_arr"][:3])
    cases = edge_cases(n_rays, device)
    cases[f"grid cloud {tris.shape[0]} tris"] = ("trace_binned",
                                                 (binned, *rays, 4))
    cases["grid cloud, stack 3"] = ("trace_binned", (shallow, *rays, 4))
    tl = instanced_scene(n_inst=64).finalize(device=device)
    fl = instanced_scene(n_inst=6).finalize(device=device,
                                            instancing="flatten")
    rays = stress_rays(n_rays, -4.0, 4.0, 12, device)
    R = n_rays
    mask = torch.where(torch.arange(R, device=device) % 3 == 0, 1 << 5,
                       0x7fffffff).to(torch.int32)
    soa = tl.bvh_soa
    cases["tlas width 56, ray mask"] = ("trace_tlas", (
        soa["wrows_tlas"], int(soa["winst_base"]), *rays, mask, tl.max_leaf,
        tl.stack_size))
    cases["tlas width 56, stack 4"] = ("trace_tlas", (
        soa["wrows_tlas"], int(soa["winst_base"]), *rays, None, tl.max_leaf,
        4))
    cases[f"wide width {fl.bvh_soa['wrows'].shape[1]}"] = ("trace_tlas", (
        fl.bvh_soa["wrows"], 0, *rays, None, fl.max_leaf, fl.stack_size))
    return cases


def kernel_call(kernel, args, any_hit, plain=False, work=None):
    """Run kernel family ``kernel`` (its wrapper, or with ``plain`` its
    plain version, ``work`` counting) on captured ``args``: a masked
    family's args end with its masks (``trace_bvh_vis``: tri_vis and
    ray_mask after the ints; ``trace_tlas_vis``: ``trace_tlas``'s own,
    the leaf visibility test switched on)."""
    from ray_tpu_torch.ops import traverse

    name = WRAPPER.get(kernel, kernel) + ("_plain" if plain else "")
    fn = getattr(traverse, name)
    kw = {} if work is None else {"work": work}
    if kernel == "trace_bvh_vis":
        return fn(*args[:9], any_hit=any_hit, tri_vis=args[9],
                  ray_mask=args[10], **kw)
    if kernel == "trace_tlas_vis":
        return fn(*args, any_hit=any_hit, has_vis=True, **kw)
    return fn(*args, any_hit=any_hit, **kw)


def check_parity(kernel, args, modes, label, errs):
    """Kernel vs plain on one input set, in the given modes."""
    for any_hit in modes:
        k = kernel_call(kernel, args, any_hit)
        p = kernel_call(kernel, args, any_hit, plain=True)
        name = f"{kernel}_{'anyhit' if any_hit else 'closest'}"
        for f in k._fields:
            a, b = getattr(k, f), getattr(p, f)
            errs[name] = max(errs.get(name, 0.0), max_abs_err(a, b))
            if not same_bits(a, b):
                fail(f"{name} {f} differs from the plain version on {label}: "
                     f"max |diff| {max_abs_err(a, b)}")
        hits = int((k.prim >= 0).sum())
        print(f"  parity {label} {name}: bit-exact ({hits} hits of "
              f"{k.prim.shape[0]} rays)")


def render(scene, cam, settings, iteration, x0=0, y0=0, tw=None, th=None):
    """One sample of a (th, tw) tile of the frame (default: the whole frame)."""
    from ray_tpu_torch.render.integrator import render_tile

    return render_tile(scene, cam, None, x0, y0, iteration, 0, width=WIDTH,
                       height=HEIGHT, tile_w=tw or WIDTH, tile_h=th or HEIGHT,
                       settings=settings, use_filter_table=False)


def grid_tiles(grid):
    """The (x0, y0, tw, th) tiles of a (nx, ny) grid over the frame."""
    nx, ny = grid
    tw, th = WIDTH // nx, HEIGHT // ny
    return [(tx * tw, ty * th, tw, th) for ty in range(ny) for tx in range(nx)]


def render_frame(scene, cam, settings, iteration, grid):
    """One sample of the whole frame as a (nx, ny) grid of tiles, as
    bench.py renders it.  Returns (rays traced, mean radiance); fails on a
    tile of the wrong shape, with non-finite pixels, or a black frame."""
    import torch

    rays, total = 0, 0.0
    for x0, y0, tw, th in grid_tiles(grid):
        out = render(scene, cam, settings, iteration, x0, y0, tw, th)
        color = out["color"]
        if tuple(color.shape) != (tw * th, 3):
            fail(f"a tile's color has shape {tuple(color.shape)}")
        if not bool(torch.isfinite(color).all()):
            fail("non-finite pixels in a frame")
        rays += int(out["rays_traced"])  # synchronises
        total += float(color.sum())
    mean = total / (WIDTH * HEIGHT * 3)
    if not mean > 0.0:
        fail("the frame is black")
    return rays, mean


def capture_frame(scene, cam, settings, iteration, x0=0, y0=0, tw=None,
                  th=None):
    """Render one frame (or one tile of it), keeping a copy of every trace
    kernel's inputs as (kernel, args, any_hit)."""
    return capture(lambda: render(scene, cam, settings, iteration, x0, y0,
                                  tw, th))


def capture(run):
    """``run()``'s result and a copy of every trace kernel's inputs it
    launched, as (kernel, args, any_hit)."""
    from ray_tpu_torch.ops import traverse

    calls = []
    wrappers = [k for k in KERNELS if k not in WRAPPER]
    real = {k: getattr(traverse, k) for k in wrappers}

    def recorder(kernel):
        def recording(*args, any_hit=False, **kw):
            first_ray = RAY_ARG.get(kernel, 2)
            copied = tuple(a.clone() if i >= first_ray and hasattr(a, "clone")
                           else a for i, a in enumerate(args))
            family = kernel
            if kw.get("tri_vis") is not None:
                family = "trace_bvh_vis"
                copied += (kw["tri_vis"], kw["ray_mask"].clone())
            elif kw.get("has_vis"):
                family = "trace_tlas_vis"
            calls.append((family, copied, any_hit))
            return real[kernel](*args, any_hit=any_hit, **kw)
        return recording

    for k in wrappers:
        setattr(traverse, k, recorder(k))
    try:
        out = run()
    finally:
        for k, fn in real.items():
            setattr(traverse, k, fn)
    return out, calls


def time_launches(fn, reps, warmup=True):
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` calls captured in one CUDA
    graph: a kernel of a few microseconds launches faster than the host
    can issue it, so back-to-back calls would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# where a wrapper's rays start among its arguments (the tables before them)
RAY_ARG = {"trace_brute": 1, "trace_binned": 1, "trace_tlas_bin": 3}


def split_args(kernel, args):
    """(tables, (ro, rd, t_min, t_max, active), extra) of a captured
    launch: the extra arguments after the rays (for trace_tlas and
    trace_tlas_vis the ray mask and the ints, for trace_tlas_bin the same;
    trace_binned's one table is the dict of slabs, trace_tlas_bin's three
    are the node rows, the triangle rows and the dict of instance columns;
    trace_bvh_vis's ints are followed by tri_vis, a table, and the ray
    mask)."""
    n = RAY_ARG.get(kernel, 2)
    if kernel in ("trace_tlas", "trace_tlas_vis"):
        return args[:1], args[2:7], args[7:]
    if kernel == "trace_tlas_bin":
        return args[:3], args[3:8], args[8:]
    if kernel == "trace_bvh_vis":
        return ((*args[:2], args[9]), args[2:7],
                (int(args[7]), int(args[8]), args[10]))
    return args[:n], args[n:n + 5], tuple(int(a) for a in args[n + 5:])


def binned_arrays(binned):
    """The binned tables in the C entry point's order, and S."""
    from ray_tpu_torch.scene.binned import CI

    return ([binned[k] for k in ("slab_f", "slab_i", "sub_lo", "sub_hi")],
            binned["slab_i"].shape[0] // CI)


def sorted_rays(binned, rays):
    """The rays in the order trace_binned launches its kernel on them: by
    the sort key (the key kernel, uncounted here), stable."""
    import torch

    from ray_tpu_torch.ops import traverse

    perm = torch.argsort(traverse.binned_sort_key(binned, *rays), stable=True)
    return tuple(a[perm] for a in rays)


def launch_bound(kernel, args, any_hit):
    """Bytes and operations one launch needs at these inputs: each input
    read once, each output written once; the tests, node steps and instance
    entries the plain version's walk makes."""
    import torch

    from ray_tpu_torch.ops import traverse

    tables, (ro, _, _, _, active), extra = split_args(kernel, args)
    n_active = int(active.sum())
    R = ro.shape[0]
    node_steps = inst_entries = box_tests = 0
    lane_bytes = BYTES_PER_LANE
    if kernel == "trace_binned":
        work = {}
        kernel_call(kernel, args, any_hit, plain=True, work=work)
        tests, node_steps = work["tri_tests"], work["node_steps"]
        # one subtree box a subtree walked (the plain walk's S-box scans
        # are that design's cost, not the work)
        box_tests = work["rounds"]
        ops = (OPS_PER_TEST * tests + OPS_PER_NODE_STEP * node_steps
               + OPS_PER_BOX_TEST * box_tests)
        tables = binned_arrays(tables[0])[0]
    elif kernel == "trace_brute":
        T = tables[0].shape[0]
        if any_hit:
            # tests run until the first hit: prim + 1 for hits, T for misses
            plain = traverse.trace_brute_plain(*args, any_hit=True)
            hit = plain.prim >= 0
            tests = int(torch.where(hit, plain.prim + 1, T)[active].sum())
        else:
            tests = n_active * T
        ops = OPS_PER_TEST * tests
    else:
        work = {}
        kernel_call(kernel, args, any_hit, plain=True, work=work)
        tests, node_steps = work["tri_tests"], work["node_steps"]
        if kernel in ("trace_tlas", "trace_tlas_vis"):
            inst_entries = work["inst_entries"]
            ops = (OPS_PER_TEST * tests + OPS_PER_WIDE_NODE_STEP * node_steps
                   + OPS_PER_INST_ENTRY * inst_entries)
            lane_bytes += TLAS_EXTRA_BYTES_PER_LANE * (
                1 if extra[0] is None else 2)
        elif kernel == "trace_tlas_bin":
            # a BVH2 node step of either level, an instance entry
            inst_entries = work["inst_entries"]
            ops = (OPS_PER_TEST * tests + OPS_PER_NODE_STEP * node_steps
                   + OPS_PER_INST_ENTRY * inst_entries)
            lane_bytes += TLAS_EXTRA_BYTES_PER_LANE * (
                1 if extra[0] is None else 2)
            # the instance columns: 14 words an instance
            tables = (*tables[:2], *tables[2].values())
        else:
            ops = OPS_PER_TEST * tests + OPS_PER_NODE_STEP * node_steps
            if kernel == "trace_bvh_vis":
                lane_bytes += TLAS_EXTRA_BYTES_PER_LANE  # the ray mask
    table_bytes = sum(4 * t.numel() for t in tables)
    nbytes = lane_bytes * R + BYTES_PER_ACTIVE_LANE * n_active + table_bytes
    return {"kernel": kernel, "any_hit": bool(any_hit), "rays": R,
            "active": n_active, "tests": tests, "node_steps": node_steps,
            "inst_entries": inst_entries, "box_tests": box_tests,
            "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": ops / PEAK_F32_FLOPS * 1e3}


def counter_pool(device):
    """A function giving the address of a zeroed int32 ray counter at each
    call: one of ``COUNTER_POOL``, all zeroed again when they run out (a
    timed closure makes at most 51 launches, so never while timing)."""
    import torch

    pool = torch.zeros(COUNTER_POOL, dtype=torch.int32, device=device)
    state = {"next": 0}

    def take(_alive=pool):
        if state["next"] == COUNTER_POOL:
            pool.zero_()
            state["next"] = 0
        state["next"] += 1
        return pool.data_ptr() + 4 * (state["next"] - 1)
    return take


def kernel_arrays(kernel, tables):
    """The tensors a kernel's C entry point reads for its captured tables:
    trace_brute's and trace_bvh's cached rows (``tri_rows``,
    ``node_rows``; with the masks for trace_bvh_vis), trace_tlas_bin's
    (and ``inst_rows``), trace_binned's row-major slabs and subtree tree,
    trace_tlas's rows as ``check_tlas_rows`` hands them over."""
    from ray_tpu_torch.ops import traverse

    if kernel == "trace_brute":
        return traverse._brute_kernel_tables(*tables)
    if kernel == "trace_bvh":
        return traverse._bvh_kernel_tables(*tables)
    if kernel == "trace_bvh_vis":
        return traverse._bvh_vis_kernel_tables(*tables)
    if kernel == "trace_tlas_bin":
        return traverse._tlas_bin_kernel_tables(*tables)
    if kernel == "trace_binned":
        return traverse._binned_kernel_tables(tables[0])
    return (traverse.check_tlas_rows(tables[0]),)


def raw_launch(kernel, args, any_hit, fn=None, arrays=None):
    """(closure, outputs): the closure launches the kernel's C entry point
    on captured inputs into ``outputs``, uncounted (timing only).  ``fn``
    (default: this tree's entry point) takes the arguments this tree's
    does, on ``arrays`` (default: ``kernel_arrays``)."""
    import torch

    from ray_tpu_torch.ops import traverse

    tables, rays, extra = split_args(kernel, args)
    counter = counter_pool(rays[0].device)
    if kernel == "trace_binned":
        rays = sorted_rays(tables[0], rays)
    if arrays is None:
        arrays = kernel_arrays(kernel, tables)
    if fn is None:
        fn = {"trace_brute": traverse._brute_fn, "trace_bvh": traverse._bvh_fn,
              "trace_bvh_vis": traverse._bvh_vis_fn,
              "trace_tlas": traverse._tlas_fn,
              "trace_tlas_vis": lambda: traverse._tlas_fn(True),
              "trace_tlas_bin": traverse._tlas_bin_fn,
              "trace_binned": traverse._binned_fn}[kernel]()
    ro, rd, t_min, t_max, active = rays
    R = ro.shape[0]
    dtypes = [torch.float32, torch.int32, torch.float32, torch.float32,
              torch.bool]
    if kernel in ("trace_tlas", "trace_tlas_vis", "trace_tlas_bin"):
        dtypes.append(torch.int32)
    outs = [torch.empty(R, dtype=d, device=ro.device) for d in dtypes]
    out_ptrs = [o.data_ptr() for o in outs]
    stream = torch.cuda.current_stream().cuda_stream
    ray_ptrs = [ro.data_ptr(), rd.data_ptr(), t_min.data_ptr(),
                t_max.data_ptr(), active.data_ptr()]
    tail = None
    if kernel in ("trace_tlas", "trace_tlas_vis"):
        (rows,), (mask, max_leaf, stack_size) = arrays, extra
        head = (rows.data_ptr(), rows.shape[0], rows.shape[1],
                *ray_ptrs, None if mask is None else mask.data_ptr(),
                R, *out_ptrs, int(max_leaf), int(stack_size), int(any_hit),
                stream)
    elif kernel == "trace_tlas_bin":
        (mask, max_leaf, stack_size) = extra
        head = (*(x for a in arrays for x in (a.data_ptr(), a.shape[0])),
                *ray_ptrs, None if mask is None else mask.data_ptr(), R,
                *out_ptrs, int(max_leaf), int(stack_size), int(any_hit),
                stream)
    elif kernel == "trace_bvh_vis":
        (max_leaf, stack_size, mask) = extra
        head = (*(x for a in arrays for x in (a.data_ptr(), a.shape[0])),
                *ray_ptrs, R, *out_ptrs, max_leaf, stack_size,
                mask.data_ptr(), int(any_hit), stream)
    elif kernel == "trace_binned":
        S = binned_arrays(tables[0])[1]
        head = (*(a.data_ptr() for a in arrays), S, *ray_ptrs, R, *out_ptrs,
                *extra, tables[0]["stack_arr"].shape[0])
        tail = (int(any_hit), stream)
    else:
        ptrs = []
        for tab in arrays:
            ptrs += [tab.data_ptr(), tab.shape[0]]
        head = (*ptrs, *ray_ptrs, R, *out_ptrs, *extra, int(any_hit), stream)

    def launch(_alive=(tables, arrays, rays, outs)):
        # the default argument keeps the tensors behind the pointers alive
        launch_args = head if tail is None else (*head, counter(), *tail)
        if fn(*launch_args) != 0:
            fail(f"{kernel} launch failed while timing")
    return launch, outs


def raw_sortkey_launch(binned, rays):
    """A closure that launches the sort-key kernel on captured rays (in the
    order trace_binned gets them) into a fresh key, uncounted."""
    import torch

    from ray_tpu_torch.ops import traverse

    tree = traverse._binned_kernel_tables(binned)[2]
    S = binned_arrays(binned)[1]
    ro, rd, t_min, t_max, active = rays
    key = torch.empty(ro.shape[0], dtype=torch.int32, device=ro.device)
    fn = traverse._binned_key_fn()
    launch_args = (tree.data_ptr(), S, ro.data_ptr(), rd.data_ptr(),
                   t_min.data_ptr(), t_max.data_ptr(), active.data_ptr(),
                   ro.shape[0], key.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)

    def launch(_alive=(tree, rays, key)):
        if fn(*launch_args) != 0:
            fail("the sort-key launch failed while timing")
    return launch


def sortkey_timings(calls):
    """The sort key of each captured trace_binned launch (the rays as the
    wrapper gets them): kernel ms, its bound (bytes: ``SORTKEY_BYTES_*``
    and the boxes once), and the plain version's ms on the first launch of
    each mode."""
    from ray_tpu_torch.ops import traverse

    rows = []
    timed_plain = set()
    for _, args, any_hit in calls:
        binned, rays = args[0], args[1:6]
        n_active = int(rays[4].sum())
        S = binned_arrays(binned)[1]
        nbytes = (SORTKEY_BYTES_PER_LANE * rays[0].shape[0]
                  + SORTKEY_BYTES_PER_ACTIVE_LANE * n_active + S * 6 * 4)
        row = {"any_hit": bool(any_hit), "rays": rays[0].shape[0],
               "active": n_active,
               "ms": time_launches(raw_sortkey_launch(binned, rays), 50),
               "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "plain_ms": None}
        if any_hit not in timed_plain:
            timed_plain.add(any_hit)
            row["plain_ms"] = time_launches(
                lambda: traverse.binned_sort_key_plain(
                    binned["sub_lo"], binned["sub_hi"], *rays), 1)
        rows.append(row)
    return rows


def kernel_timings(calls):
    """Per captured launch: kernel ms (the raw launch, uncounted), plain
    ms and the launch's bound.  trace_binned's plain version takes seconds
    a launch: it is timed once, on the first launch of each mode (the
    primary closest-hit and shadow traces), and its other rows carry
    None; the other walks' plain versions (a third of a second a launch)
    once after a warm-up, trace_brute's three times."""
    from ray_tpu_torch.ops import traverse

    rows = []
    timed_plain = set()
    for kernel, args, any_hit in calls:
        row = launch_bound(kernel, args, any_hit)
        row["ms"] = time_launches(raw_launch(kernel, args, any_hit)[0], 50)
        row["plain_ms"] = None

        def plain(kernel=kernel, args=args, any_hit=any_hit):
            return kernel_call(kernel, args, any_hit, plain=True)
        if kernel != "trace_binned":
            row["plain_ms"] = time_launches(
                plain, 3 if kernel == "trace_brute" else 1)
        elif any_hit not in timed_plain:
            timed_plain.add(any_hit)
            row["plain_ms"] = time_launches(plain, 1, warmup=False)
        rows.append(row)
    return rows


def wide_route_timings(scene, calls):
    """trace_tlas over the binned scene's flatten ``wrows`` on each captured
    trace_binned launch's rays (unsorted, as trace_wide gets them): the
    route the scene takes without ``pallas_binned``.  Returns (ms, lanes
    whose hit differs, lanes whose prim differs) a launch; fails when over
    0.1% of the lanes differ in their hit."""
    import torch

    from ray_tpu_torch.ops import traverse

    rows = scene.bvh_soa["wrows"]
    out = []
    for _, args, any_hit in calls:
        _, rays, _ = split_args("trace_binned", args)
        wide = (rows, 0, *rays, None, scene.max_leaf, scene.stack_size)
        w = traverse.trace_tlas(*wide, any_hit=any_hit)
        b = traverse.trace_binned(*args, any_hit=any_hit)
        # the same hits: a closest hit's t (two triangles at one t may
        # differ in prim by visit order), an any-hit verdict
        differ = (((w.prim >= 0) != (b.prim >= 0)) if any_hit
                  else (w.t.view(torch.int32) != b.t.view(torch.int32)))
        n_diff = int(differ.sum())
        if n_diff > 1e-3 * differ.numel():
            fail(f"the wide route and trace_binned disagree on {n_diff} of "
                 f"{differ.numel()} lanes of the binned tile")
        out.append((time_launches(raw_launch("trace_tlas", wide, any_hit)[0],
                                  50),
                    n_diff, int((w.prim != b.prim).sum())))
    return out


def forward_path(label, scene, cam, settings, kernel, grid=(1, 1),
                 frames=FRAMES):
    """``frames`` timed forward frames, each a ``grid`` of tiles; the launch
    counts are set to 0 just before and read just after.  Returns the
    counts and the frame ms."""
    import torch

    from ray_tpu_torch.ops import cuda_build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    rays = 0
    frame_s = []
    t_all = time.perf_counter()
    for f in range(frames):
        t_f = time.perf_counter()
        n, mean = render_frame(scene, cam, settings, 2 + f, grid)
        rays += n
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t_f)
    wall = time.perf_counter() - t_all
    counts = dict(cuda_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    tiles = grid[0] * grid[1]
    check_counts(label, counts, kernel, frames, 6 * tiles)
    frame_ms = wall / frames * 1e3
    print(f"{label} fwd 1920x1080 1spp depth5 (grid {grid[0]}x{grid[1]}): "
          f"{rays / wall / 1e6:.3f} Mray/s over {frames} frames "
          f"({rays / frames:.0f} rays/frame), frame {frame_ms:.1f} ms "
          f"(window / frames); {spread(frame_s)}; peak memory "
          f"{peak / 2**30:.3f} GiB, mean radiance {mean:.6f} [{CARD}]")
    print(f"  frame ms: {', '.join(f'{s * 1e3:.1f}' for s in frame_s)}")
    print(f"  launch counts over {frames} frames: {counts}")
    return counts, frame_ms


def spread(frame_s):
    return (f"frames min {min(frame_s) * 1e3:.1f} max {max(frame_s) * 1e3:.1f} "
            f"ms, spread (max - min) / mean "
            f"{(max(frame_s) - min(frame_s)) / statistics.fmean(frame_s):.3f}")


def check_sort_key(args, label, errs):
    """The binned sort-key kernel against its plain version: equal keys."""
    import torch

    from ray_tpu_torch.ops import traverse

    binned, rays = args[0], args[1:6]
    key = traverse.binned_sort_key(binned, *rays)
    plain = traverse.binned_sort_key_plain(binned["sub_lo"], binned["sub_hi"],
                                           *rays)
    errs["trace_binned_sortkey"] = max(errs.get("trace_binned_sortkey", 0.0),
                                       max_abs_err(key, plain))
    if not torch.equal(key, plain):
        fail(f"the binned sort key differs from its plain version on {label} "
             f"on {int((key != plain).sum())} rays")
    S = binned["slab_i"].shape[0] // 16
    print(f"  parity {label} binned sort key: equal ({int((key < S).sum())} "
          f"of {key.shape[0]} rays enter a subtree)")


def without_rng(counts):
    """Launch counts of every kernel but the RNG's ``rng_draw`` (a remat
    backward replays its forward's draws)."""
    return {k: v for k, v in counts.items() if not k.startswith("rng_")}


def check_counts(label, counts, kernel, frames, per_frame=6):
    """``per_frame`` closest-hit + ``per_frame`` any-hit launches a frame of
    ``kernel`` (6 a tile: one of each a bounce), none of the others."""
    for name in KERNELS:
        for mode in ("closest", "anyhit"):
            want = per_frame * frames if name == kernel else 0
            got = counts.get(f"{name}_{mode}", 0)
            if got != want:
                fail(f"{label}: {name}_{mode} launched {got} times in "
                     f"{frames} frames, expected {want}")


def fwd_bwd(scene, cam, settings, iteration, tiles=None):
    """The bench loss (bench.py: sum(color^2) / (H W 3)) and its gradients
    w.r.t. every float material column and env_col, set as leaf tensors.
    Like bench.py's ``fwd_bwd``, each tile of ``tiles`` ((x0, y0, tw, th);
    default the whole frame) runs its own forward and ``backward()``, and
    the gradients sum into the same leaves.  Returns (loss, rays, grads,
    forward s, backward s)."""
    import torch

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    env = scene.env_col.detach().clone().requires_grad_(True)
    merged = dict(scene.materials)
    merged.update(params)
    sc = dataclasses.replace(scene, materials=merged, env_col=env)
    cuda = scene.device.type == "cuda"
    total, rays, fwd_s, bwd_s = 0.0, 0, 0.0, 0.0
    for x0, y0, tw, th in tiles or [(0, 0, WIDTH, HEIGHT)]:
        t0 = time.perf_counter()
        out = render(sc, cam, settings, iteration, x0, y0, tw, th)
        loss = (out["color"] ** 2).sum() / (HEIGHT * WIDTH * 3)
        rays += int(out["rays_traced"])
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        if cuda:
            torch.cuda.synchronize()
        fwd_s += t1 - t0
        bwd_s += time.perf_counter() - t1
        total += float(loss.detach())
    grads = {k: p.grad for k, p in params.items()}
    grads["env_col"] = env.grad
    return total, rays, grads, fwd_s, bwd_s


def fwd_bwd_path(label, scene, cam, settings, kernel, grid=(1, 1),
                 frames=BWD_FRAMES):
    """``frames`` timed fwd+bwd frames (each a ``grid`` of tiles) after a
    warm-up frame; 6 + 6 trace launches a tile, none in backward (remat
    with ``remat_save_trace`` or stored residuals)."""
    import torch

    from ray_tpu_torch.ops import cuda_build

    tiles = grid_tiles(grid)
    fwd_bwd(scene, cam, settings, 1, tiles)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    rays = 0
    frame_s, fwd_s, bwd_s = [], [], []
    t_all = time.perf_counter()
    for f in range(frames):
        loss, n, grads, tf, tb = fwd_bwd(scene, cam, settings, 2 + f, tiles)
        rays += n
        fwd_s.append(tf)
        bwd_s.append(tb)
        frame_s.append(tf + tb)
        check_grads(f"{label} fwd+bwd", grads)
    wall = time.perf_counter() - t_all
    counts = dict(cuda_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check_counts(f"{label} fwd+bwd", counts, kernel, frames, 6 * len(tiles))
    frame_ms = wall / frames * 1e3
    print(f"{label} fwd+bwd 1920x1080 1spp depth5 (grid {grid[0]}x{grid[1]}"
          f"{', remat' if settings.remat else ''}): "
          f"{rays / wall / 1e6:.3f} Mray/s over {frames} frames, frame "
          f"{frame_ms:.1f} ms (forward {statistics.fmean(fwd_s) * 1e3:.1f} + "
          f"backward {statistics.fmean(bwd_s) * 1e3:.1f}); {spread(frame_s)}; "
          f"peak memory {peak / 2**30:.3f} GiB; loss {loss:.6e}; "
          f"|grad base_color| max {float(grads['base_color'].abs().max()):.3e}, "
          f"|grad env_col| max {float(grads['env_col'].abs().max()):.3e} "
          f"[{CARD}]")
    print(f"  launch counts over {frames} frames: {counts}")
    return frame_ms


def check_grads(label, grads):
    """Every gradient finite; base_color's and env_col's non-zero."""
    import torch

    for k in ("base_color", "env_col"):
        g = grads[k]
        if g is None or not float(g.abs().max()) > 0.0:
            fail(f"{label}: gradient of {k} missing or zero")
    for k, g in grads.items():
        if g is not None and not bool(torch.isfinite(g).all()):
            fail(f"{label}: gradient of {k} not finite")


def remat_trace_counts(scene, cam, settings, kernel):
    """One fwd+bwd 2x2 frame with ``remat_save_trace=False``: the backward
    replays launch every trace again, so 12 + 12 launches a tile."""
    from ray_tpu_torch.ops import cuda_build

    st = dataclasses.replace(settings, remat_save_trace=False)
    cuda_build.reset_launch_counts()
    _, _, grads, tf, tb = fwd_bwd(scene, cam, st, 9, grid_tiles(GRID))
    counts = dict(cuda_build.launch_counts)
    check_grads("colonnade fwd+bwd, remat_save_trace=False", grads)
    check_counts("colonnade fwd+bwd, remat_save_trace=False", counts, kernel,
                 1, 2 * 6 * len(grid_tiles(GRID)))
    print(f"colonnade fwd+bwd 2x2 with remat_save_trace=False: forward "
          f"{tf * 1e3:.1f} + backward {tb * 1e3:.1f} ms; launch counts "
          f"{counts} (the backward replays every trace) [{CARD}]")


def check_remat_against_stored(scene, cam, settings):
    """The flagship fwd+bwd frame with remat and with stored residuals on
    the card: the loss bit-identical, each gradient column within 1e-4 of
    its largest entry (the backward's index_add_ atomics sum in another
    order)."""
    loss_r, _, g_r, _, _ = fwd_bwd(scene, cam, dataclasses.replace(
        settings, remat=True), 77)
    loss_s, _, g_s, _, _ = fwd_bwd(scene, cam, settings, 77)
    if loss_r != loss_s:
        fail(f"flagship remat loss {loss_r!r} differs from the stored-"
             f"residual loss {loss_s!r}")
    worst = 0.0
    for k, g in g_s.items():
        if g is None or g_r[k] is None:
            if (g is None) != (g_r[k] is None):
                fail(f"flagship remat: {k} has a gradient with one policy")
            continue
        scale = float(g.abs().max())
        rel = float((g_r[k] - g).abs().max()) / scale if scale > 0 else 0.0
        worst = max(worst, rel)
        if rel > 1e-4:
            fail(f"flagship remat: {k} differs from stored residuals by "
                 f"{rel:.3e} of its largest entry")
    print(f"flagship fwd+bwd remat vs stored residuals on the card: loss "
          f"bit-identical ({loss_r:.9e}), worst column max |diff| / max |g| "
          f"{worst:.2e} (limit 1e-4)")


# the AUX normal's bound on the flattened colonnades (atol; rtol 1e-5 and
# atol 1e-6 elsewhere).  The card's camera rays differ from the CPU's by
# up to 1.2e-7 (an ulp of the camera math, as on every scene), and a
# column triangle seen from ~10 units away conditions the hit's
# barycentric u ~1e4: the interpolated normal of the same triangle moves
# by up to 1.9e-5.  Measured on the card (PR 4) at this tile: 4 of 3,072
# pixels past the 1e-6 bound on the flattened colonnade, 2 on the binned
# one, 1 on the instanced one; depth and base color all within 1e-5.
# tex_features bends its ball's normals by a BC5 normal map fetched at the
# hit's uv and mip (the ray cone's log2), in the frame of the same ill-
# conditioned barycentrics: measured on an H100 4 of 3,072 pixels past
# 1e-6, the largest 2.5e-6.
WORLD_NORMAL_ATOL = {"colonnade flatten": 1e-4, "colonnade binned": 1e-4,
                     "colonnade sbvh": 1e-4, "tex_features": 1e-5}


def check_tile_against_cpu(make_scene, label, x0, y0, settings):
    """A 64x48 tile on the card against the same tile on the port's plain
    CPU path (the scene built by ``make_scene`` and finalized on each)."""
    scenes = []
    for dev in ("cuda", "cpu"):
        sc, cam = make_scene()
        scenes.append(sc.finalize(device=dev, **FINALIZE.get(label, {})))
    compare_tiles(label, *scenes, cam, x0, y0, settings)


def compare_tiles(label, scene, cpu_scene, cam, x0, y0, settings):
    """A 64x48 tile of ``scene`` (on the card) against the same tile of
    ``cpu_scene`` (the port's plain CPU path).  The card's transcendentals
    differ from the CPU's by ulps, which rarely flips a Russian-roulette
    decision — hence the per-pixel fraction bounds (and
    ``WORLD_NORMAL_ATOL``)."""
    import numpy as np

    outs = []
    for s in (scene, cpu_scene):
        o = render(s, cam, settings, 1, x0, y0, 64, 48)
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
    g, c = outs
    close = np.isclose(g["color"], c["color"], rtol=1e-3, atol=1e-4).all(-1)
    n_atol = WORLD_NORMAL_ATOL.get(label, 1e-6)
    aux = (np.isclose(g["base_color"], c["base_color"], rtol=1e-5, atol=1e-6)
           .all(-1)
           & np.isclose(g["depth_normal"][:, :3], c["depth_normal"][:, :3],
                        rtol=1e-5, atol=n_atol).all(-1)
           & np.isclose(g["depth_normal"][:, 3], c["depth_normal"][:, 3],
                        rtol=1e-5, atol=1e-6))
    mean_rel = abs(g["color"].mean() - c["color"].mean()) / c["color"].mean()
    rays_rel = abs(int(g["rays_traced"]) - int(c["rays_traced"])) / int(
        c["rays_traced"])
    dn = np.abs(g["depth_normal"][:, :3] - c["depth_normal"][:, :3])
    strict = ~np.isclose(g["depth_normal"][:, :3], c["depth_normal"][:, :3],
                         rtol=1e-5, atol=1e-6).all(-1)
    print(f"tile 64x48 {label} card vs cpu: color close {close.mean():.4f}, "
          f"aux close {aux.mean():.4f} (normal atol {n_atol:g}; normal max "
          f"|diff| {dn.max():.3e}, {int(strict.sum())} pixels past atol "
          f"1e-6), mean rel diff {mean_rel:.2e}, rays "
          f"{int(g['rays_traced'])} vs {int(c['rays_traced'])}")
    if not (close.mean() >= 0.99 and aux.mean() >= 0.999
            and mean_rel < 1e-3
            and rays_rel < 5e-3 and np.isfinite(g["color"]).all()):
        fail(f"the card's 64x48 {label} tile disagrees with the CPU path")


def check_grad_tile_against_cpu(make_scene, label, x0, y0, settings):
    """Gradients of the bench loss over a 64x48 tile on the card against
    the port's CPU path: each float material column and env_col within
    1e-2 of the column's largest CPU entry (a flipped Russian-roulette
    decision, as in the image tile, moves one pixel's share)."""
    grads = []
    for dev in ("cuda", "cpu"):
        sc, cam = make_scene()
        _, _, g, _, _ = fwd_bwd(
            sc.finalize(device=dev, **FINALIZE.get(label, {})), cam,
            settings, 1, [(x0, y0, 64, 48)])
        grads.append(g)
    worst = 0.0
    for k, gc in grads[1].items():
        gg = grads[0][k]
        if gc is None or gg is None:
            if (gc is None) != (gg is None):
                fail(f"{label} gradient tile: {k} has a gradient on one "
                     f"device only")
            continue
        scale = float(gc.abs().max())
        err = float((gg.cpu() - gc).abs().max())
        rel = err / scale if scale > 0 else err
        worst = max(worst, rel)
        if rel > 1e-2:
            fail(f"{label} gradient tile: {k} card vs cpu max |diff| {err:.3e} "
                 f"against max |g| {scale:.3e}")
    print(f"grad tile 64x48 {label} card vs cpu: worst column max |diff| / "
          f"max |g| {worst:.2e} (limit 1e-2); base_color grad "
          f"{grads[0]['base_color'][-1].tolist()}")


def colonnade_coverage(scene, cam, x0, y0, tw, th):
    """Primary hits of a tile of the colonnade by instance kind: (columns,
    terrain, floor)."""
    import torch

    from ray_tpu_torch.ops.traverse import trace_closest_tlas
    from ray_tpu_torch.render.raygen import generate_primary_rays

    rays = generate_primary_rays(cam, None, x0, y0, 1, 0, width=WIDTH,
                                 height=HEIGHT, tile_w=tw, tile_h=th,
                                 use_filter_table=False, device=scene.device)
    R = tw * th
    hit = trace_closest_tlas(
        scene.bvh_soa, scene.tri_soa, scene.inst, rays.ro, rays.rd,
        torch.zeros(R, device=scene.device), rays.t_max,
        torch.ones(R, dtype=torch.bool, device=scene.device),
        max_leaf=scene.max_leaf, stack_size=scene.stack_size)
    inst = hit.inst[hit.prim >= 0]
    terrain_end = COLONNADE_COLUMNS + COLONNADE_TERRAIN
    return (int((inst < COLONNADE_COLUMNS).sum()),
            int(((inst >= COLONNADE_COLUMNS) & (inst < terrain_end)).sum()),
            int((inst >= terrain_end).sum()))


# ---- the shading slice: the four CPU goldens' scenes and the alpha box ---
# the kernel each scene's traces take (dir_env's 2,210 triangles: the wide
# route over its 8-wide rows; the others are brute-force sized)
SHADING = {
    "rect_disk": "trace_brute",
    "sphere_spot_line": "trace_brute",
    "dir_env": "trace_tlas",
    "tri_glass": "trace_brute",
    "alpha_box": "trace_brute",
}
SHADING_FRAMES = 2
# the fwd+bwd frames and their grids: the alpha box's principled lobes
# store more than the card holds for one 1080p tile (stored residuals ran
# out of its 80 GB), so it is 2x2 tiles, each its own backward, as
# bench.py renders the colonnade
SHADING_BWD = {"tri_glass": (1, 1), "alpha_box": GRID}
# the tile on which remat and stored residuals are compared with
# deterministic reductions: (x0, y0, w, h), over the Cornell box's tall box
REMAT_TILE = (960, 540, 480, 270)
# the 1080p remat gradients may differ from the stored ones by this many
# times the largest gap between two of ``REMAT_NOISE_RUNS`` stored-residual
# runs (atomic summation order)
REMAT_NOISE_MULT = 4.0
REMAT_NOISE_RUNS = 3
# the scenes whose every launch of one frame phase 3 holds against the
# plain version (the alpha box's march traces included)
SHADING_PARITY = ("tri_glass", "dir_env", "alpha_box")
# 64x48 card-vs-CPU tiles on each scene's content (the alpha box's wholly
# on the box)
SHADING_TILES = {"rect_disk": (928, 516), "sphere_spot_line": (928, 516),
                 "dir_env": (928, 600), "tri_glass": (1000, 700),
                 "alpha_box": (1040, 760)}
# the alpha box stands on the floor: its bottom face lies in the floor's
# plane, and a ray from inside the transparent box meets both at one t, so
# the last ulp of the ray picks the material (tests/test_torch_transparency.py
# measured 1.6% of a tile's pixels apart between ray_tpu and the port on
# the CPU).  The same box lifted 2 mm (ALPHA_LIFT) is held beside it.
ALPHA_LIFT = 0.002
GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "tests" / "goldens_cpu"
# tests/test_cpu_goldens.py's gate
PSNR_FLOOR = 28.0
FIREFLY_BUDGET = 40  # pixels with a channel off by more than 32/255
GOLDEN_TIMEOUT = 600  # seconds a golden worker may take


def shading_scene(name, lift=0.0):
    from ray_tpu_torch.utils import test_scenes

    if name == "alpha_box":
        return test_scenes.alpha_box(lift)
    return test_scenes.GOLDEN_SCENES[name]()


def psnr_fireflies(a, b):
    """tests/test_cpu_goldens.py's measure of two uint8 images."""
    import numpy as np

    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    mse = float((diff ** 2).mean())
    psnr = -10.0 * np.log10(max(mse, 1e-12) / 255.0 ** 2)
    return psnr, int((diff > 32).any(axis=-1).sum())


def golden_render(name):
    """One golden scene through ``create_renderer`` at the golden's own
    resolution (64x64), pass settings and sample count (400), to uint8
    through ``pixels(cam)``, against the committed ``.npz``.  Returns
    (dB, fireflies, seconds)."""
    import numpy as np

    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.render.integrator import PassSettings
    from ray_tpu_torch.utils.test_scenes import (
        GOLDEN_DEPTH, GOLDEN_RES, GOLDEN_SCENES, GOLDEN_SPP)

    golden = np.load(GOLDEN_DIR / f"{name}.npz")["image_u8"]
    sc, cam = GOLDEN_SCENES[name]()
    t0 = time.perf_counter()
    scene = sc.finalize()
    r = ray_tpu.create_renderer(
        ray_tpu.RenderSettings(width=GOLDEN_RES, height=GOLDEN_RES),
        PassSettings(**GOLDEN_DEPTH))
    r.render(scene, cam, GOLDEN_SPP)
    px = r.pixels(cam).cpu().numpy()
    secs = time.perf_counter() - t0
    out = np.clip(px * 255.0, 0, 255).astype(np.uint8)
    return (*psnr_fireflies(out, golden), secs)


def golden_gate():
    """The four goldens at once, one worker process each (``chip_smoke.py
    --golden NAME``) on the same card: a golden's 400 samples of 4,096
    lanes are host dispatch, ~260-340 ms a sample on one core, so the four
    share the card's host cores instead of queueing.  Each is gated at >=
    28 dB PSNR and <= 40 fireflies; returns {scene: (dB, fireflies,
    seconds)}."""
    from ray_tpu_torch.utils.test_scenes import GOLDEN_SCENES, GOLDEN_SPP

    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--golden",
         name], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in GOLDEN_SCENES}
    outs = {}
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=GOLDEN_TIMEOUT)
            if p.returncode != 0:
                fail(f"golden {name}: the worker exited {p.returncode}: "
                     f"{err.strip()[-2000:]}")
            outs[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = {}
    for name, o in outs.items():
        psnr, ff, secs = o["psnr"], o["fireflies"], o["seconds"]
        rows[name] = (psnr, ff, secs)
        print(f"golden {name} 64x64, {GOLDEN_SPP} samples on the card: "
              f"{psnr:.2f} dB, {ff} fireflies (gate >= {PSNR_FLOOR} dB, <= "
              f"{FIREFLY_BUDGET}); {secs:.3f} s ({secs / GOLDEN_SPP * 1e3:.2f}"
              f" ms a sample; four workers at once) [{CARD}]")
        if not (psnr >= PSNR_FLOOR and ff <= FIREFLY_BUDGET):
            fail(f"golden {name}: {psnr:.2f} dB, {ff} fireflies")
    print(f"goldens: {time.perf_counter() - t0:.1f} s for the four")
    return rows


def golden_worker(name) -> int:
    """``chip_smoke.py --golden NAME``: one golden's render, its numbers as
    the last line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    psnr, ff, secs = golden_render(name)
    print(json.dumps({"psnr": psnr, "fireflies": ff, "seconds": secs}))
    return 0


def shading_counts_ok(label, counts, marches, kernel, frames, transparent):
    """A frame of a shading scene: 6 closest-hit launches of ``kernel``
    (one a bounce) plus one a march trace, and 6 any-hit ones — none where
    the scene has transparency (its shadow rays march closest hits); none
    of the other kernels."""
    n_march = marches.get("through", 0) + marches.get("transmittance", 0)
    want = {f"{kernel}_closest": 6 * frames + n_march,
            f"{kernel}_anyhit": 0 if transparent else 6 * frames}
    for name in KERNELS:
        for mode in ("closest", "anyhit"):
            key = f"{name}_{mode}"
            if counts.get(key, 0) != want.get(key, 0):
                fail(f"{label}: {key} launched {counts.get(key, 0)} times, "
                     f"expected {want.get(key, 0)} ({marches})")


def shading_forward(label, scene, cam, settings, kernel,
                    frames=SHADING_FRAMES):
    """``frames`` timed 1080p forward frames after a warm-up frame, the
    launch and march counts set to 0 just before and read just after."""
    import torch

    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render import integrator
    from ray_tpu_torch.utils import trace

    render_frame(scene, cam, settings, 1, (1, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    integrator.march_counts.clear()
    trace.host_syncs.clear()
    rays, frame_s = 0, []
    t_all = time.perf_counter()
    for f in range(frames):
        t_f = time.perf_counter()
        n, mean = render_frame(scene, cam, settings, 2 + f, (1, 1))
        rays += n
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t_f)
    wall = time.perf_counter() - t_all
    counts = dict(cuda_build.launch_counts)
    marches = dict(integrator.march_counts)
    syncs = trace.host_syncs["march_closest"] + trace.host_syncs["march_shadow"]
    peak = torch.cuda.max_memory_allocated()
    shading_counts_ok(label, counts, marches, kernel, frames,
                      scene.has_transparency)
    frame_ms = wall / frames * 1e3
    n_march = marches.get("through", 0) + marches.get("transmittance", 0)
    print(f"{label} fwd 1920x1080 1spp depth5: {rays / wall / 1e6:.3f} Mray/s"
          f" over {frames} frames ({rays / frames:.0f} rays/frame), frame "
          f"{frame_ms:.1f} ms (window / frames); {spread(frame_s)}; peak "
          f"memory {peak / 2**30:.3f} GiB, mean radiance {mean:.6f} [{CARD}]")
    print(f"  trace launches a frame: closest-hit "
          f"{(counts.get(f'{kernel}_closest', 0) - n_march) / frames:.1f}, "
          f"any-hit {counts.get(f'{kernel}_anyhit', 0) / frames:.1f}, march "
          f"{n_march / frames:.1f} (closest-hit march "
          f"{marches.get('through', 0) / frames:.1f}, shadow march "
          f"{marches.get('transmittance', 0) / frames:.1f}); march host syncs"
          f" a frame {syncs / frames:.1f}")
    print(f"  frame ms: {', '.join(f'{s * 1e3:.1f}' for s in frame_s)}")
    return counts, frame_ms, marches


def grad_diff(g_a, g_b, label):
    """The worst column's max |diff| / max |g| between two gradient sets;
    fails where one set has a gradient the other lacks."""
    worst = 0.0
    for k, g in g_b.items():
        if g is None or g_a[k] is None:
            if (g is None) != (g_a[k] is None):
                fail(f"{label}: {k} has a gradient with one policy")
            continue
        scale = float(g.abs().max())
        rel = float((g_a[k] - g).abs().max()) / scale if scale > 0 else 0.0
        worst = max(worst, rel)
    return worst


def shading_fwd_bwd(label, scene, cam, settings, kernel, grid=(1, 1)):
    """The 1080p fwd+bwd frame (a ``grid`` of tiles, each its own
    backward, as bench.py renders the colonnade) with stored residuals and
    with remat, each timed after a warm-up: gradients finite
    (base_color's and env_col's non-zero), each policy launching the
    forward's traces (the same number, marches included) and none in
    backward, the loss bit-identical.  The material gradients' index_add_
    sums millions of terms a row with atomics, in any order, which alone
    moves a 1080p tri_glass column by ~1e-4 of its scale, so at 1080p the
    remat gradients are held against the stored ones within
    ``REMAT_NOISE_MULT`` times the noise floor measured here from the
    reference policy alone — the largest gap between any two of
    ``REMAT_NOISE_RUNS`` stored-residual runs of the same frame — or 1e-4
    where that is larger.  On ``REMAT_TILE`` with deterministic reductions
    they are held
    within 1e-4 (the deterministic kernels are ~20x slower: ~9 minutes for
    the alpha box's two 2x2 frames on a card run, too slow for whole
    frames)."""
    import torch

    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render import integrator

    tiles = grid_tiles(grid)
    cuda_build.reset_launch_counts()
    integrator.march_counts.clear()
    with torch.no_grad():
        for tile in tiles:
            render(scene, cam, settings, 2, *tile)
    fwd_counts = dict(cuda_build.launch_counts)
    marches = dict(integrator.march_counts)
    shading_counts_ok(f"{label} forward", fwd_counts, marches, kernel,
                      len(tiles), scene.has_transparency)
    policies = (("stored residuals", settings),
                ("remat", dataclasses.replace(settings, remat=True)))
    res = {}
    for policy, st in policies:
        fwd_bwd(scene, cam, st, 1, tiles)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        loss, rays, grads, tf, tb = fwd_bwd(scene, cam, st, 2, tiles)
        counts = dict(cuda_build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        check_grads(f"{label} fwd+bwd ({policy})", grads)
        if without_rng(counts) != without_rng(fwd_counts):
            fail(f"{label} fwd+bwd ({policy}) launched {counts}, the forward "
                 f"{fwd_counts}")
        res[policy] = (loss, grads)
        print(f"{label} fwd+bwd 1920x1080 1spp depth5 (grid {grid[0]}x"
              f"{grid[1]}, {policy}): frame "
              f"{(tf + tb) * 1e3:.1f} ms (forward {tf * 1e3:.1f} + backward "
              f"{tb * 1e3:.1f}), {rays / (tf + tb) / 1e6:.3f} Mray/s; peak "
              f"memory {peak / 2**30:.3f} GiB; loss {loss:.9e}; |grad "
              f"base_color| max {float(grads['base_color'].abs().max()):.3e},"
              f" |grad env_col| max {float(grads['env_col'].abs().max()):.3e};"
              f" launches {counts} (the forward's) [{CARD}]")
    (loss_s, g_s), (loss_r, g_r) = res["stored residuals"], res["remat"]
    if loss_r != loss_s:
        fail(f"{label} remat loss {loss_r!r} differs from the stored-residual"
             f" loss {loss_s!r}")
    # the noise floor, from the reference policy alone: the largest gap
    # between any two of ``REMAT_NOISE_RUNS`` stored-residual runs
    stored = [g_s]
    for _ in range(REMAT_NOISE_RUNS - 1):
        loss_2, _, g_2, _, _ = fwd_bwd(scene, cam, settings, 2, tiles)
        if loss_2 != loss_s:
            fail(f"{label} another stored-residual loss {loss_2!r} differs "
                 f"from the first {loss_s!r}")
        stored.append(g_2)
    gaps = [grad_diff(stored[j], stored[i], f"{label} stored again")
            for i in range(len(stored)) for j in range(i + 1, len(stored))]
    noise = max(gaps)
    spread = grad_diff(g_r, g_s, f"{label} remat")
    limit = max(REMAT_NOISE_MULT * noise, 1e-4)
    det = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for policy, st in policies:
                det[policy] = fwd_bwd(scene, cam, st, 2, [REMAT_TILE])
        finally:
            torch.use_deterministic_algorithms(False)
    if det["remat"][0] != det["stored residuals"][0]:
        fail(f"{label} remat tile loss differs from the stored-residual one")
    worst = grad_diff(det["remat"][2], det["stored residuals"][2],
                      f"{label} remat tile")
    print(f"{label} fwd+bwd remat vs stored residuals: loss bit-identical at "
          f"1080p ({loss_r:.9e}); worst column max |diff| / max |g| "
          f"{spread:.2e} at 1080p with atomic reductions (stored vs stored "
          f"again, {len(stored)} runs: "
          f"{', '.join(f'{g:.2e}' for g in gaps)}; limit {limit:.2e}), "
          f"{worst:.2e} on the "
          f"{REMAT_TILE[2]}x{REMAT_TILE[3]} tile at {REMAT_TILE[:2]} with "
          f"deterministic ones (limit 1e-4)")
    if spread > limit:
        fail(f"{label} remat: a 1080p gradient column differs from stored "
             f"residuals by {spread:.3e} of its largest entry, past "
             f"{REMAT_NOISE_MULT} times the atomic noise floor {noise:.3e}")
    if worst > 1e-4:
        fail(f"{label} remat: a gradient column differs from stored residuals "
             f"by {worst:.3e} of its largest entry")


# ---- the traversal slice: the binary two-level walk, visibility masks,
# environment maps ----------------------------------------------------------
# label -> (builder in ray_tpu_torch.utils.test_scenes, finalize keywords,
# the kernel family every trace takes, forward frames)
SLICE = {
    "cornell_tlas": ("cornell_tlas", dict(instancing="tlas"),
                     "trace_tlas_bin", FRAMES),
    "cornell_vis flatten": ("cornell_vis", dict(instancing="flatten"),
                            "trace_bvh_vis", SHADING_FRAMES),
    "cornell_vis tlas": ("cornell_vis", dict(instancing="tlas"),
                         "trace_tlas_bin", SHADING_FRAMES),
    "sphere_vis flatten": ("sphere_vis", dict(instancing="flatten"),
                           "trace_tlas_vis", SHADING_FRAMES),
    "sphere_vis tlas": ("sphere_vis", dict(instancing="tlas"),
                        "trace_tlas", SHADING_FRAMES),
    "env_map": ("env_map", {}, "trace_tlas", SHADING_FRAMES),
}
FINALIZE.update({label: kw for label, (_, kw, _, _) in SLICE.items()})
# the slice scenes whose launches give the new families' line in the
# kernels JSON (and the masked-vs-unmasked timings)
SLICE_TIMED = ("cornell_tlas", "cornell_vis flatten", "sphere_vis flatten")
# 64x48 card-vs-CPU tiles: on the boxes and their shadows, the hidden
# sphere's shadow, the ball under the map
SLICE_TILES = {"cornell_tlas": (928, 516), "cornell_vis flatten": (1020, 540),
               "cornell_vis tlas": (1020, 540),
               "sphere_vis flatten": (1060, 860),
               "sphere_vis tlas": (1060, 860), "env_map": (928, 600)}
# the fwd+bwd paths of the slice (stored residuals) and their grids: a 1x1
# env_map frame peaked at 71.2 GiB of the card's 80 GB (its PRINCIPLED
# ball's residuals, as the alpha box's), so it runs as 2x2 tiles, each its
# own backward
SLICE_BWD = {"cornell_tlas": (1, 1), "env_map": GRID}
SLICE_BWD_FRAMES = 2
# the tlas frame against the flatten flagship frame: means within this
# relative gap (tests/test_instancing.py holds ray_tpu's within 2e-3 of
# each pixel at 8 spp)
TLAS_VS_FLATTEN_REL = 1e-3


def slice_scene(label):
    """(Scene, Camera) of a ``SLICE`` scene, from the public API."""
    from ray_tpu_torch.utils import test_scenes

    return getattr(test_scenes, SLICE[label][0])()


def shapes_scene(n_inst, seed):
    """Generator two-level scene of 172 unique triangles (a 160-triangle UV
    sphere and a box), ``n_inst`` instances each under a random
    translation in [-2, 2]^3 and non-uniform scale in [0.4, 1.6]^3; every
    third instance hidden from camera rays, every fourth from shadow
    rays.  Returns the Scene (tlas: no wrows_tlas; flatten: wrows with
    the visibility column)."""
    import numpy as np

    from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
    from ray_tpu_torch.scene.scene import Scene
    from ray_tpu_torch.scene.visibility import visibility_mask
    from ray_tpu_torch.utils.geometry import make_box, make_uv_sphere

    r = np.random.RandomState(seed)
    sc = Scene()
    m = sc.add_material(MaterialDesc(type=ShadingNode.DIFFUSE,
                                     base_color=(0.7, 0.7, 0.7)))
    v, idx, n, uv = make_uv_sphere(radius=0.6, rings=8, segments=10)
    meshes = [sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)]
    bv, bidx, bn = make_box(size=(0.8, 0.5, 0.6))
    meshes.append(sc.add_mesh(bv, bidx, normals=bn, material=m))
    for i in range(n_inst):
        x = np.eye(4, dtype=np.float32)
        x[[0, 1, 2], [0, 1, 2]] = r.uniform(0.4, 1.6, 3)
        x[:3, 3] = r.uniform(-2.0, 2.0, 3)
        vis = visibility_mask(camera=i % 3 != 0, shadow=i % 4 != 0)
        sc.add_instance(meshes[i % 2], x, visibility=vis)
    sc.set_environment((0.5, 0.5, 0.5))
    return sc


def slice_generator_cases(n_rays, device):
    """{label: (kernel family, args)} of the slice's generator cases:
    trace_tlas_bin on ``shapes_scene`` (24 instances) with RAY_CAMERA and
    RAY_SHADOW masks and on stress rays; the masked BVH2 walk on a 300-
    triangle generator BVH with random per-triangle masks and random ray
    types; the masked wide route on ``shapes_scene`` flattened; and
    trace_tlas at max_leaf 6 and 7 (rows padded to 68 and 80 floats)."""
    import numpy as np
    import torch

    from ray_tpu_torch.scene.visibility import (
        RAY_CAMERA, RAY_DIFFUSE, RAY_REFR, RAY_SHADOW, RAY_SPECULAR)
    from ray_tpu_torch.utils.test_scenes import instanced_scene

    r = np.random.RandomState(9)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    kinds = np.array([RAY_CAMERA, RAY_DIFFUSE, RAY_SPECULAR, RAY_REFR,
                      RAY_SHADOW], np.int32)
    cases = {}
    tl = shapes_scene(24, 3).finalize(device=device, instancing="tlas")
    ro = r.uniform(-3.0, 3.0, (n_rays, 3)).astype(np.float32)
    rd = r.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    active = np.ones(n_rays, bool)
    active[::17] = False
    rays = (t(ro), t(rd), torch.zeros(n_rays, device=device),
            torch.full((n_rays,), 1e30, device=device), t(active))
    tables = (tl.bvh_soa["packed"], tl.tri_soa["packed"], tl.inst)
    for name, bit in (("RAY_CAMERA", RAY_CAMERA), ("RAY_SHADOW", RAY_SHADOW)):
        mask = torch.full((n_rays,), int(bit), dtype=torch.int32,
                          device=device)
        cases[f"tlas_bin 24 instances, {name}"] = ("trace_tlas_bin", (
            *tables, *rays, mask, tl.max_leaf, tl.stack_size))
    stress = stress_rays(n_rays, -3.0, 3.0, 13, device)
    mixed = t(kinds[r.randint(0, 5, n_rays)])
    cases["tlas_bin 24 instances, stress rays"] = ("trace_tlas_bin", (
        *tables, *stress, mixed, tl.max_leaf, tl.stack_size))
    cases["tlas_bin 24 instances, stack 3"] = ("trace_tlas_bin", (
        *tables, *stress, None, tl.max_leaf, 3))
    nodes, tris, *bvh_rays, ml, ss = generator_case("trace_bvh", 300, n_rays,
                                                    1300, device)
    tri_vis = t(np.where(r.rand(300) < 0.5, 0x1f,
                         kinds[r.randint(0, 5, 300)] ^ 0x1f))
    cases["bvh 300 tris, masks"] = ("trace_bvh_vis", (
        nodes, tris, *bvh_rays, ml, ss, tri_vis, mixed))
    fl = shapes_scene(24, 3).finalize(device=device, instancing="flatten")
    cases[f"wide {fl.num_tris} tris, masks"] = ("trace_tlas_vis", (
        fl.bvh_soa["wrows"], 0, *rays, mixed, fl.max_leaf, fl.stack_size))
    cases[f"wide {fl.num_tris} tris, stress rays"] = ("trace_tlas_vis", (
        fl.bvh_soa["wrows"], 0, *stress, mixed, fl.max_leaf, fl.stack_size))
    for max_leaf in (6, 7):
        sc = instanced_scene(n_inst=6).finalize(device=device,
                                                max_leaf=max_leaf)
        rows = sc.bvh_soa["wrows_tlas"]
        cases[f"tlas max_leaf {max_leaf}, width {rows.shape[1]}"] = (
            "trace_tlas", (rows, int(sc.bvh_soa["winst_base"]),
                           *stress_rays(n_rays, -4.0, 4.0, 14, device),
                           None, max_leaf, sc.stack_size))
    return cases


def slice_scenes(settings, errs):
    """Finalize each ``SLICE`` scene on the card, capture every launch of
    one 1080p frame and hold each against its plain version.  Returns
    {label: (scene, cam, kernel, calls)}."""
    import torch

    out = {}
    for label, (_, kw, kernel, _) in SLICE.items():
        sc, cam = slice_scene(label)
        t_fin = time.perf_counter()
        scene = sc.finalize(**kw)
        t_fin = time.perf_counter() - t_fin
        soa = scene.bvh_soa
        tables = "".join(f", {k} {tuple(soa[k].shape)}"
                         for k in ("wrows", "wrows_tlas") if k in soa)
        print(f"scene {label}: mode {scene.mode}, {scene.num_tris} unique "
              f"tris, {soa['code0'].shape[0]} BVH2 nodes{tables}, "
              f"visibility {scene.has_visibility}, env map "
              f"{scene.env_tab_w}x{scene.env_tab_h}, {scene.num_lights} "
              f"lights, stack {scene.stack_size}; finalize {t_fin:.3f} s")
        _, calls = capture_frame(scene, cam, settings, 1)
        torch.cuda.synchronize()
        if len(calls) != 12 or any(c[0] != kernel for c in calls):
            fail(f"a {label} frame made {[c[0] for c in calls]}, expected 12 "
                 f"{kernel} calls")
        for i, (k, args, any_hit) in enumerate(calls):
            check_parity(k, args, (any_hit,), f"{label} launch {i}", errs)
        out[label] = (scene, cam, kernel, calls)
    return out


def tlas_against_flatten(flagship_scene, tlas_scene, cam, settings):
    """The flagship frame finalized both ways at the same iteration: the
    two-level structure is an implementation detail, so the frames' mean
    radiance agrees within ``TLAS_VS_FLATTEN_REL``."""
    _, flat = render_frame(flagship_scene, cam, settings, 5, (1, 1))
    _, tlas = render_frame(tlas_scene, cam, settings, 5, (1, 1))
    rel = abs(tlas - flat) / flat
    print(f"cornell_tlas against the flatten flagship, iteration 5: mean "
          f"radiance {tlas:.7f} vs {flat:.7f}, relative gap {rel:.2e} "
          f"(limit {TLAS_VS_FLATTEN_REL:g})")
    if not rel <= TLAS_VS_FLATTEN_REL:
        fail("the cornell_tlas frame's mean differs from the flatten "
             "flagship's")


def masked_vs_unmasked(label, calls):
    """The masked kernel against the unmasked one on the same tables and
    rays (the unmasked hits differ: it sees every instance): ms a launch,
    mean over the frame's launches of each mode."""
    pairs = {"trace_bvh_vis": ("trace_bvh", lambda a: a[:9]),
             "trace_tlas_vis": ("trace_tlas", lambda a: a)}
    for any_hit in (False, True):
        masked, plain = [], []
        for kernel, args, ah in calls:
            if ah != any_hit:
                continue
            base, cut = pairs[kernel]
            masked.append(time_launches(raw_launch(kernel, args, ah)[0], 50))
            plain.append(time_launches(raw_launch(base, cut(args), ah)[0],
                                       50))
        print(f"{label} {'anyhit' if any_hit else 'closest'}: masked "
              f"{calls[0][0]} {statistics.fmean(masked):.4f} ms, unmasked "
              f"{pairs[calls[0][0]][0]} {statistics.fmean(plain):.4f} ms a "
              f"launch on the same rays (mean of {len(masked)}) [{CARD}]")


# ---- the sky and texture slice: the physical sky, compressed textures,
# normal maps with tangent rotation, the SH-L1 output, the HLBVH builder ---
# label -> (builder in ray_tpu_torch.utils.test_scenes, finalize keywords,
# the kernel family every trace takes, pass settings beyond the frame's)
SKY = {
    "physical_sky": ("physical_sky", {}, "trace_brute", {}),
    "tex_features": ("tex_features", {}, "trace_tlas", {}),
    "sphere_hlbvh": ("sphere_hlbvh", dict(fast_build=True), "trace_bvh", {}),
    "flagship output_sh": ("cornell_scene", {}, "trace_brute",
                           dict(output_sh=True)),
}
FINALIZE.update({label: kw for label, (_, kw, _, _) in SKY.items()})
SKY_FRAMES = 2
# 64x48 card-vs-CPU tiles: across the sky scene's horizon, on the textured
# ball, on the HLBVH sphere, on the flagship's light
SKY_TILES = {"physical_sky": (928, 748), "tex_features": (928, 600),
             "sphere_hlbvh": (900, 840), "flagship output_sh": (928, 516)}
# fwd+bwd with stored residuals: tex_features as 2x2 tiles (its parent
# env_map peaked at 71.2 GiB as one 1080p tile), each its own backward
SKY_BWD = {"tex_features": GRID}
SKY_BWD_FRAMES = 2
# the sky bake at samples/05_physical_sky.py's settings (set_physical_sky's
# 256x128 map, the full sky, 10 cloud steps), and the size of the
# card-vs-CPU bake
SKY_BAKE = dict(width=256, height=128, full=True, cloud_steps=10)
SKY_BAKE_CPU = dict(width=64, height=32, full=True, cloud_steps=10)
# the card's bake against the CPU's: this share of texels within this
# relative gap (PyTorch's CUDA and CPU transcendentals differ in the last
# ulps, which the march's (1 - e^-x) / ext and the planet-scale heights
# amplify, tests/test_torch_sky.py)
SKY_BAKE_SHARE, SKY_BAKE_REL = 0.999, 1e-3
# shl1's L0 band is 0.282095 x color (tests/test_passes_tonemap.py:115)
SH_RTOL, SH_ATOL = 1e-4, 1e-5
# samples/05_physical_sky.py's main(): size, samples, depth
SAMPLE05 = dict(size=256, samples=16, max_total_depth=3)


def sky_scene(label):
    """(Scene, Camera) of a ``SKY`` scene, from the public API."""
    from ray_tpu_torch.utils import test_scenes

    return getattr(test_scenes, SKY[label][0])()


def sky_settings(settings, label):
    return dataclasses.replace(settings, **SKY[label][3])


def sky_scenes(settings, errs):
    """Build and finalize each ``SKY`` scene on the card (the sky's bake
    runs in its builder: ``set_physical_sky``), capture every launch of one
    1080p frame and hold each against its plain version.  Returns {label:
    (scene, cam, kernel, calls)} and the physical sky's build and finalize
    seconds."""
    import torch

    out, sky_s = {}, None
    for label, (_, kw, kernel, _) in SKY.items():
        torch.cuda.synchronize()
        t_build = time.perf_counter()
        sc, cam = sky_scene(label)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t_build
        t_fin = time.perf_counter()
        scene = sc.finalize(**kw)
        torch.cuda.synchronize()
        t_fin = time.perf_counter() - t_fin
        if label == "physical_sky":
            sky_s = (t_build, t_fin)
        soa = scene.bvh_soa
        tex = scene.textures
        print(f"scene {label}: mode {scene.mode}, {scene.num_tris} tris, "
              f"{soa['code0'].shape[0]} BVH2 nodes"
              f"{', wrows ' + str(tuple(soa['wrows'].shape)) if 'wrows' in soa else ''}"
              f", env map {scene.env_tab_w}x{scene.env_tab_h}, lights "
              f"{[k for k, *_ in scene.light_kinds]}, block rows "
              f"{tex['blocks_t'].shape[1] if 'blocks_t' in tex else 0}, RGBE "
              f"words {tex['rgbe_t'].shape[1] if 'rgbe_t' in tex else 0}, "
              f"normal maps {scene.has_normal_maps}, tangent rotation "
              f"{scene.has_aniso_rotation}; build {t_build:.3f} s, finalize "
              f"{t_fin:.3f} s")
        _, calls = capture_frame(scene, cam, sky_settings(settings, label), 1)
        torch.cuda.synchronize()
        if len(calls) != 12 or any(c[0] != kernel for c in calls):
            fail(f"a {label} frame made {[c[0] for c in calls]}, expected 12 "
                 f"{kernel} calls")
        for i, (k, args, any_hit) in enumerate(calls):
            check_parity(k, args, (any_hit,), f"{label} launch {i}", errs)
        out[label] = (scene, cam, kernel, calls)
    return out, sky_s


def check_sh(scene, cam, settings):
    """The SH frame's L0 band against 0.282095 x its color, and |L1| within
    the L0 band's bound (tests/test_passes_tonemap.py:106-121)."""
    import torch

    out = render(scene, cam, settings, 7)
    sh, color = out["shl1"], out["color"]
    if tuple(sh.shape) != (WIDTH * HEIGHT, 4, 3):
        fail(f"shl1 has shape {tuple(sh.shape)}")
    err = (sh[:, 0, :] - 0.282095 * color).abs()
    bad = int((err > SH_ATOL + SH_RTOL * (0.282095 * color).abs()).sum())
    l0 = sh[:, 0, :].abs()
    l1 = sh[:, 1:, :].abs().amax(dim=1)
    over = int((l1 > l0 * (0.488603 / 0.282095) + 1e-5).sum())
    print(f"flagship output_sh: shl1 {tuple(sh.shape)}, L0 vs 0.282095 x "
          f"color max |diff| {float(err.max()):.3e} ({bad} values past rtol "
          f"{SH_RTOL:g} / atol {SH_ATOL:g}), {over} pixels with |L1| past "
          f"the L0 bound; mean L1 {float(sh[:, 1:].mean()):.6f}")
    if bad or over or not bool(torch.isfinite(sh).all()):
        fail("the SH-L1 output disagrees with the color")


def sample05():
    """``samples/05_physical_sky.py``'s ``main()`` on the port's API: the
    sample's scene (``physical_sky``), ``create_renderer`` → 16 samples →
    ``pixels(AGX)`` at 256x256; its TGA into ``OUT_DIR``.  4 + 4
    ``trace_brute`` launches a sample (depth 3, NEE every bounce)."""
    import torch

    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.utils.image_io import write_tga
    from ray_tpu_torch.utils.test_scenes import physical_sky

    size, samples = SAMPLE05["size"], SAMPLE05["samples"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc, cam = physical_sky()
    scene = sc.finalize()
    r = ray_tpu.create_renderer(
        ray_tpu.RenderSettings(width=size, height=size),
        ray_tpu.PassSettings(max_total_depth=SAMPLE05["max_total_depth"]),
    )
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    img = r.render(scene, cam, samples=samples)
    px = r.pixels(cam, ray_tpu.ViewTransform.AGX)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_build.launch_counts)
    check_counts("samples/05_physical_sky", counts, "trace_brute", samples,
                 SAMPLE05["max_total_depth"] + 1)
    if not (tuple(px.shape) == (size, size, 3)
            and bool(torch.isfinite(img).all())
            and bool(((px >= 0) & (px <= 1)).all())
            and float(px.mean()) > 0.0):
        fail("samples/05_physical_sky's image is not finite, out of [0, 1] "
             "or black")
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "05_physical_sky.tga"
    write_tga(str(path), px)
    print(f"samples/05_physical_sky {size}x{size}, {samples} samples: scene "
          f"and renderer {t_setup * 1e3:.1f} ms, render + pixels "
          f"{wall * 1e3:.1f} ms ({wall / samples * 1e3:.2f} ms a sample), "
          f"radiance mean {float(img.mean()):.6f}, pixels(AGX) mean "
          f"{float(px.mean()):.6f}; launch counts {counts}; wrote {path} "
          f"[{CARD}]")
    return counts


def sky_bake_timings(sky_s):
    """The sky bake at ``SKY_BAKE`` on the card: forward ms, fwd+bwd ms of
    the mean w.r.t. ``atmosphere_density`` and ``clouds_density``, the
    backward's peak memory (and its rise over what the earlier phases left
    resident), and the forward's CUDA kernel count
    (``torch.profiler``); against the sky scene's finalize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.render import sky

    sd = (0.99, 0.139, 0.15)
    col = (30.0, 30.0, 30.0)

    def forward():
        with torch.no_grad():
            return sky.bake_sky_env(sky.AtmosphereParams(), sd, col,
                                    include_sun_disk=False, device="cuda",
                                    **SKY_BAKE)

    forward()
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        img = forward()
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0):
        fail("the sky bake is not finite, or black")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    grads = None
    bwd_s = []
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    for _ in range(2):
        dens = torch.tensor(1.0, device="cuda", requires_grad=True)
        cloud = torch.tensor(0.5, device="cuda", requires_grad=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = sky.bake_sky_env(
            sky.AtmosphereParams(atmosphere_density=dens,
                                 clouds_density=cloud),
            sd, col, include_sun_disk=False, device="cuda", **SKY_BAKE)
        img.mean().backward()
        torch.cuda.synchronize()
        bwd_s.append(time.perf_counter() - t0)
        grads = (float(dens.grad), float(cloud.grad))
    peak = torch.cuda.max_memory_allocated()
    if not all(g != 0.0 and g == g for g in grads):
        fail(f"the sky bake's gradients are zero or NaN: {grads}")
    build_s, fin_s = sky_s
    print(f"sky bake {SKY_BAKE['width']}x{SKY_BAKE['height']} full sky, "
          f"{SKY_BAKE['cloud_steps']} cloud steps: forward {fwd_ms:.1f} ms "
          f"(mean of {reps}), {n_kernels} CUDA kernels; fwd+bwd "
          f"{bwd_s[-1] * 1e3:.1f} ms, peak memory {peak / 2**30:.3f} GiB "
          f"({(peak - resident) / 2**30:.3f} GiB above the "
          f"{resident / 2**30:.3f} GiB resident before it), "
          f"d mean / d atmosphere_density {grads[0]:.6e}, d mean / d "
          f"clouds_density {grads[1]:.6e}; the sky scene's build (bake, "
          f"sun) {build_s * 1e3:.1f} ms and finalize {fin_s * 1e3:.1f} ms "
          f"[{CARD}]")
    if fwd_ms > fin_s * 1e3:
        print("  the forward bake takes longer than the scene's finalize")


def check_sky_bake_against_cpu():
    """The bake at ``SKY_BAKE_CPU`` on the card against the CPU:
    ``SKY_BAKE_SHARE`` of texels within ``SKY_BAKE_REL``, the worst texel
    printed."""
    import numpy as np

    from ray_tpu_torch.render import sky

    imgs = [sky.bake_sky_env(sky.AtmosphereParams(), (0.99, 0.139, 0.15),
                             (30.0, 30.0, 30.0), include_sun_disk=False,
                             device=dev, **SKY_BAKE_CPU).cpu().numpy()
            for dev in ("cuda", "cpu")]
    g, c = imgs
    rel = np.abs(g - c) / np.maximum(np.abs(c), 1e-30)
    texel = rel.max(-1)
    share = float((texel <= SKY_BAKE_REL).mean())
    y, x = np.unravel_index(int(texel.argmax()), texel.shape)
    print(f"sky bake {SKY_BAKE_CPU['width']}x{SKY_BAKE_CPU['height']} card "
          f"vs cpu: {share:.5f} of texels within {SKY_BAKE_REL:g} relative; "
          f"worst texel row {y} col {x}: {texel[y, x]:.3e} ({g[y, x]} vs "
          f"{c[y, x]}); median {float(np.median(texel)):.3e}")
    if not (share >= SKY_BAKE_SHARE and np.isfinite(g).all()):
        fail("the card's sky bake disagrees with the CPU's")


def profile_frames(cases):
    """Each (label, unprofiled ms, run) under torch.profiler: the device's
    kernel time and its share of the unprofiled run (a frame, or a tile
    against a quarter of its 2x2 frame), and the op table in
    ``OUT_DIR``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    OUT_DIR.mkdir(exist_ok=True)
    for label, ref_ms, run in cases:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        trace_ms = sum(e.time_range.elapsed_us() for e in kernels
                       if "trace_" in e.name) / 1e3
        name = label.replace("+", "_").replace(" ", "_")
        path = OUT_DIR / f"chip_smoke_profile_{name}.txt"
        with open(path, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=40))
        print(f"profile {label}: {len(kernels)} kernels, "
              f"{kern_ms:.1f} ms device time ({kern_ms / ref_ms:.3f} of the "
              f"{ref_ms:.1f} ms unprofiled run); trace kernels "
              f"{trace_ms:.2f} ms; table in {path} [{CARD}]")


def rng_cases(n, device):
    """{label: (dim, seed, sample, table)}: ``scrambled_2d_rand`` over
    ``n`` lanes in computed and table mode, ``dim`` and ``sample`` each an
    int and a per-lane int64 tensor.  Seeds are random 32-bit words that
    start with ``RNG_SEEDS``; per-lane dimensions lie below the deepest
    bounce's (64) but for one lane at 2^32 - 1, per-lane samples over all
    32 bits; the int dimension 2^32 - 3 wraps in ``dim * 2``."""
    import numpy as np
    import torch

    r = np.random.default_rng(n)
    seed = r.integers(0, 1 << 32, n, dtype=np.int64)
    k = min(n, len(RNG_SEEDS))
    seed[:k] = RNG_SEEDS[:k]
    dims = r.integers(0, 64, n, dtype=np.int64)
    dims[1:2] = (1 << 32) - 1
    samples = r.integers(0, 1 << 32, n, dtype=np.int64)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    seed, dims, samples = t(seed), t(dims), t(samples)
    cases = {}
    for table in (False, True):
        for dim_label, dim in (("int", (1 << 32) - 3), ("lanes", dims)):
            for sample_label, sample in (("int", 70_000), ("lanes", samples)):
                label = (f"{'table' if table else 'computed'}, dim "
                         f"{dim_label}, sample {sample_label}")
                cases[label] = (dim, seed, sample, table)
    return cases


def pixel_cases(n, device):
    """(px, py): ``n`` random int32 pixel coordinates over the whole int32
    range, for ``pixel_seed``."""
    import numpy as np
    import torch

    r = np.random.default_rng(n + 1)
    px, py = r.integers(-(1 << 31), 1 << 31, (2, n)).astype(np.int32)
    return torch.from_numpy(px).to(device), torch.from_numpy(py).to(device)


def check_rng(n, device):
    """``rng_draw`` bit-exact against the plain int64 route on the same
    card tensors: every ``rng_cases`` draw and ``pixel_seed`` at every
    ``RNG_SEEDS`` frame seed, one launch each."""
    import torch

    from ray_tpu_torch.ops import cuda_build, rng

    before = cuda_build.launch_counts.copy()
    cases = rng_cases(n, device)
    for label, (dim, seed, sample, table) in cases.items():
        k = rng.scrambled_2d_rand(dim, seed, sample, table=table)
        p = rng._scrambled_2d_rand_plain(dim, seed, sample, table)
        if not all(same_bits(a, b) for a, b in zip(k, p)):
            fail(f"rng_draw differs from the plain version ({label}, {n} "
                 f"lanes)")
    px, py = pixel_cases(n, device)
    for rand_seed in RNG_SEEDS:
        if not torch.equal(rng.pixel_seed(px, py, rand_seed),
                           rng.pixel_seed_plain(px, py, rand_seed)):
            fail(f"rng_pixel_seed differs from the plain version (frame "
                 f"seed {rand_seed}, {n} lanes)")
    counts = cuda_build.launch_counts
    if (counts["rng_draw"] - before["rng_draw"] != len(cases)
            or counts["rng_pixel_seed"] - before["rng_pixel_seed"]
            != len(RNG_SEEDS)):
        fail("a draw or pixel seed did not take one launch of rng_draw")
    print(f"  parity rng_draw: {len(cases)} draws and {len(RNG_SEEDS)} pixel "
          f"seeds over {n} lanes bit-exact, one launch each")


def rng_cost(scene, cam, settings):
    """The RNG's cost: the draws and pixel seeds of one flagship frame,
    and one draw over a frame's lanes (per-lane dimensions, as the
    integrator's) through the kernel back to back and in one CUDA graph
    (device time) beside the plain int64 route and the bound (24 B a
    lane); ``pixel_seed`` alike (16 B a lane).  Returns the kernels
    line's row."""
    import torch

    from ray_tpu_torch.ops import cuda_build, rng

    n = WIDTH * HEIGHT
    cuda_build.reset_launch_counts()
    render_frame(scene, cam, settings, 99, (1, 1))
    draws = cuda_build.launch_counts["rng_draw"]
    seeds = cuda_build.launch_counts["rng_pixel_seed"]
    seed = torch.arange(n, device="cuda", dtype=torch.int64)
    dim = seed % 48 + rng.RAND_DIM_BASE_COUNT
    px = (seed % WIDTH).to(torch.int32)
    py = (seed // WIDTH).to(torch.int32)
    row = {
        "ms": time_launches(lambda: rng.scrambled_2d_rand(dim, seed, 0), 50),
        "device_ms": time_graph(
            lambda: rng.scrambled_2d_rand(dim, seed, 0), 50),
        "plain_ms": time_launches(
            lambda: rng._scrambled_2d_rand_plain(dim, seed, 0, False), 10),
        "bound_ms": 24 * n / PEAK_BYTES_PER_S * 1e3,
        "pixel_seed_ms": time_launches(lambda: rng.pixel_seed(px, py, 7), 50),
        "pixel_seed_device_ms": time_graph(
            lambda: rng.pixel_seed(px, py, 7), 50),
        "pixel_seed_plain_ms": time_launches(
            lambda: rng.pixel_seed_plain(px, py, 7), 10),
        "pixel_seed_bound_ms": 16 * n / PEAK_BYTES_PER_S * 1e3,
        "launches": draws + seeds,
    }
    print(f"rng: a flagship frame draws {draws} times and makes {seeds} "
          f"pixel seeds, one rng_draw launch each; one scrambled_2d_rand "
          f"over {n} lanes: kernel {row['ms']:.4f} ms back to back, device "
          f"{row['device_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms (bytes); pixel_seed: kernel "
          f"{row['pixel_seed_ms']:.4f} ms, device "
          f"{row['pixel_seed_device_ms']:.4f} ms, plain "
          f"{row['pixel_seed_plain_ms']:.3f} ms, bound "
          f"{row['pixel_seed_bound_ms']:.4f} ms; a frame's draws: plain "
          f"{row['plain_ms'] * draws:.1f} ms, kernel "
          f"{row['device_ms'] * draws:.2f} ms of device time [{CARD}]")
    return row


def gather_cases(device):
    """The gather probe's inputs (scripts/test_pallas_gather.py
    ``try_kernel``: ``arange`` tables of shape (1024,) and (1, 1024), the
    (8, 128) index of ``default_rng(0)``), a random table with NaNs
    (payloads included), -0 and infinities, and 2,073,600 random indices:
    one 1080p frame of lanes.  {label: (table, idx)}."""
    import numpy as np
    import torch

    n = GATHER_TABLE
    idx = np.random.default_rng(0).integers(0, n, (8, 128)).astype(np.int32)
    r = np.random.default_rng(1)
    bits = r.normal(size=n).astype(np.float32).view(np.uint32)
    bits[::7] = 0x7FC00000 | r.integers(0, 1 << 22, bits[::7].shape,
                                        dtype=np.uint32)
    bits[3::11] = 0xFFC00001
    bits[1::13] = 0x80000000
    bits[5::19] = 0x7F800000
    special = bits.view(np.float32)
    frame = r.integers(0, n, (HEIGHT, WIDTH)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    arange = np.arange(n, dtype=np.float32)
    return {"probe (1024,)": (t(arange), t(idx)),
            "probe (1, 1024)": (t(arange.reshape(1, n)), t(idx)),
            "probe NaN/-0 table": (t(special), t(idx)),
            "frame 2,073,600 lanes": (t(special), t(frame))}


def check_gather(cases):
    """gather_table bit-exact against gather_table_plain on every case."""
    from ray_tpu_torch.ops.gather_probe import gather_table, gather_table_plain

    for label, (table, idx) in cases.items():
        k = gather_table(table, idx)
        p = gather_table_plain(table, idx)
        if k.shape != idx.shape or not same_bits(k, p):
            fail(f"gather_table differs from its plain version on {label}")
        print(f"  parity gather_table {label}: bit-exact ({idx.numel()} "
              f"lanes, table {tuple(table.shape)})")


def gather_timings(cases):
    """Kernel (raw launch, uncounted), plain version and the one-call
    library yardstick (``index_select``, which takes int32 indices) at the
    probe's size and a frame's; the bound: bytes, 4 a table entry and 8 a
    lane, over the HBM rate."""
    import torch

    from ray_tpu_torch.ops import gather_probe

    rows = {}
    for label in ("probe (1024,)", "frame 2,073,600 lanes"):
        table, idx = cases[label]
        out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
        fn = gather_probe._gather_fn()
        stream = torch.cuda.current_stream().cuda_stream
        args = (table.data_ptr(), table.numel(), idx.data_ptr(), idx.numel(),
                out.data_ptr(), stream)

        def launch():
            if fn(*args) != 0:
                fail("gather_table launch failed while timing")
        flat = table.reshape(-1)
        rows[label] = {
            "ms": time_launches(launch, 200),
            "plain_ms": time_launches(
                lambda: gather_probe.gather_table_plain(table, idx), 200),
            "library_ms": time_launches(
                lambda: torch.index_select(flat, 0, idx.reshape(-1)), 200),
            "bound_ms": (4 * table.numel() + 8 * idx.numel())
            / PEAK_BYTES_PER_S * 1e3,
        }
        r = rows[label]
        print(f"gather_table {label}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library (index_select) "
              f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms "
              f"(bytes) [{CARD}]")
    return rows


def renderer_path(settings):
    """The user's entry point at full width: ``create_renderer`` →
    ``render`` (8 samples) → ``pixels`` (AgX through its LUT, filmic
    medium contrast), then 8 more samples with adaptive sampling on
    (``min_samples=4, variance_threshold=0.05``), the launch counts set to 0
    just before each and read just after: 6 + 6 ``trace_brute`` launches a
    sample."""
    import torch

    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.ops import cuda_build

    sc, cam = flagship()
    scene = sc.finalize()
    r = ray_tpu.create_renderer(
        ray_tpu.RenderSettings(width=WIDTH, height=HEIGHT,
                               collect_stats=True),
        settings, log=ray_tpu.LogStdout())
    if r.device != scene.device:
        fail(f"the renderer is on {r.device}, the scene on {scene.device}")
    r.render(scene, cam, 1)          # warm-up
    r.clear()
    counts = {}
    for half, samples in (("plain", 8), ("adaptive", 8)):
        if half == "adaptive":
            r.settings = dataclasses.replace(r.settings, min_samples=4,
                                             variance_threshold=0.05)
        r.reset_stats()
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        img = r.render(scene, cam, samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[half] = dict(cuda_build.launch_counts)
        check_counts(f"renderer ({half})", counts[half], "trace_brute",
                     samples)
        rays = r.get_stats()["rays_traced"]
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or img.device != r.device:
            fail(f"radiance_image has shape {tuple(img.shape)} on "
                 f"{img.device}")
        if not bool(torch.isfinite(img).all()) or not float(img.mean()) > 0:
            fail("the renderer's radiance is not finite or black")
        print(f"renderer flagship 1920x1080 depth5, {half} samples "
              f"{r.iteration - samples + 1}..{r.iteration}: "
              f"{wall / samples * 1e3:.1f} ms a sample, "
              f"{rays / wall / 1e6:.3f} Mray/s ({rays / samples:.0f} rays a "
              f"sample); active share {float(r.active_px.float().mean()):.4f}"
              f"; radiance mean {float(img.mean()):.6f} [{CARD}]")
        print(f"  launch counts over {samples} samples: {counts[half]}")
        if half == "plain":
            for vt in ("AGX", "FILMIC_MED_CONTRAST"):
                px = r.pixels(cam, getattr(ray_tpu.ViewTransform, vt))
                if not (tuple(px.shape) == (HEIGHT, WIDTH, 3)
                        and bool(((px >= 0) & (px <= 1)).all())
                        and float(px.mean()) > 0.0):
                    fail(f"pixels({vt}) out of [0, 1], black or misshapen")
                print(f"  pixels({vt}): mean {float(px.mean()):.6f}")
    active = float(r.active_px.float().mean())
    if not active < 1.0:
        fail("adaptive sampling stopped no pixel")
    return counts


def check_renderer_against_cpu(settings):
    """A 64x48 renderer, 4 samples with adaptive sampling on (from sample
    2), on the card against the same on the CPU: radiance within rtol 1e-3
    (atol 1e-4) and pixels(AGX) within 1e-3 on >= 99% of pixels, the active
    masks equal on >= 99.9%."""
    import numpy as np

    import ray_tpu_torch as ray_tpu

    outs = []
    for backend in ("gpu", "cpu"):
        sc, cam = flagship()
        r = ray_tpu.create_renderer(
            ray_tpu.RenderSettings(width=64, height=48, min_samples=2,
                                   variance_threshold=0.05),
            settings, enabled_types=(backend,))
        r.render(sc.finalize(device=r.device), cam, 4)
        outs.append([a.cpu().numpy() for a in (
            r.radiance_image(), r.pixels(cam, ray_tpu.ViewTransform.AGX),
            r.active_px)])
    (g_rad, g_px, g_act), (c_rad, c_px, c_act) = outs
    rad = np.isclose(g_rad, c_rad, rtol=1e-3, atol=1e-4).all(-1).mean()
    px = (np.abs(g_px - c_px) <= 1e-3).all(-1).mean()
    act = (g_act == c_act).mean()
    print(f"renderer 64x48 (4 samples, adaptive) card vs cpu: radiance close "
          f"{rad:.4f}, pixels close {px:.4f}, active masks equal {act:.4f} "
          f"(active share {g_act.mean():.4f} / {c_act.mean():.4f})")
    if not (rad >= 0.99 and px >= 0.99 and act >= 0.999
            and np.isfinite(g_rad).all()):
        fail("the card's 64x48 renderer disagrees with the CPU path")


def quickstart():
    """The README quickstart on the card: 2 triangles, a GLOSSY material,
    a sphere light, 512x512, 16 samples."""
    import torch

    import ray_tpu_torch as ray_tpu

    sc = ray_tpu.Scene()
    mat = sc.add_material(ray_tpu.MaterialDesc(type=1,
                                               base_color=(.7, .7, .7)))
    sc.add_mesh(vertices=[[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                indices=[[0, 1, 2], [0, 2, 3]], material=mat)
    sc.add_light(ray_tpu.LightDesc(type=0, position=(0, 3, 0), radius=.3,
                                   color=(20, 20, 20)))
    scene = sc.finalize()
    cam = ray_tpu.make_camera(origin=(0, 2, 6), look_at=(0, 0, 0), fov=50)
    r = ray_tpu.create_renderer(ray_tpu.RenderSettings(width=512, height=512))
    t0 = time.perf_counter()
    img = r.render(scene, cam, samples=16)
    pixels = r.pixels(cam, ray_tpu.ViewTransform.AGX)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (bool(torch.isfinite(img).all()) and bool(
            torch.isfinite(pixels).all()) and float(img.mean()) > 0.0):
        fail("the quickstart image is not finite, or black")
    print(f"quickstart 512x512, 16 samples: {wall * 1e3:.1f} ms, radiance "
          f"mean {float(img.mean()):.6f}, pixels(AGX) mean "
          f"{float(pixels.mean()):.6f}")


# ---------------------------------------------------------------------------
# The cache and denoising slice: the SBVH builder, the spatial radiance
# cache with radcache_accumulate, the NLM and UNet denoisers
# ---------------------------------------------------------------------------

ACCUMULATE = dict(source="ray_tpu_torch/csrc/radcache_accumulate.cu",
                  replaces="ray_tpu/render/radcache.py:232")
# the SBVH scenes: builder, kernel, grid, pass settings' name, tile origin
SBVH = {
    "cornell_sphere sbvh": ("cornell_sphere", "trace_bvh", (1, 1), (900, 840)),
    "colonnade sbvh": ("colonnade", "trace_tlas", GRID, (912, 500)),
}
SBVH_FRAMES = 2
SBVH_WORKER_TIMEOUT = 600   # seconds the colonnade's SBVH finalize may take
# where the worker leaves the finalized scene (the build directory, which
# git ignores; removed once loaded)
SBVH_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
# the cached renderer: samples, the uncached mean's bound
# (tests/test_radcache.py:121), the determinism runs' samples
CACHE_SAMPLES = 8
CACHE_MEAN_REL = 0.08
CACHE_DET_SAMPLES = 3
# the forced-collision case: entries, lanes
COLLIDE = (1 << 6, 20_000)
# radcache_accumulate's stress cases (accumulate_stress_case)
ACC_STRESS = ("segment lengths", "one segment of 100,000 lanes",
              "every lane invalid", "one lane valid", "rows 0 and n_rows - 1",
              "signed zeros, infinities and NaNs")
# their segment lengths, each placed with its head at each of the offsets
# in a tile of the kernel's (512 sorted positions, position t + 128 j on
# thread t: warps of 32, rows of 128)
ACC_LENGTHS = (1, 31, 32, 33, 255, 256, 257, 1025)
ACC_TILE = 512
ACC_OFFSETS = (0, 1, 31, 32, 127, 128, 129, 511)
# radcache_accumulate's bound: a valid lane reads its entry (4 B), its
# radiance (12 B), its count (4 B) and its sort index (8 B: torch.sort's
# int64); a touched entry reads and writes its radiance and count (32 B)
ACC_BYTES_PER_LANE = 28
ACC_BYTES_PER_ENTRY = 32
SAMPLE04 = dict(size=256, samples=8, max_total_depth=4)
DENOISE_REPS = 3
# the UNet on the card against the CPU, TF32 off: the largest |diff| over
# the output's largest value
UNET_REL = 1e-4


def sbvh_worker(path) -> int:
    """``chip_smoke.py --sbvh-scene PATH``: the colonnade finalized with
    ``spatial_splits=True`` on the CPU (numpy SBVHs of its meshes: most of
    a minute of host time, run beside the card's phases), written with
    ``save_scene``; the SBVH and SAH finalize seconds as the last line."""
    import torch

    import ray_tpu_torch as ray_tpu

    torch.set_num_threads(1)
    sc, _ = colonnade()
    t0 = time.perf_counter()
    sc.finalize(device="cpu")
    sah_s = time.perf_counter() - t0
    sc, _ = colonnade()
    t0 = time.perf_counter()
    scene = sc.finalize(device="cpu", spatial_splits=True)
    sbvh_s = time.perf_counter() - t0
    ray_tpu.save_scene(path, scene)
    print(json.dumps({"sbvh_s": sbvh_s, "sah_s": sah_s}))
    return 0


def start_sbvh_worker():
    """Start the SBVH worker; it is killed at exit if still running."""
    import atexit

    path = SBVH_DIR / "colonnade_sbvh.npz"
    SBVH_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--sbvh-scene", str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc, path


def sbvh_scenes(worker, settings, settings_big, errs):
    """The SBVH scenes: ``cornell_sphere`` finalized here, the colonnade by
    the worker; each one's finalize seconds against the SAH one's, its
    route and rows, and every launch of one 1080p frame (the colonnade's
    2x2 grid) bit-exact against the plain version.  Returns {label:
    (scene, cam, kernel, grid, settings, cpu scene or None)}."""
    import torch

    import ray_tpu_torch as ray_tpu

    out = {}
    for label, (name, kernel, grid, _) in SBVH.items():
        cpu_scene = None
        if name == "cornell_sphere":
            st = settings
            sc, cam = cornell_sphere()
            t0 = time.perf_counter()
            sc.finalize()
            sah_s = time.perf_counter() - t0
            sc, cam = cornell_sphere()
            t0 = time.perf_counter()
            scene = sc.finalize(spatial_splits=True)
            sbvh_s = time.perf_counter() - t0
        else:
            st = settings_big
            proc, path = worker
            try:
                stdout, stderr = proc.communicate(timeout=SBVH_WORKER_TIMEOUT)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if proc.returncode != 0:
                fail(f"the SBVH worker exited {proc.returncode}: "
                     f"{stderr.strip()[-2000:]}")
            times = json.loads(stdout.strip().splitlines()[-1])
            sah_s, sbvh_s = times["sah_s"], times["sbvh_s"]
            _, cam = colonnade()
            scene = ray_tpu.load_scene(str(path))
            cpu_scene = ray_tpu.load_scene(str(path), device="cpu")
            path.unlink()
        soa = scene.bvh_soa
        rows = soa.get("wrows_tlas", soa.get("wrows"))
        print(f"scene {label}: mode {scene.mode}, {scene.num_tris} leaf "
              f"triangle references, {soa['code0'].shape[0]} BVH2 node rows"
              f"{'' if rows is None else f', wide rows {tuple(rows.shape)}'}"
              f", route {kernel}; finalize {sbvh_s:.3f} s with spatial "
              f"splits against {sah_s:.3f} s SAH (host) [{CARD}]")
        n_calls = 0
        for x0, y0, tw, th in grid_tiles(grid):
            _, calls = capture_frame(scene, cam, st, 1, x0, y0, tw, th)
            torch.cuda.synchronize()
            if len(calls) != 12 or any(c[0] != kernel for c in calls):
                fail(f"a {label} tile made {[c[0] for c in calls]}, expected "
                     f"12 {kernel} calls")
            for i, (k, args, any_hit) in enumerate(calls):
                check_parity(k, args, (any_hit,),
                             f"{label} tile ({x0}, {y0}) launch {i}", errs)
            n_calls += len(calls)
            del calls
        print(f"  {label}: all {n_calls} launches of a 1080p frame bit-exact")
        out[label] = (scene, cam, kernel, grid, st, cpu_scene)
    return out


def check_collisions(errs):
    """radcache_accumulate on the forced-collision case: ``COLLIDE``
    entries, lanes; bit-exact against the plain version on the CPU."""
    import torch

    from ray_tpu_torch.render import radcache

    n_entries, R = COLLIDE
    g = torch.Generator().manual_seed(11)
    entry = torch.randint(0, n_entries, (R,), generator=g)
    valid = torch.rand(R, generator=g) < 0.8
    rad = torch.randn((R, 3), generator=g) * 1e3
    cnt = torch.randint(0, 4, (R,), generator=g, dtype=torch.int32)
    table = torch.randn((n_entries + 1, 3), generator=g)
    counts = torch.randint(0, 9, (n_entries + 1,), generator=g,
                           dtype=torch.int32)
    args = (table, counts, entry, rad, cnt, valid)
    out = radcache.accumulate_segments(*(a.cuda() for a in args))
    ref = radcache.accumulate_plain(*args)
    check_accumulate(out, ref, "the forced-collision case", errs)
    print(f"  parity forced collisions ({n_entries} entries, {R} lanes, "
          f"{int(valid.sum())} valid, longest segment "
          f"{int(torch.bincount(entry[valid]).max())}): bit-exact")


def accumulate_stress_case(name):
    """The CPU tensors (table, counts, entry, rad, cnt, valid) of the
    ``ACC_STRESS`` case ``name``, from a numpy seed.  The lanes are
    shuffled and ~25% of them invalid (their entries random), so a
    segment's sorted lanes are scattered over ``rad``.

    * "segment lengths": a segment of each of ``ACC_LENGTHS`` lanes with its
      head at each of ``ACC_OFFSETS`` within an ``ACC_TILE``-position tile
      (so at tile, warp and thread boundaries), fillers of other lengths
      between them;
    * "one segment of 100,000 lanes", after three of 37 lanes and before
      one of 5;
    * "every lane invalid" and "one lane valid" (3,000 lanes);
    * "rows 0 and n_rows - 1": every valid lane in the table's first or
      last row (1,025 rows);
    * "signed zeros, infinities and NaNs": 64 entries of skewed sizes (a
      few lanes to thousands), entry e drawing its radiance by e % 8 from
      normals, ±0, -0 only (on a -0 table value), +inf with normals, +inf
      with -inf, NaNs with payloads (quiet and signalling, both signs)
      among normals, subnormals with ±0, normals on a signalling-NaN table
      value."""
    import numpy as np
    import torch

    g = np.random.default_rng(ACC_STRESS.index(name) + 40)
    if name == "segment lengths":
        sizes, pos = [], 0
        for length in ACC_LENGTHS:
            for off in ACC_OFFSETS:
                fill = (off - pos) % ACC_TILE
                if fill:
                    sizes.append(fill)
                sizes += [length, int(g.integers(1, 40))]
                pos += fill + length + sizes[-1]
    elif name == "one segment of 100,000 lanes":
        sizes = [37, 37, 37, 100_000, 5]
    elif name == "rows 0 and n_rows - 1":
        sizes = [4_000] + [0] * 1_023 + [3_000]
    else:
        sizes = {"every lane invalid": [0, 0, 0],
                 "one lane valid": [0, 1, 0],
                 "signed zeros, infinities and NaNs":
                     np.floor(3_000 * g.random(64) ** 4).astype(int) + 1,
                 }[name]
    sizes = np.asarray(sizes, np.int64)
    n_rows = len(sizes) + 1 if name != "rows 0 and n_rows - 1" else len(sizes)
    n_valid = int(sizes.sum())
    R = max(n_valid * 4 // 3, 3_000)
    lanes = g.permutation(R)
    entry = g.integers(0, n_rows, R)
    valid = np.zeros(R, bool)
    entry[lanes[:n_valid]] = np.repeat(np.arange(len(sizes)), sizes)
    valid[lanes[:n_valid]] = True
    rad = (g.standard_normal((R, 3)) * 1e3).astype(np.float32)
    table = g.standard_normal((n_rows, 3)).astype(np.float32)
    if name == "signed zeros, infinities and NaNs":
        cat = np.where(valid, entry % 8, 0)[:, None]
        u = g.random((R, 3), dtype=np.float32)
        signs = np.where(u < 0.5, -1.0, 1.0).astype(np.float32)
        nan_bits = (g.integers(1, 1 << 22, (R, 3)) | 0x7F800000
                    | (g.integers(0, 2, (R, 3)) << 31)
                    | (g.integers(0, 2, (R, 3)) << 22)).astype(np.uint32)
        rad = np.where(cat == 1, signs * 0.0, rad)
        rad = np.where(cat == 2, np.float32(-0.0), rad)
        rad = np.where((cat == 3) & (u < 0.1), np.inf, rad)
        rad = np.where(cat == 4, signs * np.inf, rad)
        rad = np.where((cat == 5) & (u < 0.05), nan_bits.view(np.float32),
                       rad)
        rad = np.where(cat == 6, np.where(u < 0.3, signs * 0.0, signs
                                          * np.float32(1e-40) * u), rad)
        rad = rad.astype(np.float32)
        table[2::8] = -0.0
        table.view(np.uint32)[7::8] = 0x7FA12345
    cnt = g.integers(0, 4, R).astype(np.int32)
    counts = g.integers(0, 9, n_rows).astype(np.int32)
    return tuple(torch.from_numpy(a) for a in (table, counts, entry, rad,
                                                cnt, valid))


def check_accumulate_stress(errs):
    """radcache_accumulate on each ``ACC_STRESS`` case, twice: both runs
    bit-identical and bit-exact against the plain version on the CPU; the
    100,000-lane segment's launch timed beside ``index_add_`` x2."""
    from ray_tpu_torch.render import radcache

    for name in ACC_STRESS:
        args = accumulate_stress_case(name)
        gpu = tuple(a.cuda() for a in args)
        out = radcache.accumulate_segments(*gpu)
        again = radcache.accumulate_segments(*gpu)
        if not all(same_bits(a, b) for a, b in zip(out, again)):
            fail(f"two radcache_accumulate runs differ on {name}")
        check_accumulate(out, radcache.accumulate_plain(*args), name, errs)
        print(f"  parity {name} ({args[2].shape[0]} lanes, "
              f"{int(args[5].sum())} valid): bit-exact, two runs "
              f"bit-identical")
        if name == "one segment of 100,000 lanes":
            accumulate_timing(gpu, label="the 100,000-lane segment case's")


def check_accumulate(out, ref, label, errs):
    for o, r, name in zip(out, ref, ("rad_curr", "cnt_curr")):
        o = o.cpu()
        errs["radcache_accumulate"] = max(errs.get("radcache_accumulate", 0.0),
                                          max_abs_err(o, r))
        if not same_bits(o, r):
            fail(f"radcache_accumulate {name} differs from the plain version "
                 f"on {label}: max |diff| {max_abs_err(o, r)}")


def cache_states_equal(a, b) -> bool:
    return all(same_bits(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def cached_renderer(settings, errs):
    """``create_renderer`` on the flagship at 1920x1080 with
    ``use_spatial_cache`` (default ``cache_entries`` and
    ``cache_downsample``): ``CACHE_SAMPLES`` samples of update (a 480x270
    pass) → resolve → query render, the launch counts set to 0 just before
    and read just after (one ``radcache_accumulate`` an update pass, 12 +
    12 ``trace_brute`` a sample); every accumulate launch held bit-exact
    against the plain version on its inputs copied to the CPU; the image
    mean against an uncached renderer's within ``CACHE_MEAN_REL``; two runs
    of ``CACHE_DET_SAMPLES`` samples give bit-identical caches.  Returns
    (the renderer, the launch counts, the last update pass's accumulate
    inputs)."""
    import torch

    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render import radcache

    sc, cam = flagship()
    scene = sc.finalize()

    def renderer(cache=True):
        return ray_tpu.create_renderer(
            ray_tpu.RenderSettings(width=WIDTH, height=HEIGHT,
                                   use_spatial_cache=cache,
                                   collect_stats=cache), settings)

    renderer().render(scene, cam, 1)    # warm-up
    real = radcache.accumulate_segments
    captured = []

    def recording(*args):
        out = real(*args)
        captured.append((tuple(a.clone() for a in args),
                         tuple(o.clone() for o in out)))
        return out

    r = renderer()
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    radcache.accumulate_segments = recording
    try:
        t0 = time.perf_counter()
        img = r.render(scene, cam, CACHE_SAMPLES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        radcache.accumulate_segments = real
    counts = dict(cuda_build.launch_counts)
    n_acc = counts.pop("radcache_accumulate", 0)
    if n_acc != CACHE_SAMPLES or len(captured) != CACHE_SAMPLES:
        fail(f"the cached renderer launched radcache_accumulate {n_acc} "
             f"times in {CACHE_SAMPLES} samples")
    check_counts("cached renderer", counts, "trace_brute", CACHE_SAMPLES, 12)
    longest, n_valid = 0, []
    for i, (args, out) in enumerate(captured):
        ref = radcache.accumulate_plain(*(a.cpu() for a in args))
        check_accumulate(out, ref, f"update pass {i + 1}", errs)
        e = args[2][args[5]]
        n_valid.append(int(e.numel()))
        longest = max(longest, int(torch.bincount(e).max()))
    stats = r.get_stats()
    warm = int((r.cache.cnt_prev >= radcache.RAD_CACHE_SAMPLE_COUNT_MIN).sum())
    used = int(((r.cache.key_lo != 0) | (r.cache.key_hi != 0)).sum())
    plain = renderer(cache=False)
    ref_img = plain.render(scene, cam, CACHE_SAMPLES)
    rel = abs(float(img.mean()) - float(ref_img.mean())) / float(
        ref_img.mean())
    print(f"cached renderer flagship 1920x1080 depth5, {CACHE_SAMPLES} "
          f"samples (update {WIDTH // 4}x{HEIGHT // 4} -> resolve -> query): "
          f"{wall / CACHE_SAMPLES * 1e3:.1f} ms a sample; update pass "
          f"{stats['time_cache_update_us'] / CACHE_SAMPLES / 1e3:.1f} ms, "
          f"resolve {stats['time_cache_resolve_us'] / CACHE_SAMPLES / 1e3:.2f}"
          f" ms, query sample {stats['time_render_us'] / CACHE_SAMPLES / 1e3:.1f}"
          f" ms; {used} entries used of {r.settings.cache_entries}, {warm} "
          f"warm (>= {radcache.RAD_CACHE_SAMPLE_COUNT_MIN} samples); valid "
          f"lanes an update pass {min(n_valid)}..{max(n_valid)}, longest "
          f"accumulate segment {longest} lanes; every accumulate launch "
          f"bit-exact; mean {float(img.mean()):.6f} against uncached "
          f"{float(ref_img.mean()):.6f} (rel {rel:.4f}, bound "
          f"{CACHE_MEAN_REL}) [{CARD}]")
    print(f"  launch counts over {CACHE_SAMPLES} samples: "
          f"{dict(counts, radcache_accumulate=n_acc)}")
    if not (warm > 0 and rel < CACHE_MEAN_REL
            and bool(torch.isfinite(img).all())):
        fail("the cached renderer's image strays from the uncached one, or "
             "no entry warmed")
    runs = []
    for _ in range(2):
        d = renderer()
        d.render(scene, cam, CACHE_DET_SAMPLES)
        runs.append(d.cache)
    if not cache_states_equal(*runs):
        fail("two runs of the cached renderer gave different caches")
    print(f"  two runs of {CACHE_DET_SAMPLES} cached samples: bit-identical "
          f"cache states")
    return r, dict(counts, radcache_accumulate=n_acc), captured[-1][0]


def check_cached_renderer_against_cpu(settings):
    """A 64x48 cached renderer (update at 32x24 -> resolve -> query, 3
    samples) on the card against the CPU: radiance within rtol 1e-3 /
    atol 1e-4 on >= 99% of pixels, the mean within 1e-3."""
    import numpy as np

    import ray_tpu_torch as ray_tpu

    outs = []
    for backend in ("gpu", "cpu"):
        sc, cam = flagship()
        r = ray_tpu.create_renderer(
            ray_tpu.RenderSettings(width=64, height=48, use_spatial_cache=True,
                                   cache_entries=1 << 16, cache_downsample=2),
            settings, enabled_types=(backend,))
        img = r.render(sc.finalize(device=r.device), cam, 3)
        outs.append(img.cpu().numpy())
    g, c = outs
    close = np.isclose(g, c, rtol=1e-3, atol=1e-4).all(-1).mean()
    rel = abs(g.mean() - c.mean()) / c.mean()
    print(f"cached renderer 64x48 (3 samples) card vs cpu: radiance close "
          f"{close:.4f}, mean rel diff {rel:.2e}")
    if not (close >= 0.99 and rel < 1e-3 and np.isfinite(g).all()):
        fail("the card's 64x48 cached renderer disagrees with the CPU path")


def sample04():
    """``samples/04_denoising.py``'s ``main()`` on the port's API: the
    flagship through ``create_renderer`` at 256x256, 8 samples, depth 4 →
    ``denoise_image("nlm")`` → view transform 0 → TGA into ``OUT_DIR``;
    then NLM and UNet of those buffers on the card against the CPU.
    5 + 5 ``trace_brute`` launches a sample."""
    import numpy as np
    import torch

    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render.tonemap import apply_view_transform
    from ray_tpu_torch.utils.image_io import write_tga

    size, samples = SAMPLE04["size"], SAMPLE04["samples"]
    sc, cam = flagship()
    scene = sc.finalize()
    r = ray_tpu.create_renderer(
        ray_tpu.RenderSettings(width=size, height=size),
        ray_tpu.PassSettings(max_total_depth=SAMPLE04["max_total_depth"]))
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    r.render(scene, cam, samples=samples)
    noisy = r.pixels(cam)
    t1 = time.perf_counter()
    den = apply_view_transform(r.denoise_image("nlm"), 0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(cuda_build.launch_counts)
    check_counts("samples/04_denoising", counts, "trace_brute", samples,
                 SAMPLE04["max_total_depth"] + 1)
    if not (tuple(den.shape) == (size, size, 3) and den.device.type == "cuda"
            and bool(torch.isfinite(den).all()) and float(den.mean()) > 0):
        fail("samples/04_denoising's image is not finite, black or not on "
             "the card")
    OUT_DIR.mkdir(exist_ok=True)
    write_tga(str(OUT_DIR / "04_denoising_noisy.tga"), noisy)
    write_tga(str(OUT_DIR / "04_denoising.tga"), den)
    print(f"samples/04_denoising {size}x{size}, {samples} samples: render + "
          f"pixels {(t1 - t0) * 1e3:.1f} ms ({(t1 - t0) / samples * 1e3:.2f} "
          f"ms a sample), denoise_image('nlm') + view transform "
          f"{(t2 - t1) * 1e3:.1f} ms; launch counts {counts}; wrote "
          f"04_denoising.tga [{CARD}]")
    # the same buffers on the CPU
    cpu = ray_tpu.Renderer(r.settings, r.pass_settings, device="cpu")
    for k in ray_tpu.Renderer._STATE_KEYS:
        setattr(cpu, k, getattr(r, k).cpu())
    rows = {}
    for mode in ("nlm", "unet"):
        g = r.denoise_image(mode).cpu().numpy()
        c = cpu.denoise_image(mode).numpy()
        rows[mode] = (np.isclose(g, c, rtol=1e-5, atol=1e-7).mean(),
                      float(np.abs(g - c).max()), float(np.abs(c).max()))
    nlm_share, nlm_max, _ = rows["nlm"]
    _, unet_max, unet_scale = rows["unet"]
    print(f"  denoise card vs cpu on those buffers: NLM {nlm_share:.6f} of "
          f"values within 1e-5 relative (max |diff| {nlm_max:.3e}); UNet max "
          f"|diff| {unet_max:.3e} of an output up to {unet_scale:.3f} "
          f"({unet_max / unet_scale:.2e}, bound {UNET_REL:g}; TF32 off)")
    if not (nlm_share >= 0.999 and unet_max <= UNET_REL * unet_scale):
        fail("the card's denoisers disagree with the CPU's")
    return counts


def denoise_timings(r):
    """NLM and UNet of a 1080p renderer's buffers: ms (mean of
    ``DENOISE_REPS`` after a warm-up) and the peak memory above what was
    allocated before."""
    import torch

    for mode in ("nlm", "unet"):
        r.denoise_image(mode)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(DENOISE_REPS):
            out = r.denoise_image(mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / DENOISE_REPS * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        if not (tuple(out.shape) == (HEIGHT, WIDTH, 3)
                and bool(torch.isfinite(out).all())):
            fail(f"denoise_image('{mode}') at 1080p is misshapen or not "
                 f"finite")
        print(f"denoise_image('{mode}') 1920x1080 on the cached flagship's "
              f"buffers: {ms:.1f} ms (mean of {DENOISE_REPS}), peak "
              f"{peak / 2**30:.3f} GiB above the resident "
              f"{base / 2**30:.3f} GiB [{CARD}]")


def accumulate_timing(args, label="an update pass's"):
    """radcache_accumulate on ``args``: the kernel (the wrapper's own
    launch, ``launch_sorted``, on the lanes ``sort_lanes`` ordered) beside
    ``index_add_`` x2 (the library call: the same sums in atomics' order),
    each timed back to back (``time_launches``, as every kernel of the
    ``kernels`` line: ``ms`` and ``library_ms``) and in one CUDA graph
    (``time_graph``: ``device_ms`` and ``library_device_ms``, since a
    launch of ~0.01 ms back to back times the host's issue rate), and the
    bound; the whole ``accumulate_segments`` call as the renderer makes it
    (checks and their host sync, key, sort, clones, kernel) beside the
    plain version, mask + ``index_add_`` x2, the whole library route
    (back to back)."""
    import torch

    from ray_tpu_torch.render import radcache

    rad_curr, cnt_curr, entry, rad, cnt, valid = args
    n_rows, R = rad_curr.shape[0], entry.shape[0]
    keys, order = radcache.sort_lanes(entry, valid, n_rows)
    rad_out, cnt_out = rad_curr.clone(), cnt_curr.clone()

    def kernel():
        radcache.launch_sorted(keys, order, rad, cnt, rad_out, cnt_out)

    idx = entry[valid]
    rv, cv = rad[valid], cnt[valid]

    def library():
        rad_out.index_add_(0, idx, rv)
        cnt_out.index_add_(0, idx, cv)

    n_valid = int(idx.numel())
    touched = int(torch.unique(idx).numel())
    bound = (ACC_BYTES_PER_LANE * n_valid + ACC_BYTES_PER_ENTRY * touched) / (
        PEAK_BYTES_PER_S) * 1e3
    row = dict(ms=time_launches(kernel, 50),
               device_ms=time_graph(kernel, 50),
               plain_ms=time_launches(
                   lambda: radcache.accumulate_plain(*args), 20),
               library_ms=time_launches(library, 50),
               library_device_ms=time_graph(library, 50), bound_ms=bound,
               whole_ms=time_launches(
                   lambda: radcache.accumulate_segments(*args), 20))
    print(f"radcache_accumulate on {label} {R} lanes ({n_valid} valid, "
          f"{touched} entries touched): kernel {row['ms']:.5f} ms back to "
          f"back, {row['device_ms']:.5f} ms in a graph; index_add_ x2 "
          f"{row['library_ms']:.5f} / {row['library_device_ms']:.5f} ms; "
          f"bound {bound:.5f} ms (bytes); the whole accumulate_segments "
          f"{row['whole_ms']:.5f} ms, the plain version (mask + index_add_ "
          f"x2) {row['plain_ms']:.5f} ms [{CARD}]")
    return row


# ---------------------------------------------------------------------------
# The lightmap baker, tile sharding on torch.distributed with the sharded
# train step, and the PMJ02 table mode
# ---------------------------------------------------------------------------
# the bakes: label -> (scene builder, kernel, triangle range, iterations).
# A finalized scene keeps its triangles in BVH leaf order.  The flagship's
# floor (its triangles 0-1) has its normals out of the box (make_quad's
# u x v is -Y there): its texels' rays start under it and see its unlit
# underside, so its lightmap is black in both packages.  The back wall
# (triangles 14-15) faces into the box.  cornell_sphere's sphere lies in
# two runs (0-330 and 344-366, the floor and the tall box between), and a
# bake takes one range: the longest, 330 of the sphere's 352 triangles
LIGHTMAP = {"flagship back wall": (flagship, "trace_brute", (14, 16), 16),
            "cornell_sphere sphere": (cornell_sphere, "trace_bvh", (0, 330),
                                      4)}
LIGHTMAP_SIZE = 1024
# the card-vs-CPU bake: texels a side, iterations
LIGHTMAP_CHECK = (64, 2)
# samples/02_multichip.py's main(): size, samples, depth
SAMPLE02 = (64, 4, 4)
# timed frames of each route of the sharded flagship
SHARDED_FRAMES = 2
SHARDED_KEYS = ("color", "base_color", "depth_normal")


def bake_settings(settings):
    """A bake's pass settings: the frame's depth, lighting only, SH-L1."""
    return dataclasses.replace(settings, lighting_only=True, output_sh=True)


def lightmap_bake(label, settings, errs):
    """One 1024x1024 bake of ``LIGHTMAP[label]`` through ``bake_lightmap``:
    the rasterizer's host seconds, every trace launch of one iteration
    bit-exact against the plain version, then the bake (6 + 6 launches an
    iteration, counted from 0 just before it): ms an iteration, Mray/s,
    peak memory, the SH L0 band against 0.282095 x color.  Returns the
    bake's launch counts."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render import integrator
    from ray_tpu_torch.render.lightmap import bake_lightmap, rasterize_uv_rays

    make, kernel, (lo, hi), iters = LIGHTMAP[label]
    st = bake_settings(settings)
    scene = make()[0].finalize()
    n = LIGHTMAP_SIZE
    t0 = time.perf_counter()
    rays, mask, _ = rasterize_uv_rays(scene.vertices, scene.normals,
                                      scene.uvs, scene.tri_vidx, n, n, lo, hi,
                                      device=scene.device)
    raster_s = time.perf_counter() - t0
    _, calls = capture(lambda: integrator.render_tile(
        scene, None, None, 0, 0, 1, 0, width=n, height=n, tile_w=n,
        tile_h=n, settings=st, use_filter_table=False, pixel_mask=mask,
        rays=rays))
    torch.cuda.synchronize()
    if len(calls) != 12 or any(c[0] != kernel for c in calls):
        fail(f"an iteration of the {label} bake made {[c[0] for c in calls]}"
             f", expected 12 {kernel} calls")
    for i, (k, args, any_hit) in enumerate(calls):
        check_parity(k, args, (any_hit,), f"{label} bake launch {i}", errs)
    del calls
    # the bake, the rays of its render_tile calls counted
    tally = []
    real = integrator.render_tile

    def counted(*args, **kw):
        out = real(*args, **kw)
        tally.append(out["rays_traced"])
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    integrator.render_tile = counted
    try:
        t0 = time.perf_counter()
        out = bake_lightmap(scene, n, n, st, iterations=iters, prim_lo=lo,
                            prim_hi=hi)
        wall = time.perf_counter() - t0
    finally:
        integrator.render_tile = real
    counts = dict(cuda_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check_counts(f"{label} bake", counts, kernel, iters)
    n_rays = sum(int(r) for r in tally)
    color, sh, covered = out["color"], out["shl1"], out["mask"]
    if not (color.shape == (n, n, 3) and sh.shape == (n, n, 4, 3)
            and np.isfinite(color).all() and np.isfinite(sh).all()
            and color[covered].mean() > 0.0):
        fail(f"the {label} bake is not finite, black or of the wrong shape")
    err = np.abs(sh[..., 0, :] - 0.282095 * color)
    bad = int((err > SH_ATOL + SH_RTOL * np.abs(0.282095 * color)).sum())
    print(f"lightmap {label} {n}x{n}, {iters} iterations, depth "
          f"{st.max_total_depth}, lighting only, SH-L1: {int(covered.sum())} "
          f"texels covered; rasterizer {raster_s:.3f} s (host); bake "
          f"{wall * 1e3:.1f} ms, {wall / iters * 1e3:.1f} ms an iteration, "
          f"{n_rays / wall / 1e6:.3f} Mray/s ({n_rays / iters:.0f} rays an "
          f"iteration); peak memory {peak / 2**30:.3f} GiB; SH L0 vs "
          f"0.282095 x color max |diff| {float(err.max()):.3e} ({bad} values "
          f"past rtol {SH_RTOL:g} / atol {SH_ATOL:g}); launch counts "
          f"{counts} [{CARD}]")
    if bad:
        fail(f"the {label} bake's SH L0 band disagrees with its color")
    return counts


def check_bake_against_cpu(label, settings):
    """A ``LIGHTMAP_CHECK`` bake of ``LIGHTMAP[label]`` on the card against
    the port's CPU bake: masks equal, ≥ 99% of the covered texels' color
    and SH within rtol 1e-3 (atol 1e-4), as the card-vs-CPU tiles."""
    import numpy as np

    from ray_tpu_torch.render.lightmap import bake_lightmap

    make, _, (lo, hi), _ = LIGHTMAP[label]
    n, iters = LIGHTMAP_CHECK
    g, c = (bake_lightmap(make()[0].finalize(device=dev), n, n,
                          bake_settings(settings), iterations=iters,
                          prim_lo=lo, prim_hi=hi) for dev in ("cuda", "cpu"))
    if not np.array_equal(g["mask"], c["mask"]):
        fail(f"the {label} bake's coverage differs between card and CPU")
    m = c["mask"]
    shares = {k: np.isclose(g[k], c[k], rtol=1e-3, atol=1e-4).reshape(
        n, n, -1).all(-1)[m].mean() for k in ("color", "shl1")}
    print(f"lightmap {label} {n}x{n}, {iters} iterations, card vs cpu: "
          f"{int(m.sum())} texels covered, color close "
          f"{shares['color']:.4f}, shl1 close {shares['shl1']:.4f}")
    if min(shares.values()) < 0.99:
        fail(f"the card's {label} bake disagrees with the CPU's")


def start_tile_mesh(tmp):
    """A 1-rank NCCL process group through a ``file://`` store in ``tmp``,
    and its tile mesh."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.shard import make_tile_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    return make_tile_mesh()


def sharded_frames(scene, cam, settings, mesh):
    """The flagship at 1920x1080 through ``render_sharded`` and
    ``render_sharded_balanced`` on the mesh, each bit-identical to
    ``render_tile``, then ``SHARDED_FRAMES`` timed frames of each route in
    turns, the launches counted from 0 just before the sharded ones.
    Returns those launch counts."""
    import torch

    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.parallel.shard import (
        render_sharded, render_sharded_balanced)

    def sharded(fn):
        return lambda it: fn(scene, cam, None, it, 0, mesh=mesh, width=WIDTH,
                             height=HEIGHT, settings=settings)

    routes = {"render_tile": lambda it: render(scene, cam, settings, it),
              "render_sharded": sharded(render_sharded),
              "render_sharded_balanced": sharded(render_sharded_balanced)}
    with torch.no_grad():
        ref = routes["render_tile"](1)
        for name in ("render_sharded", "render_sharded_balanced"):
            out = routes[name](1)
            for k in SHARDED_KEYS:
                if not same_bits(out[k].full_tensor(), ref[k]):
                    fail(f"{name}'s {k} differs from render_tile's")
            if int(out["rays_traced"]) != int(ref["rays_traced"]):
                fail(f"{name} traced {int(out['rays_traced'])} rays, "
                     f"render_tile {int(ref['rays_traced'])}")
        del out, ref
        ms = {k: [] for k in routes}
        counts = {}
        for f in range(SHARDED_FRAMES):
            for name, run in routes.items():
                torch.cuda.synchronize()
                if name != "render_tile":
                    cuda_build.reset_launch_counts()
                t0 = time.perf_counter()
                int(run(2 + f)["rays_traced"])   # synchronises
                ms[name].append((time.perf_counter() - t0) * 1e3)
                if name != "render_tile":
                    for k, v in cuda_build.launch_counts.items():
                        counts[k] = counts.get(k, 0) + v
    check_counts("sharded flagship", counts, "trace_brute",
                 2 * SHARDED_FRAMES)
    print(f"sharded flagship 1920x1080 1spp depth5 on a 1-rank NCCL mesh: "
          f"render_sharded and render_sharded_balanced bit-identical to "
          f"render_tile (color, base_color, depth_normal, rays_traced); "
          f"frame ms over {SHARDED_FRAMES} each, in turns: "
          + ", ".join(f"{k} {statistics.fmean(v):.1f}" for k, v in ms.items())
          + f"; launch counts {counts} [{CARD}]")
    return counts


def unsharded_step(scene, cam, params, target, settings):
    """The train step's loss and gradients through ``render_tile`` over the
    whole frame, written here apart from ``ray_tpu_torch.parallel.train``:
    ``mean((color - target)**2)`` w.r.t. the float material columns and
    ``env_col``."""
    import torch

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params["materials"].items()}
    env = params["env_col"].detach().clone().requires_grad_(True)
    sc = dataclasses.replace(scene, materials={**scene.materials, **leaves},
                             env_col=env)
    out = render(sc, cam, settings, 1)
    loss = torch.mean((out["color"] - target) ** 2)
    grads = torch.autograd.grad(loss, [*leaves.values(), env],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), {**dict(zip(leaves, grads)), "env_col": grads[-1]}


def sharded_train_step(scene, cam, mesh):
    """``ray_tpu_torch.parallel.train.train_step`` at 1920x1080 at the
    dry run's settings (depth 2, remat) on the mesh, against
    :func:`unsharded_step`: the loss bit-identical, gradients finite
    (base_color's and env_col's non-zero) and within ``REMAT_NOISE_MULT``
    times the largest gap between two of ``REMAT_NOISE_RUNS`` unsharded
    runs (``index_add_``'s atomics sum in any order), or 1e-4; the new
    parameters one SGD step from the old.  3 + 3 launches, none in
    backward.  Returns the step's launch counts."""
    import torch

    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.parallel.train import SGD_LR, params_of, train_step
    from ray_tpu_torch.render.integrator import PassSettings

    st = PassSettings(max_total_depth=2, min_total_depth=2, remat=True)
    target = torch.zeros((WIDTH * HEIGHT, 3), device="cuda")
    params = params_of(scene)
    kw = dict(mesh=mesh, width=WIDTH, height=HEIGHT, settings=st)
    train_step(scene, cam, params, target, **kw)   # warm-up
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads, new = train_step(scene, cam, params, target, **kw)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(cuda_build.launch_counts)
    check_counts("sharded train step", counts, "trace_brute", 1, 3)
    g = {**grads["materials"], "env_col": grads["env_col"]}
    check_grads("sharded train step", g)
    for k, p in params["materials"].items():
        if not torch.equal(new["materials"][k], p - SGD_LR * g[k]):
            fail(f"the sharded train step's new {k} is not one SGD step")
    runs, run_ms = [], []
    for _ in range(REMAT_NOISE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(unsharded_step(scene, cam, params, target, st))
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3)
    for loss_u, _ in runs:
        if not same_bits(loss, loss_u):
            fail(f"the sharded train step's loss {float(loss)!r} differs from "
                 f"the unsharded step's {float(loss_u)!r}")
    gaps = [grad_diff(runs[j][1], runs[i][1], "unsharded step again")
            for i in range(len(runs)) for j in range(i + 1, len(runs))]
    spread = grad_diff(g, runs[0][1], "sharded train step")
    limit = max(REMAT_NOISE_MULT * max(gaps), 1e-4)
    print(f"sharded train step 1920x1080 depth 2 remat on a 1-rank NCCL mesh: "
          f"{step_ms:.1f} ms (unsharded step {statistics.fmean(run_ms):.1f} "
          f"ms); loss bit-identical to the unsharded step's "
          f"({float(loss):.9e}); worst gradient column max |diff| / max |g| "
          f"{spread:.2e} (unsharded runs against each other: "
          f"{', '.join(f'{x:.2e}' for x in gaps)}; limit {limit:.2e}); "
          f"launch counts {counts} [{CARD}]")
    if spread > limit:
        fail(f"the sharded train step's gradients differ from the unsharded "
             f"step's by {spread:.3e} of a column's largest entry")
    return counts


def sample02(mesh):
    """``samples/02_multichip.py``'s ``main()`` on the port: the flagship
    at ``SAMPLE02``'s size, samples and depth through ``render_sharded`` on
    the mesh, the mean into ``OUT_DIR``; held bit-exact against the same
    samples of ``render_tile``, both timed.  Returns the sharded samples'
    launch counts."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.parallel.shard import render_sharded
    from ray_tpu_torch.render.integrator import PassSettings, render_tile
    from ray_tpu_torch.utils.image_io import write_tga

    size, samples, depth = SAMPLE02
    sc, cam = flagship()
    scene = sc.finalize()
    st = PassSettings(max_total_depth=depth)

    def sharded(it):
        return render_sharded(scene, cam, None, it, 0, mesh=mesh, width=size,
                              height=size, settings=st)["color"].full_tensor()

    def single(it):
        return render_tile(scene, cam, None, 0, 0, it, 0, width=size,
                           height=size, tile_w=size, tile_h=size, settings=st,
                           use_filter_table=False)["color"]

    res, counts = {}, {}
    with torch.no_grad():
        for name, fn in (("render_sharded", sharded), ("render_tile", single)):
            torch.cuda.synchronize()
            cuda_build.reset_launch_counts()
            t0 = time.perf_counter()
            acc = torch.zeros((size * size, 3), device="cuda")
            for it in range(1, samples + 1):
                acc = acc + fn(it)
            img = (acc / samples).reshape(size, size, 3).cpu().numpy()
            res[name] = (img, (time.perf_counter() - t0) / samples * 1e3)
            if name == "render_sharded":
                counts = dict(cuda_build.launch_counts)
    check_counts("samples/02_multichip", counts, "trace_brute", samples,
                 depth + 1)
    img = res["render_sharded"][0]
    if not (np.isfinite(img).all() and img.mean() > 0.0
            and np.array_equal(img, res["render_tile"][0])):
        fail("samples/02_multichip's image is not finite, black, or differs "
             "from render_tile's")
    OUT_DIR.mkdir(exist_ok=True)
    write_tga(str(OUT_DIR / "02_multichip.tga"), np.clip(img, 0, 1) ** (1 / 2.2))
    print(f"samples/02_multichip {size}x{size}, {samples} samples, depth "
          f"{depth}, render_sharded on a 1-rank NCCL mesh: "
          f"{res['render_sharded'][1]:.2f} ms a sample (render_tile "
          f"{res['render_tile'][1]:.2f}), the image bit-identical to "
          f"render_tile's; wrote 02_multichip.tga [{CARD}]")
    return counts


def rng_table_draw():
    """One ``scrambled_2d_rand(table=True)`` draw over a frame's lanes on
    the card, bit-exact against the CPU's, timed beside the computed
    mode's."""
    import torch

    from ray_tpu_torch.ops import rng

    seed = torch.arange(WIDTH * HEIGHT, device="cuda", dtype=torch.int64)
    card = rng.scrambled_2d_rand(7, seed, 0, table=True)
    cpu = rng.scrambled_2d_rand(7, seed.cpu(), 0, table=True)
    if not all(same_bits(a.cpu(), b) for a, b in zip(card, cpu)):
        fail("the PMJ02 table draw differs between card and CPU")
    table_ms = time_launches(
        lambda: rng.scrambled_2d_rand(7, seed, 0, table=True), 10)
    computed_ms = time_launches(lambda: rng.scrambled_2d_rand(7, seed, 0), 10)
    print(f"rng table mode: one scrambled_2d_rand(table=True) over "
          f"{WIDTH * HEIGHT} lanes {table_ms:.3f} ms (computed mode "
          f"{computed_ms:.3f} ms), bit-exact against the CPU [{CARD}]")


def add_launches(launches, counts):
    """Add a path's trace launch counts into the kernels line's."""
    for kernel in ("trace_brute", "trace_bvh"):
        for mode in ("closest", "anyhit"):
            key = f"{kernel}_{mode}"
            launches[key] = launches.get(key, 0) + counts.get(key, 0)


def phase(name: str, t_start: float) -> None:
    """Mark where a phase starts, in seconds since the script began."""
    print(f"[{time.perf_counter() - t_start:.1f} s] {name}")


def main() -> int:
    global CARD
    import torch
    import torch.distributed as dist

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    try:
        from ray_tpu_torch.ops import cuda_build
        from ray_tpu_torch.render.integrator import PassSettings
    except ImportError as e:
        fail(f"cannot import ray_tpu_torch ({e}): run from the repository root")

    CARD = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {CARD}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # ---- build: one nvcc per kernel, all at once ----------------------
    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    for k in SOURCES:
        cuda_build.load(k)
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.3f} s")
    # the colonnade's SBVH finalize (a minute of numpy) runs beside the
    # card's phases, in a worker process
    worker = start_sbvh_worker()

    device = torch.device("cuda")
    settings = PassSettings(max_total_depth=5, min_total_depth=2)
    # bench.py's big-scene settings, without remat (a forward pass)
    settings_big = dataclasses.replace(settings, compact_after=2,
                                       compact_factor=4)
    # ... and with it: bench.py's settings_big of the colonnade's fwd+bwd
    settings_remat = dataclasses.replace(settings_big, remat=True)

    phase("kernel parity", t_start)
    # ---- the gather probe: bit-exact on its inputs and a frame's ------
    gathers = gather_cases(device)
    check_gather(gathers)
    # ---- the RNG: every draw form over a frame's lanes ----------------
    check_rng(WIDTH * HEIGHT, device)
    # ---- kernel parity on the generator scenes ------------------------
    errs = {}
    for kernel, sizes in (("trace_brute", (8, 24, 40)),
                          ("trace_bvh", (100, 300, 500))):
        for n_tris in sizes:
            case = generator_case(kernel, n_tris, 2_000_000, 1000 + n_tris,
                                  device)
            check_parity(kernel, case, (False, True),
                         f"generator {n_tris} tris", errs)
            del case
    # the largest tables trace_bvh takes: 512 triangles in leaves of one,
    # 511 node rows
    case = generator_case("trace_bvh", 512, 2_000_000, 1512, device, 1)
    check_parity("trace_bvh", case, (False, True),
                 f"generator 512 tris, {case[0].shape[0]} nodes", errs)
    del case
    for label, spec in TLAS_CASES.items():
        case = generator_case("trace_tlas", spec, 2_000_000, 7, device)
        print(f"  generator {label}: wrows_tlas {tuple(case[0].shape)}, stack "
              f"{case[-1]}")
        check_parity("trace_tlas", case, (False, True), f"generator {label}",
                     errs)
        if label == "64 instances":
            # a ray mask: half the rays see no instance (bit 5 is no ray type)
            R = case[2].shape[0]
            mask = torch.where(torch.arange(R, device=device) % 2 == 0,
                               0x7fffffff, 1 << 5).to(torch.int32)
            check_parity("trace_tlas", case[:7] + (mask,) + case[8:],
                         (False,), f"generator {label} with a ray mask", errs)
        del case
    for n_tris in BINNED_CLOUDS:
        # tests/test_traverse_pallas.py's clouds (seed 7)
        case = generator_case("trace_binned", n_tris, 300_000, 7, device)
        _, S = binned_arrays(case[0])
        print(f"  generator binned {n_tris} tris: {S} subtrees, stack "
              f"{case[0]['stack_arr'].shape[0]}")
        check_sort_key(case, f"generator {n_tris} tris", errs)
        check_parity("trace_binned", case, (False, True),
                     f"generator {n_tris} tris", errs)
        del case
    # exactness under stress: ties, rays inside boxes, NaN and zero
    # direction components, t_min > 0, stack overflow, both table widths
    for label, (kernel, case) in stress_cases(STRESS_RAYS, device).items():
        if kernel == "trace_binned":
            check_sort_key(case, label, errs)
        check_parity(kernel, case, (False, True), label, errs)
    # the traversal slice: the binary two-level walk, the masked walks and
    # trace_tlas's padded rows, at a 1080p frame's lane count
    for label, (kernel, case) in slice_generator_cases(WIDTH * HEIGHT,
                                                       device).items():
        check_parity(kernel, case, (False, True), label, errs)
    del case

    phase("the scenes", t_start)
    # ---- the scenes; a warm-up frame (a colonnade tile) captures every
    # kernel input ------------------------------------------------------
    scenes = {}
    for label, make, kernel, st, grid in (
            ("flagship", flagship, "trace_brute", settings, (1, 1)),
            ("cornell_sphere", cornell_sphere, "trace_bvh", settings, (1, 1)),
            ("colonnade", colonnade, "trace_tlas", settings_big, GRID),
            ("colonnade flatten", colonnade, "trace_tlas", settings_big, GRID),
            ("colonnade binned", colonnade_binned, "trace_binned",
             settings_big, GRID)):
        sc, cam = make()
        t_fin = time.perf_counter()
        scene = sc.finalize(**FINALIZE.get(label, {}))
        t_fin = time.perf_counter() - t_fin
        if scene.device.type != "cuda":
            fail(f"finalize() put the scene on {scene.device}, not CUDA")
        soa = scene.bvh_soa
        rows = soa.get("wrows_tlas")
        tables = ""
        if rows is not None:
            tables = (f", wrows_tlas {tuple(rows.shape)}, "
                      f"{scene.inst['vis'].shape[0]} instances")
        elif "wrows" in soa:
            tables = f", wrows {tuple(soa['wrows'].shape)}"
        if "binned_slab_f" in soa:
            tables += (f", {soa['binned_slab_i'].shape[0] // 16} binned "
                       f"subtrees ({sum(soa[k].numel() * soa[k].element_size() for k in soa if k.startswith('binned_')) / 1e6:.1f} MB), binned "
                       f"stack {soa['binned_stack_arr'].shape[0]}")
        print(f"scene {label}: mode {scene.mode}, {scene.num_tris} unique "
              f"tris, {soa['code0'].shape[0]} BVH2 nodes{tables}, stack "
              f"{scene.stack_size}, {scene.num_lights} lights, light tree "
              f"depth {scene.light_tree_depth}; finalize {t_fin:.3f} s")
        # the top-right tile: on the colonnade (sky in its upper half)
        # under a quarter of the lanes live on past bounce 2, so the last 8
        # launches run compacted
        tw, th = WIDTH // grid[0], HEIGHT // grid[1]
        x0, y0 = WIDTH - tw, 0
        _, calls = capture_frame(scene, cam, st, 1, x0, y0, tw, th)
        torch.cuda.synchronize()
        if len(calls) != 12 or any(c[0] != kernel for c in calls):
            fail(f"a {label} tile made {[c[0] for c in calls]}, expected 12 "
                 f"{kernel} calls")
        n_compact = sum(c[1][2].shape[0] < tw * th for c in calls)
        print(f"  {label} tile at ({x0}, {y0}): {n_compact} of 12 launches "
              f"compacted")
        if label == "colonnade" and not n_compact:
            fail(f"no {label} launch ran compacted")
        for i, (k, args, any_hit) in enumerate(calls):
            if k == "trace_binned":
                check_sort_key(args, f"{label} launch {i}", errs)
            check_parity(k, args, (any_hit,), f"{label} launch {i}", errs)
        scenes[label] = (scene, cam, kernel, calls, st, grid)
    # the shading slice's scenes: every launch of one 1080p frame, the
    # alpha box's march traces included
    shading = {}
    for name, kernel in SHADING.items():
        sc, cam = shading_scene(name)
        scene = sc.finalize()
        shading[name] = (scene, cam, kernel)
        soa = scene.bvh_soa
        print(f"scene {name}: {scene.num_tris} tris, {soa['code0'].shape[0]} "
              f"BVH2 nodes{', wrows ' + str(tuple(soa['wrows'].shape)) if 'wrows' in soa else ''}, "
              f"{scene.num_lights} lights {sorted({k for k, *_ in scene.light_kinds})}, "
              f"node types {scene.mat_types}, transparency "
              f"{scene.has_transparency}, light tree depth "
              f"{scene.light_tree_depth}")
        if name not in SHADING_PARITY:
            continue
        _, calls = capture_frame(scene, cam, settings, 1)
        torch.cuda.synchronize()
        if any(c[0] != kernel for c in calls):
            fail(f"a {name} frame made {[c[0] for c in calls]}, expected "
                 f"{kernel} calls only")
        print(f"  {name} frame: {len(calls)} {kernel} launches "
              f"({sum(c[2] for c in calls)} any-hit)")
        for i, (k, args, any_hit) in enumerate(calls):
            check_parity(k, args, (any_hit,), f"{name} launch {i}", errs)
        del calls
    # the traversal slice's scenes: every launch of one 1080p frame
    slices = slice_scenes(settings, errs)
    # the sky and texture slice's scenes: likewise
    skies, sky_s = sky_scenes(settings, errs)
    # the cache and denoising slice: the SBVH scenes' frames, every launch;
    # radcache_accumulate on forced collisions
    sbvhs = sbvh_scenes(worker, settings, settings_big, errs)
    check_collisions(errs)
    check_accumulate_stress(errs)

    phase("card vs CPU tiles", t_start)
    # ---- small tiles: card vs the port's plain CPU path ---------------
    check_tile_against_cpu(flagship, "flagship", 928, 516, settings)
    check_tile_against_cpu(cornell_sphere, "cornell_sphere", 900, 840, settings)
    n_col, n_ter, n_floor = colonnade_coverage(*scenes["colonnade"][:2],
                                               912, 500, 64, 48)
    print(f"colonnade tile 64x48 at (912, 500): primary hits on columns "
          f"{n_col}, terrain {n_ter}, floor {n_floor}")
    if not (n_col > 0 and n_ter + n_floor > 0):
        fail("the colonnade tile does not cover columns and terrain or floor")
    check_tile_against_cpu(colonnade, "colonnade", 912, 500, settings_big)
    check_tile_against_cpu(colonnade, "colonnade flatten", 912, 500,
                           settings_big)
    check_tile_against_cpu(colonnade_binned, "colonnade binned", 912, 500,
                           settings_big)
    for name, (x0, y0) in SHADING_TILES.items():
        check_tile_against_cpu(lambda n=name: shading_scene(n), name, x0, y0,
                               settings)
    check_tile_against_cpu(lambda: shading_scene("alpha_box", ALPHA_LIFT),
                           "alpha_box lifted 2 mm", *SHADING_TILES["alpha_box"],
                           settings)
    for label, (x0, y0) in SLICE_TILES.items():
        check_tile_against_cpu(lambda lb=label: slice_scene(lb), label, x0,
                               y0, settings)
    for label, (x0, y0) in SKY_TILES.items():
        check_tile_against_cpu(lambda lb=label: sky_scene(lb), label, x0,
                               y0, sky_settings(settings, label))
    check_sky_bake_against_cpu()
    for label, (scene, cam, _, _, st, cpu_scene) in sbvhs.items():
        x0, y0 = SBVH[label][3]
        if cpu_scene is None:   # cornell_sphere: finalized on each device
            check_tile_against_cpu(cornell_sphere, label, x0, y0, st)
        else:                   # the colonnade: the worker's, loaded twice
            compare_tiles(label, scene, cpu_scene, cam, x0, y0, st)

    phase("forward paths", t_start)
    # ---- the forward main paths ---------------------------------------
    launches, frame_ms = {}, {}
    for label, (scene, cam, kernel, _, st, grid) in scenes.items():
        counts, frame_ms[label] = forward_path(
            label, scene, cam, st, kernel, grid,
            FRAMES if grid == (1, 1) else COLONNADE_FRAMES)
        for mode in ("closest", "anyhit"):
            name = f"{kernel}_{mode}"
            launches[name] = launches.get(name, 0) + counts[name]
        if kernel == "trace_binned":
            # one sort key a trace_binned launch (sort_rays)
            n_key = counts.get("trace_binned_sortkey", 0)
            if n_key != counts["trace_binned_closest"] + counts[
                    "trace_binned_anyhit"]:
                fail(f"{label}: {n_key} sort-key launches for "
                     f"{counts['trace_binned_closest']} + "
                     f"{counts['trace_binned_anyhit']} trace_binned launches")
            launches["trace_binned_sortkey"] = n_key
    scene, cam = scenes["colonnade"][:2]
    # each tile issues the whole op sequence: the 2x2 frame pays host
    # dispatch four times; the 1x1 frame shows what that costs
    forward_path("colonnade", scene, cam, settings_big, "trace_tlas", (1, 1),
                 FRAMES_1X1)
    for name, (scene, cam, kernel) in shading.items():
        counts, frame_ms[name], _ = shading_forward(name, scene, cam,
                                                    settings, kernel)
        for mode in ("closest", "anyhit"):
            key = f"{kernel}_{mode}"
            launches[key] = launches.get(key, 0) + counts.get(key, 0)
    for label, (scene, cam, kernel, _) in slices.items():
        counts, frame_ms[label] = forward_path(label, scene, cam, settings,
                                               kernel, frames=SLICE[label][3])
        for mode in ("closest", "anyhit"):
            key = f"{kernel}_{mode}"
            launches[key] = launches.get(key, 0) + counts[key]
    tlas_against_flatten(scenes["flagship"][0], slices["cornell_tlas"][0],
                         scenes["flagship"][1], settings)
    for label, (scene, cam, kernel, _) in skies.items():
        counts, frame_ms[label] = forward_path(
            label, scene, cam, sky_settings(settings, label), kernel,
            frames=SKY_FRAMES)
        for mode in ("closest", "anyhit"):
            key = f"{kernel}_{mode}"
            launches[key] = launches.get(key, 0) + counts[key]
    check_sh(*skies["flagship output_sh"][:2],
             sky_settings(settings, "flagship output_sh"))
    counts = sample05()
    for mode in ("closest", "anyhit"):
        launches[f"trace_brute_{mode}"] += counts[f"trace_brute_{mode}"]
    for label, (scene, cam, kernel, grid, st, _) in sbvhs.items():
        counts, frame_ms[label] = forward_path(label, scene, cam, st, kernel,
                                               grid, SBVH_FRAMES)
        for mode in ("closest", "anyhit"):
            key = f"{kernel}_{mode}"
            launches[key] = launches.get(key, 0) + counts[key]

    phase("goldens", t_start)
    golden_gate()

    phase("fwd+bwd", t_start)
    # ---- fwd+bwd --------------------------------------------------------
    bwd_ms = {}
    for label in ("flagship", "cornell_sphere"):
        scene, cam, kernel, _, st, _ = scenes[label]
        bwd_ms[label] = fwd_bwd_path(label, scene, cam, st, kernel)
    check_grad_tile_against_cpu(cornell_sphere, "cornell_sphere", 900, 840,
                                settings)
    check_remat_against_stored(*scenes["flagship"][:2], settings)
    for name, grid in SHADING_BWD.items():
        scene, cam, kernel = shading[name]
        shading_fwd_bwd(name, scene, cam, settings, kernel, grid)
    for label, grid in SLICE_BWD.items():
        scene, cam, kernel, _ = slices[label]
        bwd_ms[label] = fwd_bwd_path(label, scene, cam, settings, kernel,
                                     grid, SLICE_BWD_FRAMES)
        check_grad_tile_against_cpu(lambda lb=label: slice_scene(lb), label,
                                    *SLICE_TILES[label], settings)
    for label, grid in SKY_BWD.items():
        scene, cam, kernel, _ = skies[label]
        bwd_ms[label] = fwd_bwd_path(label, scene, cam, settings, kernel,
                                     grid, SKY_BWD_FRAMES)
        check_grad_tile_against_cpu(lambda lb=label: sky_scene(lb), label,
                                    *SKY_TILES[label], settings)

    phase("colonnade fwd+bwd", t_start)
    # ---- the colonnade's fwd+bwd frame: bench.py's settings_big (remat),
    # 2x2 tiles, each its own backward -----------------------------------
    scene, cam = scenes["colonnade"][:2]
    bwd_ms["colonnade"] = fwd_bwd_path("colonnade", scene, cam,
                                       settings_remat, "trace_tlas", GRID,
                                       COLONNADE_BWD_FRAMES)
    remat_trace_counts(scene, cam, settings_remat, "trace_tlas")
    # stored residuals: ~18.6 GB a 960x540 tile predicted
    # (tools/remat_saved_bytes.py), so it fits beside remat on one card
    fwd_bwd_path("colonnade", scene, cam, settings_big, "trace_tlas", GRID,
                 COLONNADE_BWD_FRAMES)
    check_grad_tile_against_cpu(colonnade, "colonnade", 912, 500,
                                settings_remat)

    phase("renderer", t_start)
    # ---- the user's entry point: create_renderer -> render -> pixels ---
    renderer_path(settings)
    check_renderer_against_cpu(settings)
    quickstart()

    phase("cache and denoising", t_start)
    cached, counts, acc_args = cached_renderer(settings, errs)
    acc_launches = counts["radcache_accumulate"]
    for mode in ("closest", "anyhit"):
        launches[f"trace_brute_{mode}"] += counts[f"trace_brute_{mode}"]
    check_cached_renderer_against_cpu(settings)
    counts = sample04()
    for mode in ("closest", "anyhit"):
        launches[f"trace_brute_{mode}"] += counts[f"trace_brute_{mode}"]
    denoise_timings(cached)
    del cached

    phase("lightmap, sharding, table RNG", t_start)
    for label in LIGHTMAP:
        add_launches(launches, lightmap_bake(label, settings, errs))
        check_bake_against_cpu(label, settings)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = start_tile_mesh(tmp)
        try:
            flag = scenes["flagship"]
            add_launches(launches, sharded_frames(flag[0], flag[1], settings,
                                                  mesh))
            add_launches(launches, sharded_train_step(flag[0], flag[1], mesh))
            add_launches(launches, sample02(mesh))
        finally:
            dist.destroy_process_group()
    rng_table_draw()

    phase("sky bake", t_start)
    sky_bake_timings(sky_s)

    phase("profiles", t_start)
    flag = scenes["flagship"]

    def colonnade_tile(label):
        # one 960x540 tile, the top-right one, against a quarter of the
        # unprofiled 2x2 frame: a profiled 2x2 frame cost ~2 minutes of the
        # script; the flattened one's wide route is the instanced one's walk
        scene, cam = scenes[label][:2]
        tw, th = WIDTH // GRID[0], HEIGHT // GRID[1]
        return (f"forward {label} tile {tw}x{th}", frame_ms[label] / 4,
                lambda: render(scene, cam, settings_big, 99, WIDTH - tw, 0,
                               tw, th))

    profile_frames((
        ("forward flagship", frame_ms["flagship"],
         lambda: render_frame(flag[0], flag[1], settings, 99, (1, 1))),
        ("fwd+bwd flagship", bwd_ms["flagship"],
         lambda: fwd_bwd(flag[0], flag[1], settings, 99)),
        *(colonnade_tile(label) for label in
          ("colonnade", "colonnade binned")),
    ))
    rng_row = rng_cost(flag[0], flag[1], settings)

    phase("kernel timing", t_start)
    gather_rows = gather_timings(gathers)
    # ---- kernel timing at each frame's (tile's) launch shapes ----------
    for label in scenes:
        print(f"kernel timing, {label}:")
        rows = kernel_timings(scenes[label][3])
        for r in rows:
            plain = ("-" if r["plain_ms"] is None
                     else f"{r['plain_ms']:.3f} ms")
            print(f"  {r['kernel']} {'anyhit ' if r['any_hit'] else 'closest'} "
                  f"active {r['active']:>8}/{r['rays']} node steps "
                  f"{r['node_steps']:>10} inst entries {r['inst_entries']:>8} "
                  f"subtrees walked {r['box_tests']:>9} tests {r['tests']:>10}: "
                  f"kernel {r['ms']:.4f} ms, plain {plain}, bound "
                  f"{max(r['bytes_ms'], r['ops_ms']):.4f} ms "
                  f"(bytes {r['bytes_ms']:.4f}, ops {r['ops_ms']:.4f})")
        scenes[label] = scenes[label] + (rows,)
    scene, _, _, calls = scenes["colonnade binned"][:4]
    wide = wide_route_timings(scene, calls)
    for (ms, n_diff, n_prim), (_, args, any_hit), r in zip(
            wide, calls, scenes["colonnade binned"][-1]):
        print(f"  wide route (trace_tlas over wrows) on the binned tile's "
              f"{'anyhit ' if any_hit else 'closest'} launch of "
              f"{args[1].shape[0]} rays: {ms:.4f} ms against trace_binned "
              f"{r['ms']:.4f} ms; hits differ on {n_diff} lanes, prim on "
              f"{n_prim}")
    for any_hit in (False, True):
        sel = [(w[0], r["ms"]) for w, c, r in zip(
            wide, calls, scenes["colonnade binned"][-1]) if c[2] == any_hit]
        print(f"binned tile {'anyhit' if any_hit else 'closest'}: wide route "
              f"{statistics.fmean(w for w, _ in sel):.4f} ms, trace_binned "
              f"{statistics.fmean(b for _, b in sel):.4f} ms a launch (mean "
              f"of {len(sel)}) [{CARD}]")
    key_rows = sortkey_timings(calls)
    for r in key_rows:
        plain = "-" if r["plain_ms"] is None else f"{r['plain_ms']:.3f} ms"
        print(f"  trace_binned_sortkey for the {'anyhit ' if r['any_hit'] else 'closest'} "
              f"launch, active {r['active']:>8}/{r['rays']}: kernel "
              f"{r['ms']:.4f} ms, plain {plain}, bound {r['bytes_ms']:.4f} "
              f"ms (bytes)")
    print(f"binned tile sort key: {statistics.fmean(r['ms'] for r in key_rows):.4f} "
          f"ms a launch (mean of {len(key_rows)}) [{CARD}]")
    rows = [r for label in scenes for r in scenes[label][-1]]
    kernels = []
    for label in SLICE_TIMED:
        print(f"kernel timing, {label}:")
        slice_rows = kernel_timings(slices[label][3])
        for r in slice_rows:
            print(f"  {r['kernel']} {'anyhit ' if r['any_hit'] else 'closest'} "
                  f"active {r['active']:>8}/{r['rays']} node steps "
                  f"{r['node_steps']:>10} inst entries {r['inst_entries']:>8} "
                  f"tests {r['tests']:>10}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, bound "
                  f"{max(r['bytes_ms'], r['ops_ms']):.4f} ms (bytes "
                  f"{r['bytes_ms']:.4f}, ops {r['ops_ms']:.4f})")
        rows += slice_rows
        if label != "cornell_tlas":
            masked_vs_unmasked(label, slices[label][3])
    for kernel, info in KERNELS.items():
        for mode, any_hit in (("closest", False), ("anyhit", True)):
            name = f"{kernel}_{mode}"
            rs = [r for r in rows
                  if r["kernel"] == kernel and r["any_hit"] == any_hit]
            # mean over the frame's launches of each launch's own bound
            b_ms = statistics.fmean(r["bytes_ms"] for r in rs)
            o_ms = statistics.fmean(r["ops_ms"] for r in rs)
            kernels.append({
                "name": name, "route": "cuda", "source": info["source"],
                "replaces": info["replaces"], "launches": launches[name],
                "max_abs_err": errs[name],
                "ms": statistics.fmean(r["ms"] for r in rs),
                "plain_ms": statistics.fmean(
                    r["plain_ms"] for r in rs if r["plain_ms"] is not None),
                "bound_ms": statistics.fmean(
                    max(r["bytes_ms"], r["ops_ms"]) for r in rs),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "library_ms": None,
            })
    kernels.append({
        "name": "trace_binned_sortkey", "route": "cuda", **SORTKEY,
        "launches": launches["trace_binned_sortkey"],
        "max_abs_err": errs["trace_binned_sortkey"],
        "ms": statistics.fmean(r["ms"] for r in key_rows),
        "plain_ms": statistics.fmean(
            r["plain_ms"] for r in key_rows if r["plain_ms"] is not None),
        "bound_ms": statistics.fmean(r["bytes_ms"] for r in key_rows),
        "bound_by": "bytes", "library_ms": None,
    })
    acc = accumulate_timing(acc_args)
    kernels.append({
        "name": "radcache_accumulate", "route": "cuda", **ACCUMULATE,
        "launches": acc_launches, "max_abs_err": errs["radcache_accumulate"],
        "ms": acc["ms"], "plain_ms": acc["plain_ms"],
        "bound_ms": acc["bound_ms"], "bound_by": "bytes",
        "library_ms": acc["library_ms"],
        # the same two launches in one CUDA graph: device time
        "device_ms": acc["device_ms"],
        "library_device_ms": acc["library_device_ms"],
    })
    g = gather_rows["frame 2,073,600 lanes"]
    kernels.append({
        "name": "gather_table", "route": "cuda", **GATHER,
        # on no path of the system: a compiler probe, held and timed here
        "launches": 0, "max_abs_err": 0.0, "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": "bytes", "library_ms": g["library_ms"],
    })
    kernels.append({
        "name": "rng_draw", "route": "cuda", **RNG,
        "launches": rng_row["launches"], "max_abs_err": 0.0,
        "ms": rng_row["ms"], "device_ms": rng_row["device_ms"],
        "plain_ms": rng_row["plain_ms"], "bound_ms": rng_row["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
    })
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


CARD = ""

if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--golden":
        sys.exit(golden_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--sbvh-scene":
        sys.exit(sbvh_worker(sys.argv[2]))
    sys.exit(main())
