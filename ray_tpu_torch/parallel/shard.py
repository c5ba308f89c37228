"""Multi-device rendering: image bands sharded over ``torch.distributed``
ranks.

The port of ``ray_tpu.parallel.shard``, with ``shard_map`` over a JAX mesh
mapped onto one process per device.  The caller starts the process group
(``torchrun``, or ``torch.distributed.init_process_group`` with its
address, world size and rank); :func:`make_tile_mesh` lays a 1-D
``DeviceMesh`` named ``TILE_AXIS`` over its ranks (NCCL on CUDA, gloo on
the CPU).  Rank r of the mesh renders horizontal band r of the frame with
the scene replicated, as ``ray_tpu``'s ``in_specs=P()`` does:

* ``color``, ``base_color`` and ``depth_normal`` come back as full-frame
  ``(H*W, C)`` ``DTensor``\\ s sharded by rows (``Shard(0)``, the
  counterpart of ``out_specs=P(TILE_AXIS)``); ``rays_traced`` is
  all-reduced (``psum``).
* Gradients: every scene tensor that requires grad enters through one
  autograd function that is the identity forward and all-reduces (sums)
  its gradients backward, so ``torch.autograd.grad`` of a loss on the
  output gives every rank the full frame's gradient w.r.t. the replicated
  scene, as ``jax.grad`` through ``shard_map`` does.  The same function
  hands out a -0.0 that is added to each output (which changes no bit):
  every rank whose loss reads an output thus reaches the all-reduce in
  backward, even where its band reads none of the parameters.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.render.raygen import PrimaryRays, generate_primary_rays
from ray_tpu_torch.utils.device import resolve_device

TILE_AXIS = "tiles"

# the process group backend each device type's mesh needs
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_tile_mesh(devices=None, *, device=None) -> DeviceMesh:
    """A 1-D ``DeviceMesh`` named ``TILE_AXIS`` over the ranks of the
    process group the caller started: ``devices`` lists them in band order
    (default: every rank).  ``device`` is the device type the ranks render
    on, CUDA unless named; CUDA needs an NCCL group, the CPU a gloo one.
    Raises without an initialised process group: it never starts one."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_tile_mesh needs a torch.distributed process group: start "
            "one first (torchrun, or init_process_group with its address, "
            "world size and rank)")
    kind = resolve_device(device).type
    backend = str(dist.get_backend())
    if _BACKENDS.get(kind) not in backend:
        raise RuntimeError(f"a {kind} tile mesh needs a {_BACKENDS.get(kind)} "
                           f"process group, and this one is {backend}")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    return DeviceMesh(kind, ranks, mesh_dim_names=(TILE_AXIS,))


def _bands(mesh: DeviceMesh, height: int):
    """(ranks, this rank's band, band height); ``height`` must divide."""
    n = mesh.size()
    if height % n:
        raise AssertionError(f"height {height} must divide over {n} devices")
    return n, mesh.get_local_rank(TILE_AXIS), height // n


class _Replicated(torch.autograd.Function):
    """Identity on (anchor, *params) forward; backward, the params'
    gradients summed over the group's ranks in one all-reduce."""

    @staticmethod
    def forward(ctx, group, anchor, *params):
        ctx.group = group
        return (anchor.clone(), *(p.view_as(p) for p in params))

    @staticmethod
    def backward(ctx, _g_anchor, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        return (None, None, *out)


def _replicate(scene, mesh: DeviceMesh):
    """(scene, anchor): the scene with each tensor that requires grad (a
    field, or a value of a dict field) passed through :class:`_Replicated`,
    and its -0.0 anchor; (scene, None) when nothing requires grad."""
    if not torch.is_grad_enabled():
        return scene, None
    where = []
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor) and v.requires_grad:
            where.append((f.name, None, v))
        elif isinstance(v, dict):
            where += [(f.name, k, t) for k, t in v.items()
                      if isinstance(t, torch.Tensor) and t.requires_grad]
    if not where:
        return scene, None
    anchor = torch.full((), -0.0, dtype=torch.float32, device=scene.device)
    anchor, *outs = _Replicated.apply(mesh.get_group(), anchor,
                                      *(t for _, _, t in where))
    fields = {}
    for (name, key, _), t in zip(where, outs):
        if key is None:
            fields[name] = t
        else:
            fields.setdefault(name, dict(getattr(scene, name)))[key] = t
    return dataclasses.replace(scene, **fields), anchor


def _all_to_all(x, group):
    """All-to-all of equal row chunks: rank d's chunk j goes to rank j's
    chunk d, so the exchange is its own inverse."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _Exchange(torch.autograd.Function):
    """:func:`_all_to_all`, differentiable: its backward is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _frame(out, mesh: DeviceMesh, anchor, exchange=False):
    """The outputs of a band as row-sharded full-frame DTensors (after the
    all-to-all that sends the balanced route's lanes home, with
    ``exchange``) and the all-reduced ray count."""
    res = {}
    for key in ("color", "base_color", "depth_normal"):
        x = out[key]
        if exchange:
            x = _Exchange.apply(x, mesh.get_group())
        if anchor is not None:
            x = x + anchor
        res[key] = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
    rays = out["rays_traced"].clone()
    dist.all_reduce(rays, group=mesh.get_group())
    res["rays_traced"] = rays
    return res


def render_sharded(
    scene,
    cam,
    filter_table,
    iteration,
    rand_seed,
    *,
    mesh: DeviceMesh,
    width: int,
    height: int,
    settings: PassSettings,
    use_filter_table: bool = False,
):
    """Render one full-frame sample with rows sharded over the mesh: this
    rank renders its band with ``render_tile``.  Returns 'color' (H*W, 3),
    'base_color' (H*W, 3) and 'depth_normal' (H*W, 4) as DTensors sharded
    by rows, and 'rays_traced', the frame's total, on every rank."""
    _, band, band_h = _bands(mesh, height)
    scene, anchor = _replicate(scene, mesh)
    out = render_tile(
        scene, cam, filter_table, 0, band * band_h, iteration, rand_seed,
        width=width, height=height, tile_w=width, tile_h=band_h,
        settings=settings, use_filter_table=use_filter_table,
    )
    return _frame(out, mesh, anchor)


def render_sharded_balanced(
    scene,
    cam,
    filter_table,
    iteration,
    rand_seed,
    *,
    mesh: DeviceMesh,
    width: int,
    height: int,
    settings: PassSettings,
    use_filter_table: bool = False,
):
    """Band-sharded rendering with the rays re-balanced across ranks.

    Plain bands make every rank pay its own band's worst rays: a band of
    sky finishes in a few trips while a band of deep geometry walks many,
    and the frame takes as long as the worst band.  Here each rank
    generates its band's primary rays, and one all-to-all of each per-lane
    field hands rank d the d-th slice of every band (``cone_spread`` stays
    replicated), so each rank's depth distribution is the frame's mix.  A
    lane carries its pixel, hence its RNG seed, so the estimator is
    unchanged; the same exchange of ``color``, ``base_color`` and
    ``depth_normal`` (it is its own inverse) returns each result to its
    band.  Bit-exact against :func:`render_sharded`: lanes only move
    between ranks.  Returns what :func:`render_sharded` returns."""
    n, band, band_h = _bands(mesh, height)
    lanes = band_h * width
    if lanes % n:
        raise AssertionError(
            f"per-band lane count {lanes} must divide over {n} devices")
    group = mesh.get_group()
    scene, anchor = _replicate(scene, mesh)
    rays = generate_primary_rays(
        cam, filter_table, 0, band * band_h, iteration, rand_seed,
        width=width, height=height, tile_w=width, tile_h=band_h,
        use_filter_table=use_filter_table, device=scene.device,
    )
    rays = PrimaryRays(*(x if x.dim() == 0 else _Exchange.apply(x, group)
                         for x in rays))
    out = render_tile(
        scene, cam, filter_table, 0, 0, iteration, rand_seed,
        width=width, height=height, tile_w=width, tile_h=band_h,
        settings=settings, use_filter_table=use_filter_table, rays=rays,
    )
    return _frame(out, mesh, anchor, exchange=True)
