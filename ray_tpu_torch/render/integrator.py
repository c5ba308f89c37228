"""The wavefront path-tracing integrator.

The port of ``ray_tpu.render.integrator.render_tile``: one call renders one
sample of one tile — primary rays → [closest-hit trace (flatten: one BVH;
tlas: the two-level walk), marching through Transparent surfaces → visible
analytic lights → surface → Mix resolution → textured uber BSDF →
light-tree NEE + shadow trace (any-hit, or the transmittance march when
the scene has transparency) → BSDF sample, Russian roulette] × bounces →
per-pixel radiance + AUX.  ``ray_tpu`` runs the bounce body under
``lax.scan``; here it is a Python loop over ``max_total_depth + 1``
bounces of whole-wavefront tensor ops, with active-lane masks.

The two transparency marches are ``ray_tpu``'s ``lax.while_loop`` loops,
ported as Python loops on ``.any()`` of the live lanes, each trace one
launch of the scene's closest-hit kernel: the closest-hit march
(:func:`_trace_closest_through`, reference IntersectScene,
CoreRef.cpp:3041-3158) carries a camera or BSDF ray through Transparent
surfaces without spending a bounce, and the shadow march
(:func:`_trace_transmittance`, CoreRef.cpp:3160-3262) multiplies a shadow
ray's transmittance by each transparent surface's Mix-weighted color.
Each loop test is one host synchronisation (``trace.host_syncs`` counts
them, ``march_counts`` the marches' traces).  The closest-hit march runs
detached, as in ``ray_tpu``: Transparent colors reach the gradient only
through the shadow march's
:func:`~ray_tpu_torch.render.surface.shadow_transmittance`.

Per-ray-type visibility (``add_instance(..., visibility=...)``) follows
``ray_tpu``: every lane carries its ray type as a mask bit — the camera
ray's, then the sampled lobe's (diffuse, specular, refraction) — and
shadow rays carry ``RAY_SHADOW``; each trace of a scene with
``has_visibility`` passes the mask (and, in flatten mode, the scene's
per-triangle ``tri_vis``), so the walks skip what the ray's type may not
see.

Occupancy compaction (``compact_after``) follows ``ray_tpu``'s conditions
exactly: after ``compact_after`` full-width bounces, if the live lanes fit
in ``K = max(R // compact_factor, 512)``, they are gathered to the front (a
stable sort) and the remaining bounces run on those K lanes, whose state is
scattered back after; each lane's arithmetic is unchanged, so compaction
never changes a pixel.

Backward: PyTorch autograd through the whole tile.  Set float columns of
``scene.materials`` and ``env_col`` to leaf tensors with
``requires_grad=True`` (``dataclasses.replace``, as ``bench.py`` does) and
``out["color"]`` carries their gradient: every render-time read of them
goes through the scene passed in.  Hits are detached, as ``ray_tpu``'s
traces are (``stop_gradient``); surface interpolation, BSDF and light math
are recomputed from the scene tables with out-of-place ops, and the only
other detached values are the ones ``ray_tpu`` detaches (light-tree picking
position and tables, the ray-cone footprint).  Stochastic decisions use
detached comparisons.

``remat=False`` stores every bounce's residuals.  ``remat=True`` is path
replay (``ray_tpu``'s ``jax.checkpoint`` of the bounce body): each bounce
runs under ``torch.utils.checkpoint`` (non-reentrant), which keeps only
the bounce's input state and recomputes its shading in backward.  The RNG
is a hash of (pixel, iteration, dimension) and the forward has no atomics
or unstable sorts, so the replay computes the forward's values bit for
bit.  With ``remat_save_trace`` (the default) the bounce's trace outputs
(two, or more with the transparency marches) are kept as well and handed
back to the replay in call order (``_TraceTape``, ``ray_tpu``'s
``save_only_these_names("trace")``): backward launches no trace.  Without
it the replay launches every trace again.
``remat_save_dots`` is accepted and changes nothing: ``ray_tpu`` saves its
one-hot matmul outputs with it, and the port's bounce has no matrix
product (the table reads are ``index_select``).

``output_sh`` adds ``ray_tpu``'s SH-L1 radiance output (``shl1``): three
more state tensors that the bounce carries, compaction off, as in
``ray_tpu``; path replay replays them with the rest.

``rays`` replaces the camera's primary rays with a given batch (the
lightmap baker's texels, the balanced sharded route's exchanged lanes).

Each stage of a tile and of a bounce is a span of
:mod:`ray_tpu_torch.utils.trace` (``rt.raygen``, ``rt.trace_closest``,
``rt.emission``, ``rt.surface``, ``rt.nee``, ``rt.trace_shadow``,
``rt.bsdf``, ``rt.compact``), recorded only while tracing is on; each host
synchronisation is counted by site in ``trace.host_syncs``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import torch
from torch.utils import checkpoint

from ray_tpu_torch.ops import rng
from ray_tpu_torch.ops.linalg import (
    HIT_BIAS,
    MAX_DIST,
    dot,
    offset_ray,
    power_heuristic,
    safe_div_pos,
)
from ray_tpu_torch.ops.traverse import (
    trace_closest_soa,
    trace_closest_tlas,
    trace_occlusion_soa,
    trace_occlusion_tlas,
)
from ray_tpu_torch.render import light_sampling, radcache
from ray_tpu_torch.render import surface as surface_mod, uber
from ray_tpu_torch.render.bsdf.microfacet import PI
from ray_tpu_torch.render.raygen import generate_primary_rays
from ray_tpu_torch.scene.materials import ShadingNode
from ray_tpu_torch.scene.visibility import (
    RAY_CAMERA,
    RAY_DIFFUSE,
    RAY_REFR,
    RAY_SHADOW,
    RAY_SPECULAR,
)
from ray_tpu_torch.utils import trace

# the transparency marches' traces ("through": the closest-hit march past
# a bounce's first trace; "transmittance": the shadow march), summed over
# renders; their loop tests are host syncs, counted in ``trace.host_syncs``
# ("march_closest", "march_shadow")
march_counts: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class PassSettings:
    """Static per-render settings (``ray_tpu``'s ``PassSettings``; reference
    ``pass_settings_t``, Types.h:92)."""

    max_total_depth: int = 6
    max_diff_depth: int = 4
    max_spec_depth: int = 8
    max_refr_depth: int = 8
    max_transp_depth: int = 8
    min_total_depth: int = 2
    min_transp_depth: int = 2
    clamp_direct: float = 0.0    # 0 = unclamped
    clamp_indirect: float = 0.0
    regularize_alpha: float = 0.03
    use_nee: bool = True
    use_path_termination: bool = True
    no_sphrect: bool = False
    # path-replay backprop: checkpointed bounce bodies (module docstring)
    remat: bool = False
    remat_save_trace: bool = True
    remat_save_dots: bool = False
    # occupancy compaction after this many bounces (0 = off)
    compact_after: int = 0
    compact_factor: int = 4
    # ePassFlags (reference Types.h:85-91)
    skip_direct: bool = False
    skip_indirect: bool = False
    lighting_only: bool = False
    no_background: bool = False
    output_sh: bool = False
    # ray_tpu's per-renderer opt-out of its Pallas kernels (XLA walks
    # instead).  Accepted and inert here: the device picks the path — a
    # CUDA tensor launches the hand-written kernels, a CPU tensor runs
    # their plain versions — so there is nothing to opt out of.
    force_xla: bool = False
    tex_filter: str = "stochastic"
    # count non-finite live-lane state per bounce → out["nonfinite"]
    nan_check: bool = False


_TEX_FILTERS = ("bilinear", "stochastic", "stochastic_aniso")


class _PathState(NamedTuple):
    ro: torch.Tensor          # (R, 3)
    rd: torch.Tensor          # (R, 3)
    t_max: torch.Tensor       # (R,)
    throughput: torch.Tensor  # (R, 3)
    bsdf_pdf: torch.Tensor    # (R,) pdf of the sampled direction, for MIS
    active: torch.Tensor      # (R,) bool
    depth: torch.Tensor       # (R, 4) i32 diffuse/specular/refraction/transparency
    ior_stack: torch.Tensor   # (R, 4) outside IORs of entered media (-1 free)
    accum: torch.Tensor       # (R, 3) radiance
    aux_base: torch.Tensor    # (R, 3) base color at the primary hit
    aux_dn: torch.Tensor      # (R, 4) normal + depth at the primary hit
    ray_mask: torch.Tensor    # (R,) i32 the ray type's visibility bit
    cone_width: torch.Tensor  # (R,) ray-cone width at the ray origin
    cone_spread: torch.Tensor  # (R,) ray-cone spread angle
    vertex_count: torch.Tensor  # (R,) i32 cacheable path vertices so far
    seed: torch.Tensor        # (R,) per-lane RNG seed
    # output_sh only (else None): the first real vertex's BSDF direction,
    # whether the lane has yet to shade that vertex, and the (R, 4, 3)
    # SH-L1 radiance
    sh_dir: torch.Tensor = None
    sh_open: torch.Tensor = None
    aux_sh: torch.Tensor = None


def _sh_l1_basis(w):
    """The SH L1 basis at unit directions w (R, 3) → (R, 4), in the
    {L0, L1_y, L1_z, L1_x} order of the reference's shl1_data_t
    (Types.h:51-54, 4 coefficients × RGB)."""
    return torch.stack(
        [torch.full(w.shape[:-1], 0.282095, dtype=w.dtype, device=w.device),
         0.488603 * w[..., 1], 0.488603 * w[..., 2], 0.488603 * w[..., 0]],
        dim=-1,
    )


def _clamp_contribution(col, limit: float):
    """Per-contribution energy clamp (limit <= 0 → off)."""
    if limit <= 0.0:
        return col
    s = col.sum(dim=-1, keepdim=True)
    scale = torch.where(s > limit, limit / torch.clamp_min(s, 1e-12), 1.0)
    return col * scale


def _slot_mask(slot, n=4):
    """(R,) slot index → (R, n) one-hot bool."""
    return slot[:, None] == torch.arange(n, dtype=slot.dtype,
                                         device=slot.device)[None, :]


def _push_ior(stack, val, mask):
    """Push into the 4-deep IOR stack (ShadeRef.cpp:355-362): the first free
    slot, else the last."""
    neg = stack < 0.0
    has_slot = neg.any(dim=-1)
    first_neg = torch.argmax(neg.to(torch.int32), dim=-1)
    slot = torch.where(has_slot, first_neg, 3)
    take = _slot_mask(slot) & mask[:, None]
    return torch.where(take, val[:, None], stack)


def _pop_ior(stack, mask):
    """Pop the topmost (highest-index) positive entry
    (ShadeRef.cpp:364-371)."""
    pos = stack > 0.0
    has = pos.any(dim=-1)
    top = 3 - torch.argmax(pos.flip(-1).to(torch.int32), dim=-1)
    take = _slot_mask(top) & (mask & has)[:, None]
    return torch.where(take, -1.0, stack)


def _peek_ior(stack, skip_first, default=1.0):
    """Current outside IOR: the topmost positive entry, optionally skipping
    one (when exiting a medium) — ShadeRef.cpp:373-380."""
    out = torch.full(stack.shape[:1], default, dtype=stack.dtype,
                     device=stack.device)
    skipped = torch.zeros(stack.shape[:1], dtype=torch.bool,
                          device=stack.device)
    found = torch.zeros_like(skipped)
    for i in range(3, -1, -1):
        v = stack[:, i]
        pos = v > 0.0
        skip_now = pos & skip_first & (~skipped) & (~found)
        take = pos & (~skip_now) & (~found)
        out = torch.where(take, v, out)
        found = found | take
        skipped = skipped | skip_now
    return out


def _check_supported(settings: PassSettings, cache, cache_mode: str,
                     rays, n_lanes: int) -> None:
    if settings.tex_filter not in _TEX_FILTERS:
        raise ValueError(f"unknown tex_filter {settings.tex_filter!r}")
    if cache_mode not in ("off", "update", "query"):
        raise ValueError(f"unknown cache_mode {cache_mode!r}")
    if cache_mode != "off" and cache is None:
        raise ValueError(f"cache_mode {cache_mode!r} needs a cache")
    if rays is not None and tuple(rays.px.shape) != (n_lanes,):
        raise ValueError(f"a rays batch of {tuple(rays.px.shape)} lanes for "
                         f"a {n_lanes}-lane tile (tile_w * tile_h)")


def render_tile(
    scene,
    cam,
    filter_table,
    x0,
    y0,
    iteration,
    rand_seed,
    *,
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    settings: PassSettings,
    use_filter_table: bool,
    pixel_mask=None,
    cache=None,
    cache_mode: str = "off",
    rays=None,
):
    """Render one sample of a (tile_h, tile_w) tile on the scene's device.

    ``iteration`` (≥ 1) and ``rand_seed`` are ints: a sample is a pure
    function of (pixel, iteration, dimension, seed).  ``pixel_mask``:
    optional (R,) bool — False lanes trace nothing.  Returns a dict with
    'color' (R,3) radiance, 'base_color' (R,3), 'depth_normal' (R,4),
    'rays_traced' (closest + shadow rays, a 0-dim int64 tensor) and with
    ``output_sh`` 'shl1' (R,4,3): each contribution projected on the SH-L1
    basis of the direction it arrives from at the pixel's first real
    vertex (compaction is off then, as in ``ray_tpu``).

    ``cache`` / ``cache_mode``: the spatial radiance cache
    (:mod:`.radcache`, ``ray_tpu``'s plumbing).  ``"query"`` ends a path
    at a hit whose ray cone is wider than the cache voxel there with the
    cached radiance (ShadeRef.cpp:1370-1392); ``"update"`` records each
    bounce's contribution, throughput and vertex, roughens the lobes to
    ``RAD_CACHE_MIN_ROUGHNESS`` and back-propagates into the cache after
    the last bounce: the new state is ``out["cache"]`` (compaction off, as
    in ``ray_tpu``).  The cache is constant within a call, so a replayed
    bounce queries what the forward did.

    ``rays``: a :class:`~ray_tpu_torch.render.raygen.PrimaryRays` batch of
    ``tile_w * tile_h`` lanes in place of the camera's (the lightmap
    baker's texels, :mod:`.lightmap`, or the lanes another rank sent,
    :func:`~ray_tpu_torch.parallel.shard.render_sharded_balanced`); ``cam``
    may then be None.  Each lane's seed comes from its own ``px`` /
    ``py``, so its pixels need not form the tile at (x0, y0)."""
    R = tile_w * tile_h
    _check_supported(settings, cache, cache_mode, rays, R)
    device = scene.device
    with trace.span("rt.raygen"):
        if rays is None:
            rays = generate_primary_rays(
                cam, filter_table, x0, y0, iteration, rand_seed,
                width=width, height=height, tile_w=tile_w, tile_h=tile_h,
                use_filter_table=use_filter_table, device=device,
            )
        sample_i = (int(iteration) - 1) & 0xFFFFFFFF
        feats = uber.mat_features(scene.mat_types)

        def f32(shape, value):
            return torch.full(shape, value, dtype=torch.float32, device=device)

        st = _PathState(
            ro=rays.ro,
            rd=rays.rd,
            t_max=rays.t_max,
            throughput=f32((R, 3), 1.0),
            bsdf_pdf=f32((R,), 1e6),            # camera rays: delta pdf
            active=(torch.ones((R,), dtype=torch.bool, device=device)
                    if pixel_mask is None else pixel_mask.to(device)),
            depth=torch.zeros((R, 4), dtype=torch.int32, device=device),
            ior_stack=f32((R, 4), -1.0),
            accum=f32((R, 3), 0.0),
            aux_base=f32((R, 3), 0.0),
            aux_dn=f32((R, 4), 0.0),
            ray_mask=torch.full((R,), RAY_CAMERA, dtype=torch.int32,
                                device=device),
            cone_width=f32((R,), 0.0),
            cone_spread=(rays.cone_spread.to(torch.float32).expand(R)
                         .contiguous()),
            vertex_count=torch.zeros((R,), dtype=torch.int32, device=device),
            seed=rng.pixel_seed(rays.px, rays.py, rand_seed),
        )
        if settings.output_sh:
            st = st._replace(
                sh_dir=rays.rd,
                sh_open=torch.ones((R,), dtype=torch.bool, device=device),
                aux_sh=f32((R, 4, 3), 0.0))
        totals = {"n": torch.zeros((), dtype=torch.int64, device=device),
                  "bad": torch.zeros((), dtype=torch.int64, device=device)}

    bounce_fn = (_replayed_bounce if settings.remat and torch.is_grad_enabled()
                 else _bounce)
    records = []   # cache_mode "update": each bounce's vertex columns

    def run(st, bounces):
        for bounce in bounces:
            st, n, bad, rec = bounce_fn(scene, settings, feats, st, bounce,
                                        sample_i, cache, cache_mode)
            totals["n"] = totals["n"] + n
            if bad is not None:
                totals["bad"] = totals["bad"] + bad
            if rec is not None:
                records.append(rec)
        return st

    n_iters = settings.max_total_depth + 1
    c = settings.compact_after
    # compaction is off where every bounce's full-width columns are kept
    # (the cache update), as in ray_tpu
    do_compact = (0 < c < n_iters and settings.compact_factor > 1
                  and cache_mode != "update" and not settings.output_sh
                  and R >= 1024)
    if not do_compact:
        st = run(st, range(n_iters))
    else:
        st = run(st, range(c))
        K = max(R // settings.compact_factor, 512)
        with trace.span("rt.compact"):
            with trace.sync("compact"):
                fits = int(st.active.sum()) <= K
            if fits:
                # stable: live lanes first, in their original order; each
                # lane's state scatters back to its own pixel afterwards
                perm = torch.argsort((~st.active).to(torch.int32),
                                     stable=True)
                idx = perm[:K]
                head = _PathState(*(None if a is None else a[idx]
                                    for a in st))
        if fits:
            head = run(head, range(c, n_iters))
            with trace.span("rt.compact"):
                st = _PathState(*(None if full is None
                                  else torch.index_copy(full, 0, idx, h)
                                  for full, h in zip(st, head)))
        else:
            st = run(st, range(c, n_iters))

    out = {
        "color": st.accum,
        "base_color": st.aux_base,
        "depth_normal": st.aux_dn,
        "rays_traced": totals["n"],
    }
    if settings.nan_check:
        out["nonfinite"] = totals["bad"]
    if settings.output_sh:
        # shl1_data_t analogue (Types.h:51): 4 SH-L1 coefficients × RGB
        out["shl1"] = st.aux_sh
    if cache_mode == "update":
        with trace.span("rt.cache"):
            delta, t_in, vtx_p, vtx_n, vtx_valid = (torch.stack(c)
                                                    for c in zip(*records))
            out["cache"] = radcache.propagate_and_accumulate(
                cache, delta, t_in, vtx_p, vtx_n, vtx_valid)
    return out


class _TraceTape:
    """The trace outputs of one checkpointed bounce, in call order: recorded
    when the bounce runs forward, handed back when backward replays it, so
    the replay shades the same (detached) hits without launching a trace.
    A bounce of a scene with transparency traces a variable number of
    times (each march step is one trace); the replay recomputes the same
    march decisions from the same values, so it asks for the same traces
    in the same order."""

    def __init__(self):
        self.outs = []
        self.pos = 0

    def __call__(self, trace, *args):
        if self.pos == len(self.outs):
            self.outs.append(trace(*args))
        out = self.outs[self.pos]
        self.pos += 1
        return out


def _untaped(trace, *args):
    return trace(*args)


def _replayed_bounce(scene, settings: PassSettings, feats, st: _PathState,
                     bounce: int, sample_i: int, cache=None,
                     cache_mode: str = "off"):
    """:func:`_bounce` under non-reentrant ``torch.utils.checkpoint``:
    autograd keeps the input state (and with ``remat_save_trace`` the
    tape's trace outputs) and re-runs the whole body in backward (early
    stop off, so a replay without the tape launches both traces again)."""
    tape = _TraceTape() if settings.remat_save_trace else None

    def body(*state):
        if tape is not None:
            tape.pos = 0
        return _bounce(scene, settings, feats, _PathState(*state), bounce,
                       sample_i, cache, cache_mode, tape)

    with checkpoint.set_checkpoint_early_stop(False):
        return checkpoint.checkpoint(body, *st, use_reentrant=False,
                                     preserve_rng_state=False)


def _vis_kw(scene, mask):
    """The visibility arguments of a trace: none for a scene without
    per-instance visibility, else the rays' type bits ``mask`` (and in
    flatten mode the per-triangle masks)."""
    if not scene.has_visibility:
        return {}
    if scene.mode == "tlas":
        return {"ray_mask": mask}
    return {"tri_vis": scene.tri_vis, "ray_mask": mask}


def _shadow_mask(ro):
    return torch.full(ro.shape[:1], RAY_SHADOW, dtype=torch.int32,
                      device=ro.device)


def _trace_closest(scene, ro, rd, t_max, active, mask=None):
    """Mode dispatch: flattened single BVH or the two-level walk, for rays
    of the types ``mask`` (None: every type).  Returns (hit, inst); inst is
    None in flatten mode."""
    t_min = torch.zeros_like(t_max)
    if scene.mode == "tlas":
        h = trace_closest_tlas(
            scene.bvh_soa, scene.tri_soa, scene.inst, ro, rd, t_min, t_max,
            active, max_leaf=scene.max_leaf, stack_size=scene.stack_size,
            **_vis_kw(scene, mask),
        )
        return h, h.inst
    h = trace_closest_soa(
        scene.bvh_soa, scene.tri_soa, ro, rd, t_min, t_max, active,
        max_leaf=scene.max_leaf, stack_size=scene.stack_size,
        **_vis_kw(scene, mask),
    )
    return h, None


def _trace_occlusion(scene, ro, rd, t_max, active):
    """Any-hit (shadow) trace, dispatched like :func:`_trace_closest`."""
    t_min = torch.zeros_like(t_max)
    vis = _vis_kw(scene, _shadow_mask(ro) if scene.has_visibility else None)
    if scene.mode == "tlas":
        return trace_occlusion_tlas(
            scene.bvh_soa, scene.tri_soa, scene.inst, ro, rd, t_min, t_max,
            active, max_leaf=scene.max_leaf, stack_size=scene.stack_size,
            **vis,
        )
    return trace_occlusion_soa(
        scene.bvh_soa, scene.tri_soa, ro, rd, t_min, t_max, active,
        max_leaf=scene.max_leaf, stack_size=scene.stack_size, **vis,
    )


_TRANSP_KEYS = ("solid_f", "solid_b", "uv0", "uv1", "uv2", "mat_f", "mat_b")


def _transp_hit(scene, hit):
    """(side_solid, uv, mat_id) of each hit: whether the side hit blocks
    shadow rays, the interpolated UV and the side's material."""
    row = surface_mod.fetch_tri_row(scene, hit.prim, keys=_TRANSP_KEYS)
    side_solid = torch.where(hit.backface, row["solid_b"] > 0.5,
                             row["solid_f"] > 0.5)
    w = (1.0 - hit.u - hit.v)[:, None]
    uv = (w * row["uv0"] + hit.u[:, None] * row["uv1"]
          + hit.v[:, None] * row["uv2"])
    mat_id = surface_mod.pick_hit_material(scene, hit.prim, hit.backface,
                                           row=row)
    return side_solid, uv, mat_id


def _trace_transmittance(scene, settings: PassSettings, traced, ro, rd,
                         dist, active):
    """Shadow-ray transparency march (reference IntersectScene shadow,
    CoreRef.cpp:3160-3262): closest hits along the ray, multiplying the
    Mix-weighted colors of transparent sides; a solid side zeroes the
    factor.  Stops when no lane is live or after ``max_transp_depth + 1``
    traces; lanes still live then block fully (rc = 0, CoreRef.cpp:3189).
    Returns (R, 3) transmittance, 1 on lanes not ``active``."""
    rc = torch.ones(ro.shape, dtype=torch.float32, device=ro.device)
    act = active
    it = 0
    while it <= settings.max_transp_depth:
        with trace.sync("march_shadow"):
            live = bool(act.any())
        if not live:
            break
        march_counts["transmittance"] += 1
        hit, _ = traced(_trace_closest, scene, ro, rd, dist, act,
                        _shadow_mask(ro) if scene.has_visibility else None)
        miss = hit.prim < 0
        side_solid, uv, mat_id = _transp_hit(scene, hit)
        rc = torch.where((act & (~miss) & side_solid)[:, None], 0.0, rc)
        cont = act & (~miss) & (~side_solid)
        tcol = surface_mod.shadow_transmittance(scene, mat_id, uv)
        rc = torch.where(cont[:, None], rc * tcol, rc)
        adv = hit.t + HIT_BIAS
        ro = torch.where(cont[:, None], ro + rd * adv[:, None], ro)
        dist = torch.where(cont, dist - adv, dist)
        act = cont & (rc.amax(dim=-1) > 1e-6) & (dist > HIT_BIAS)
        it += 1
    rc = torch.where(act[:, None], 0.0, rc)
    return torch.where(active[:, None], rc, 1.0)


def _transp_classify(scene, settings: PassSettings, hit, rd, live, transp_d,
                     total_d, thr_lum, seed, sample_i):
    """One step of the closest-hit march: resolve each hit's material as
    the reference's trace stage does (CoreRef.cpp:3076-3126: Mix chains
    without the Fresnel factor), then apply its Russian roulette past
    ``min_transp_depth`` and its ``max_transp_depth`` budget
    (CoreRef.cpp:3131-3141).  Returns (cont, kill, step_mult): lanes that
    march on, transparent hits killed, and the color a lane that marches
    on takes."""
    miss = hit.prim < 0
    side_solid, uv, mat_id = _transp_hit(scene, hit)
    rand_dim = rng.RAND_DIM_BASE_COUNT + (
        (total_d + transp_d).to(torch.int64) * rng.RAND_DIM_BOUNCE_COUNT)
    trans_r, term_r = rng.scrambled_2d_rand(
        rand_dim + rng.RAND_DIM_BSDF_PICK, seed, sample_i)
    ones = torch.ones_like(trans_r)
    mat_id, _, _ = surface_mod.resolve_mix(
        scene, mat_id, uv, trans_r, rd, rd, ones, hit.backface, None,
        use_fresnel=False)
    i = torch.clamp_min(mat_id, 0).long()
    is_transp = (live & (~miss) & (~side_solid) & (mat_id >= 0)
                 & (scene.materials["type"][i] == ShadingNode.TRANSPARENT))
    can_term = transp_d > settings.min_transp_depth
    if settings.use_path_termination:
        q = torch.where(can_term, torch.clamp_min(1.0 - thr_lum, 0.05), 0.0)
    else:
        q = torch.zeros_like(thr_lum)
    exhausted = (transp_d + 1) >= settings.max_transp_depth
    kill = is_transp & ((term_r < q) | (thr_lum <= 0.0) | exhausted)
    cont = is_transp & (~kill)
    step_mult = (scene.materials["base_color"][i]
                 * safe_div_pos(1.0, 1.0 - q)[:, None])
    return cont, kill, step_mult


def _trace_closest_through(scene, settings: PassSettings, traced, ro, rd,
                           t_max, active, mask, throughput, transp_d,
                           total_d, seed, sample_i):
    """Closest-hit trace that marches through Transparent surfaces (the
    reference's IntersectScene loop, CoreRef.cpp:3041-3158): a transparent
    continuation spends transparency depth and RNG dimensions, not a
    bounce.  The march loops while any lane continues; each lane's budget
    is its own (``exhausted``), and a killed lane's throughput becomes 0.
    The march is detached: its colors multiply ``throughput`` as
    constants.  Returns (hit with t the distance from ``ro``, instance
    ids or None, throughput, transparency depth)."""
    hit, inst = traced(_trace_closest, scene, ro, rd, t_max, active, mask)
    if not scene.has_transparency:
        return hit, inst, throughput, transp_d
    with torch.no_grad():
        rd = rd.detach()
        lum = throughput.detach().amax(dim=-1)
        cont, kill, mult = _transp_classify(
            scene, settings, hit, rd, active, transp_d, total_d, lum, seed,
            sample_i)
        ro_c = ro.detach()
        t_base = torch.zeros_like(t_max)
        t_mult = torch.ones_like(ro_c)
        while True:
            with trace.sync("march_closest"):
                live = bool(cont.any())
            if not live:
                break
            march_counts["through"] += 1
            c3 = cont[:, None]
            adv = hit.t + HIT_BIAS
            ro_c = torch.where(c3, ro_c + rd * adv[:, None], ro_c)
            t_base = torch.where(cont, t_base + adv, t_base)
            t_mult = torch.where(c3, t_mult * mult, t_mult)
            lum = torch.where(cont, lum * mult.amax(dim=-1), lum)
            transp_d = transp_d + cont.to(transp_d.dtype)
            new_hit, _ = traced(_trace_closest, scene, ro_c, rd,
                                torch.clamp_min(t_max - t_base, 0.0), cont,
                                mask)
            hit = type(hit)(*(torch.where(cont, n, o)
                              for n, o in zip(new_hit, hit)))
            cont, nkill, mult = _transp_classify(
                scene, settings, hit, rd, cont, transp_d, total_d, lum, seed,
                sample_i)
            kill = kill | nkill
        hit = hit._replace(t=hit.t + t_base)
    throughput = throughput * torch.where(kill[:, None], 0.0, t_mult)
    return hit, (hit.inst if inst is not None else None), throughput, transp_d


def _bounce(scene, settings: PassSettings, feats, st: _PathState, bounce: int,
            sample_i: int, cache=None, cache_mode: str = "off", tape=None):
    """One wavefront bounce (``ray_tpu``'s ``bounce_step``).  Returns the
    next state, the number of rays traced (closest + shadow), with
    ``nan_check`` the count of non-finite live-lane values (else None),
    and with ``cache_mode="update"`` the bounce's (contribution, incoming
    throughput, vertex position, geometric normal, cacheable) columns
    (else None).  ``tape``: a :class:`_TraceTape` that both traces go
    through."""
    with trace.Stages() as stage:
        return _bounce_stages(stage, scene, settings, feats, st, bounce,
                              sample_i, cache, cache_mode, tape)


def _bounce_stages(stage, scene, settings, feats, st, bounce, sample_i,
                   cache, cache_mode, tape):
    """:func:`_bounce`'s body; ``stage`` marks its stages."""
    traced = _untaped if tape is None else tape
    ro, rd, t_max, throughput, bsdf_pdf, active, depth = st[:7]
    ior_stack, accum, aux_base, aux_dn = (st.ior_stack, st.accum, st.aux_base,
                                          st.aux_dn)
    ray_mask = st.ray_mask
    cone_width, cone_spread, seed = st.cone_width, st.cone_spread, st.seed
    vertex_count = st.vertex_count
    accum_in, throughput_in = accum, throughput
    stage.next("rt.trace_closest")
    Rl = ro.shape[0]
    device = ro.device
    have_lights = scene.num_lights > 0
    is_first = bounce == 0
    has_portal = any(p for (_k, _v, _d, p) in scene.light_kinds)
    limit0 = settings.clamp_direct if is_first else settings.clamp_indirect
    aux_sh = st.aux_sh

    def add(acc, contrib, mask, w_dir=None):
        """Masked radiance add; with ``output_sh`` the contribution is also
        projected on the SH-L1 basis of the direction toward its source
        at the pixel's first real vertex: ``w_dir`` (NEE's light
        direction), else the ray direction (a light or the environment
        hit), and past that vertex the BSDF direction sampled there."""
        nonlocal aux_sh
        c = torch.where(mask[:, None], contrib, 0.0)
        if aux_sh is not None:
            w = torch.where(st.sh_open[:, None],
                            rd if w_dir is None else w_dir, st.sh_dir)
            aux_sh = aux_sh + _sh_l1_basis(w)[:, :, None] * c[:, None, :]
        return acc + c

    total_depth = depth[:, 0] + depth[:, 1] + depth[:, 2]
    # closest hit, marching through Transparent surfaces (which updates the
    # throughput and the transparency depth, not the bounce)
    hit, hit_inst, throughput, transp_d = _trace_closest_through(
        scene, settings, traced, ro, rd, t_max, active, ray_mask, throughput,
        depth[:, 3], total_depth, seed, sample_i)
    if scene.has_transparency:
        depth = torch.cat([depth[:, :3], transp_d[:, None]], dim=-1)
    stage.next("rt.emission")
    miss = hit.prim < 0
    indirect = total_depth > 0

    # SkipDirect/SkipIndirect: a light reached with ≤1 surface vertex on the
    # path is "direct"
    hit_keep = torch.ones((Rl,), dtype=torch.bool, device=device)
    nee_keep = torch.ones((Rl,), dtype=torch.bool, device=device)
    if settings.skip_direct:
        hit_keep = hit_keep & (total_depth > 1)
        nee_keep = nee_keep & (total_depth > 0)
    if settings.skip_indirect:
        hit_keep = hit_keep & (total_depth <= 1)
        nee_keep = nee_keep & (total_depth == 0)
    rand_dim = rng.RAND_DIM_BASE_COUNT + (
        (total_depth + depth[:, 3]).to(torch.int64) * rng.RAND_DIM_BOUNCE_COUNT
    )

    # ---------- visible sphere lights (IntersectAreaLights,
    # CoreRef.cpp:3616): a light hit in front of geometry ends the path
    # with MIS-weighted emission ----------
    light_first = torch.zeros_like(active)
    if any(vis and k not in (1, 5, 6) for (k, vis, _d, _p) in scene.light_kinds):
        seg_end = torch.where(miss, t_max, hit.t)
        al_t, al_i, al_pdf, al_spot = light_sampling.intersect_area_lights(
            scene, ro, rd, seg_end, no_sphrect=settings.no_sphrect)
        light_first = active & (al_i >= 0) & (al_t < seg_end)
        al_safe = torch.clamp_min(al_i, 0).long()
        lcol = scene.lights["col"][al_safe] * al_spot[:, None]
        if has_portal:
            # a sky-portal hit shows the environment through the window
            # (Evaluate_LightColor's sky_portal branch, ShadeRef.cpp:1077)
            lcol = torch.where(scene.lights["portal"][al_safe][:, None],
                               lcol * light_sampling.env_color(scene, rd),
                               lcol)
        if settings.use_nee:
            # MIS at any depth (Evaluate_LightColor, ShadeRef.cpp:1080-1170)
            lw = torch.where(indirect, power_heuristic(bsdf_pdf, al_pdf), 1.0)
            lcol = lcol * lw[:, None]
        l_contrib = _clamp_contribution(throughput * lcol, limit0)
        accum = add(accum, l_contrib, light_first & hit_keep)

    # ---------- environment on miss (ShadeRef.cpp:1192-1216) ----------
    env_col = light_sampling.env_color(scene, rd)
    if settings.use_nee and scene.env_light_index >= 0:
        env_light_pick_pdf = light_sampling.light_pick_pdf(
            scene, ro, torch.full((Rl,), scene.env_light_index,
                                  dtype=torch.int32, device=device)
        )
        if scene.env_tab_h > 0:
            light_pdf = (light_sampling.env_hit_pdf(scene, rd)
                         * env_light_pick_pdf)
        else:
            light_pdf = (0.5 / PI) * env_light_pick_pdf
        can_mis = indirect & (total_depth < settings.max_total_depth)
        mis_w = torch.where(can_mis, power_heuristic(bsdf_pdf, light_pdf), 1.0)
        env_col = env_col * mis_w[:, None]
    env_contrib = _clamp_contribution(throughput * env_col, limit0)
    env_keep = hit_keep
    if settings.no_background:
        env_keep = env_keep & indirect
    accum = add(accum, env_contrib, active & miss & (~light_first) & env_keep)

    alive = active & (~miss) & (~light_first)

    stage.next("rt.surface")
    # ---------- surface attributes (one packed row gather per hit) ----
    tri_row = surface_mod.fetch_tri_row(scene, hit.prim)
    surf = surface_mod.compute_surface(
        scene, hit.prim, hit.u, hit.v, hit.backface, ro, rd, hit.t,
        inst=hit_inst, row=tri_row,
    )
    mat_id = surface_mod.pick_hit_material(scene, hit.prim, hit.backface,
                                           row=tri_row)
    alive = alive & (mat_id >= 0)

    # ray-cone texture LOD λ (ShadeRef.cpp:1279-1283)
    cw_at_hit = cone_width + cone_spread * hit.t.detach()
    lam = surf.lod_base + torch.log2(torch.clamp_min(cw_at_hit, 1e-30))

    tex_rand = None
    fetch_kw = None
    if scene.has_textures:
        tex_rx, tex_ry = rng.scrambled_2d_rand(
            rand_dim + rng.RAND_DIM_TEX, seed, sample_i)
        tex_rand = torch.stack([tex_rx, tex_ry], dim=-1)
        if settings.tex_filter != "bilinear":
            # the reference's default single jittered tap (CoreRef.cpp:19);
            # "stochastic_aniso" adds taps along the footprint's major axis
            fetch_kw = {"rand": tex_rand}
            if settings.tex_filter == "stochastic_aniso":
                ar, _ = rng.scrambled_2d_rand(
                    rand_dim + rng.RAND_DIM_TEX_ANISO, seed, sample_i)
                fetch_kw.update(
                    aniso_duv=surf.duv_major_unit
                    * (cw_at_hit * surf.aniso_elong)[:, None],
                    aniso_rand=ar,
                )
    mix_rx, term_r = rng.scrambled_2d_rand(
        rand_dim + rng.RAND_DIM_BSDF_PICK, seed, sample_i)
    ext_ior = (_peek_ior(ior_stack, hit.backface) if feats.any_refr
               else torch.ones((Rl,), dtype=torch.float32, device=device))
    mat_id, mix_rand, mix_weight = surface_mod.resolve_mix(
        scene, mat_id, surf.uv, mix_rx, rd, surf.N, ext_ior, hit.backface,
        tex_rand, lam=lam, fetch_kw=fetch_kw,
    )
    surf = surface_mod.apply_normal_map(scene, mat_id, surf, rd, tex_rand,
                                        lam=lam, fetch_kw=fetch_kw)
    surf = surface_mod.apply_tangent_rotation(scene, mat_id, surf)

    # path regularization applies once a DIFFUSE bounce is on the path
    # (ShadeRef.cpp:1468); it only reaches the glossy lobes
    reg_alpha = torch.where(depth[:, 0] > 0, settings.regularize_alpha, 0.0)
    params = uber.gather_uber_params(
        scene, mat_id, surf.uv, rd, surf.N, hit.backface, ext_ior, tex_rand,
        regularize_alpha=reg_alpha, lam=lam, feats=feats, fetch_kw=fetch_kw,
        # the update pass caches diffuse-ish radiance only: view-dependent
        # sharp lobes are roughened (ShadeRef.cpp:1450-1452)
        min_roughness=(radcache.RAD_CACHE_MIN_ROUGHNESS
                       if cache_mode == "update" else 0.0),
    )
    if settings.lighting_only and is_first:
        # lightmap mode: ignore albedo at the primary vertex
        params = params._replace(base_color=torch.ones_like(params.base_color))

    # ---------- emissive hit (ShadeRef.cpp:1502-1539) ----------
    stage.next("rt.emission")
    emis_mask = alive & (params.emission.amax(dim=-1) > 0.0)
    mis_w = torch.ones((Rl,), dtype=torch.float32, device=device)
    if settings.use_nee and have_lights:
        lid = surface_mod.hit_light_id(scene, hit.prim, hit_inst, row=tri_row)
        lpick = light_sampling.light_pick_pdf(scene, ro, lid)
        light_pdf = light_sampling.tri_light_hit_pdf(
            scene, hit.prim, hit.t, rd, lpick, light_id=lid, ro=ro
        )
        # MIS only where NEE could have sampled this hit: the light's front
        # side, or any side if doublesided
        nee_covers = (~hit.backface) | scene.lights["doublesided"][
            torch.clamp_min(lid, 0)]
        needs_mis = indirect & params.imp_sample & (lid >= 0) & nee_covers
        mis_w = torch.where(needs_mis, power_heuristic(bsdf_pdf, light_pdf), 1.0)
    emis_contrib = _clamp_contribution(
        throughput * params.emission * (mix_weight * mis_w)[:, None], limit0
    )
    accum = add(accum, emis_contrib, emis_mask & hit_keep)

    # AUX from the primary hit
    if is_first:
        take_aux = alive[:, None]
        aux_base = torch.where(take_aux, params.base_color, aux_base)
        aux_dn = torch.where(
            take_aux, torch.cat([surf.N, hit.t[:, None]], dim=-1), aux_dn)

    can_shade = alive & (~params.is_emissive) & (~params.is_transparent)

    # ---------- spatial cache query exit (ShadeRef.cpp:1370-1392) ----------
    if cache_mode == "query":
        stage.next("rt.cache")
        c_r1, c_r2 = rng.scrambled_2d_rand(
            rand_dim + rng.RAND_DIM_CACHE, seed, sample_i)
        p_d, n_d = surf.P.detach(), surf.plane_N.detach()
        vs = radcache.voxel_size(radcache.grid_level(p_d, cache.cam_pos))
        use_cache = (can_shade & (cw_at_hit.detach() > (1.0 + 0.5 * c_r1) * vs)
                     & (hit.t > (1.0 + c_r2) * vs))
        c_rad, c_good = radcache.query(cache, p_d, n_d, use_cache)
        accum = add(accum, throughput * c_rad, c_good)
        can_shade = can_shade & (~c_good)

    # ---------- NEE (SampleLightSource + eval + shadow ray) ----------
    n_shadow = None
    if settings.use_nee and have_lights:
        stage.next("rt.nee")
        pick_r, _ = rng.scrambled_2d_rand(
            rand_dim + rng.RAND_DIM_LIGHT_PICK, seed, sample_i)
        luv_x, luv_y = rng.scrambled_2d_rand(
            rand_dim + rng.RAND_DIM_LIGHT, seed, sample_i)
        ls = light_sampling.sample_light_source(
            scene, surf.P, surf.T, surf.B, surf.N, pick_r,
            torch.stack([luv_x, luv_y], dim=-1),
            no_sphrect=settings.no_sphrect,
        )
        f_cos, pdf_b = uber.eval_uber(
            params, surf.T, surf.B, surf.N, rd, ls.L, feats=feats
        )
        can_mis = total_depth < settings.max_total_depth
        nee_mis = torch.where(
            (ls.area > 0.0) & can_mis, power_heuristic(ls.pdf, pdf_b), 1.0
        )
        nee_col = ls.col * f_cos * (
            mix_weight * nee_mis * safe_div_pos(1.0, ls.pdf)
        )[:, None]
        nee_valid = can_shade & nee_keep & (ls.pdf > 0.0) & (
            nee_col.amax(dim=-1) > 0.0
        )
        n_dot_l = dot(surf.N, ls.L, False)
        sh_o = offset_ray(
            surf.P,
            torch.where((n_dot_l < 0.0)[:, None], -surf.plane_N, surf.plane_N),
        )
        to_lp = ls.lp - sh_o
        sh_dist = torch.sqrt(torch.clamp_min(dot(to_lp, to_lp, False), 1e-30))
        sh_d = to_lp / sh_dist[:, None]
        sh_dist = sh_dist * ls.dist_mul
        shadow_active = nee_valid & ls.cast_shadow
        # sky portals block environment shadow rays one-sidedly (the
        # blocker pass, CoreRef.cpp:4866-4870 + :4533-4590)
        pblock = None
        if has_portal:
            pblock = ls.from_env & light_sampling.portal_shadow_block(
                scene, sh_o, sh_d, sh_dist * 0.999)
        if scene.has_transparency:
            stage.next("rt.trace_shadow")
            rc = _trace_transmittance(scene, settings, traced, sh_o, sh_d,
                                      sh_dist * 0.999, shadow_active)
            stage.next("rt.nee")
            factor = torch.where(ls.cast_shadow[:, None], rc, 1.0)
            if pblock is not None:
                factor = torch.where(pblock[:, None], 0.0, factor)
            sh_contrib = _clamp_contribution(throughput * nee_col * factor,
                                             limit0)
            accum = add(accum, sh_contrib, nee_valid, w_dir=ls.L)
        else:
            stage.next("rt.trace_shadow")
            occluded = traced(_trace_occlusion, scene, sh_o, sh_d,
                              sh_dist * 0.999, shadow_active)
            stage.next("rt.nee")
            visible = nee_valid & ((~ls.cast_shadow) | (~occluded))
            if pblock is not None:
                visible = visible & (~pblock)
            sh_contrib = _clamp_contribution(throughput * nee_col, limit0)
            accum = add(accum, sh_contrib, visible, w_dir=ls.L)
        n_shadow = shadow_active.sum()

    # ---------- BSDF sampling / next bounce ----------
    stage.next("rt.bsdf")
    brx, bry = rng.scrambled_2d_rand(rand_dim + rng.RAND_DIM_BSDF, seed, sample_i)
    bs = uber.sample_uber(
        params, surf.T, surf.B, surf.N, rd,
        torch.stack([brx, bry], dim=-1), mix_rand, feats=feats,
    )

    is_diff = bs.ray_type == uber.RAY_TYPE_DIFFUSE
    is_spec = bs.ray_type == uber.RAY_TYPE_SPECULAR
    is_refr = bs.ray_type == uber.RAY_TYPE_REFR
    depth_ok = (
        (is_diff & (depth[:, 0] < settings.max_diff_depth))
        | (is_spec & (depth[:, 1] < settings.max_spec_depth))
        | (is_refr & (depth[:, 2] < settings.max_refr_depth))
    ) & (total_depth < settings.max_total_depth)
    if settings.skip_indirect:
        # nothing beyond the first bounce can contribute — stop early
        depth_ok = depth_ok & (total_depth < 1)

    new_throughput = throughput * bs.weight * mix_weight[:, None]
    tlum = new_throughput.amax(dim=-1)

    # Russian roulette (ShadeRef.cpp:1604-1618) on total depth
    if settings.use_path_termination:
        can_rr = total_depth > settings.min_total_depth
        rr_q = torch.where(can_rr, torch.clamp_min(1.0 - tlum, 0.05), 0.0)
    else:
        rr_q = torch.zeros_like(tlum)
    rr_pass = term_r >= rr_q
    new_throughput = new_throughput * safe_div_pos(1.0, 1.0 - rr_q)[:, None]

    next_active = (
        can_shade & depth_ok & rr_pass & (tlum > 0.0) & (bs.pdf > 0.0)
    )

    if feats.any_refr:
        entering = next_active & is_refr & (~hit.backface)
        exiting = next_active & is_refr & hit.backface
        ior_stack = _push_ior(ior_stack, params.int_ior, entering)
        ior_stack = _pop_ior(ior_stack, exiting)

    new_o = offset_ray(
        surf.P,
        torch.where(bs.flip_origin[:, None], -surf.plane_N, surf.plane_N),
    )
    na3 = next_active[:, None]
    ro = torch.where(na3, new_o, ro)
    rd = torch.where(na3, bs.dir, rd)
    throughput = torch.where(na3, new_throughput, throughput)
    bsdf_pdf = torch.where(next_active, torch.clamp_max(bs.pdf, 1e6), bsdf_pdf)
    t_max = torch.full((Rl,), MAX_DIST, dtype=torch.float32, device=device)
    depth_inc = torch.stack(
        [is_diff, is_spec, is_refr, torch.zeros_like(is_diff)], dim=-1
    ).to(torch.int32)
    depth = depth + torch.where(na3, depth_inc, 0)
    if scene.has_visibility:
        # the next segment's ray type for the visibility masks (the
        # reference packs it in depth bits 28..31, CoreRef.h:253-280)
        new_mask = torch.where(
            is_diff, RAY_DIFFUSE,
            torch.where(is_spec, RAY_SPECULAR,
                        torch.where(is_refr, RAY_REFR, ray_mask)))
        ray_mask = torch.where(next_active, new_mask.to(torch.int32),
                               ray_mask)
    # the cone advances to the hit and spreads by the sampled lobe's alpha
    # (ShadeRef.cpp:1458-1459 + per-lobe increments)
    cone_width = torch.where(next_active, cw_at_hit, cone_width)
    cone_spread = torch.where(next_active, cone_spread + bs.cone_spread_inc,
                              cone_spread)

    # cacheable path vertices: the first PROPAGATION_DEPTH real hits
    # (SpatialCacheUpdate's path_len cap, RadCacheRef.cpp:201)
    vtx_valid = alive & (vertex_count < radcache.RAD_CACHE_PROPAGATION_DEPTH)
    vertex_count = vertex_count + vtx_valid.to(torch.int32)

    n = active.sum()
    if n_shadow is not None:
        n = n + n_shadow
    bad = None
    if settings.nan_check:
        # every live-lane quantity the next bounce consumes must be finite
        bad = torch.zeros((), dtype=torch.int64, device=device)
        for arr in (ro, rd, throughput, bsdf_pdf, cone_width, cone_spread):
            nf = ~torch.isfinite(arr)
            if nf.dim() == 2:
                nf = nf.any(dim=-1)
            bad = bad + (nf & next_active).sum()
        for arr in (accum, aux_base, aux_dn):
            bad = bad + (~torch.isfinite(arr)).any(dim=-1).sum()
    sh_dir, sh_open = st.sh_dir, st.sh_open
    if aux_sh is not None:
        # the first real (non-transparent) shaded vertex closes sh_open
        # and pins the direction of deeper contributions
        real_vtx = can_shade & sh_open
        sh_dir = torch.where(real_vtx[:, None], bs.dir, sh_dir)
        sh_open = sh_open & (~real_vtx)
    new = _PathState(ro=ro, rd=rd, t_max=t_max, throughput=throughput,
                     bsdf_pdf=bsdf_pdf, active=next_active, depth=depth,
                     ior_stack=ior_stack, accum=accum, aux_base=aux_base,
                     aux_dn=aux_dn, ray_mask=ray_mask, cone_width=cone_width,
                     cone_spread=cone_spread, vertex_count=vertex_count,
                     seed=seed, sh_dir=sh_dir, sh_open=sh_open, aux_sh=aux_sh)
    rec = None
    if cache_mode == "update":
        rec = ((accum - accum_in).detach(), throughput_in.detach(),
               surf.P.detach(), surf.plane_N.detach(), vtx_valid)
    return new, n, bad, rec
