"""The wavefront path-tracing integrator of the reference.

A frozen copy of ``ray_tpu_torch.render.integrator.render_tile`` cut to
what the benchmark's configurations reach: one call renders one sample of
one tile — primary rays → [closest-hit trace (flatten: brute force; tlas:
the two-level walk) → visible analytic lights → surface → Mix resolution →
textured uber BSDF → light-tree NEE + any-hit shadow trace → BSDF sample,
Russian roulette] × bounces → per-pixel radiance + AUX, as a Python loop
over ``max_total_depth + 1`` bounces of whole-wavefront tensor ops with
active-lane masks.  Scenes with transparency, visibility masks, sky
portals or an environment map raise at ``finalize``; a radiance cache
raises here.

Occupancy compaction (``compact_after``) follows ``ray_tpu``'s conditions
exactly: after ``compact_after`` full-width bounces, if the live lanes fit
in ``K = max(R // compact_factor, 512)``, they are gathered to the front (a
stable sort) and the remaining bounces run on those K lanes, whose state is
scattered back after; each lane's arithmetic is unchanged, so compaction
never changes a pixel.

Backward: PyTorch autograd through the whole tile, every bounce's
residuals stored.  Set float columns of ``scene.materials`` and
``env_col`` to leaf tensors with ``requires_grad=True``
(``dataclasses.replace``) and ``out["color"]`` carries their gradient.
Hits are detached, as ``ray_tpu``'s traces are.

The benchmark's additions: ``iteration`` may be an (R,) tensor (one sample
a lane, for a batch of chosen (pixel, iteration) pairs), ``rays`` replaces
the camera's primary rays with a given batch, and
``PassSettings.state_bf16`` is the control (the path state stored in
bfloat16).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from rtbench.ref.ops import rng
from rtbench.ref.ops.linalg import (
    MAX_DIST,
    dot,
    offset_ray,
    power_heuristic,
    safe_div_pos,
)
from rtbench.ref.ops.traverse import (
    trace_closest_soa,
    trace_closest_tlas,
    trace_occlusion_soa,
    trace_occlusion_tlas,
)
from rtbench.ref.render import light_sampling
from rtbench.ref.render import surface as surface_mod, uber
from rtbench.ref.render.bsdf.microfacet import PI
from rtbench.ref.render.raygen import generate_primary_rays


@dataclasses.dataclass(frozen=True)
class PassSettings:
    """Static per-render settings (``ray_tpu``'s ``PassSettings``; reference
    ``pass_settings_t``, Types.h:92)."""

    max_total_depth: int = 6
    max_diff_depth: int = 4
    max_spec_depth: int = 8
    max_refr_depth: int = 8
    min_total_depth: int = 2
    clamp_direct: float = 0.0    # 0 = unclamped
    clamp_indirect: float = 0.0
    regularize_alpha: float = 0.03
    use_nee: bool = True
    use_path_termination: bool = True
    # occupancy compaction after this many bounces (0 = off)
    compact_after: int = 0
    compact_factor: int = 4
    # ePassFlags (reference Types.h:85-91)
    skip_direct: bool = False
    skip_indirect: bool = False
    lighting_only: bool = False
    no_background: bool = False
    # the benchmark's control: the path state stored in bfloat16 between
    # bounces (rounded to it at each bounce's start), the precision step
    # below the float32 the configurations state
    state_bf16: bool = False


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
    cone_width: torch.Tensor  # (R,) ray-cone width at the ray origin
    cone_spread: torch.Tensor  # (R,) ray-cone spread angle
    seed: torch.Tensor        # (R,) per-lane RNG seed


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
    if cache is not None or cache_mode != "off":
        raise ValueError("the reference has no radiance cache")
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
    'rays_traced' (closest + shadow rays, a 0-dim int64 tensor).

    ``rays``: a :class:`~rtbench.ref.render.raygen.PrimaryRays` batch of
    ``tile_w * tile_h`` lanes in place of the camera's; ``cam`` may then be
    None.  Each lane's seed comes from its own ``px`` / ``py``, so its
    pixels need not form the tile at (x0, y0)."""
    R = tile_w * tile_h
    _check_supported(settings, cache, cache_mode, rays, R)
    device = scene.device
    if rays is None:
        rays = generate_primary_rays(
            cam, filter_table, x0, y0, iteration, rand_seed,
            width=width, height=height, tile_w=tile_w, tile_h=tile_h,
            use_filter_table=use_filter_table, device=device,
        )
    # a tensor ``iteration`` gives each lane its own sample (the reference
    # recomputes chosen (pixel, iteration) pairs in one batch)
    if isinstance(iteration, torch.Tensor):
        sample_i = (iteration.to(torch.int64) - 1) & 0xFFFFFFFF
    else:
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
        cone_width=f32((R,), 0.0),
        cone_spread=rays.cone_spread.to(torch.float32).expand(R).contiguous(),
        seed=rng.pixel_seed(rays.px, rays.py, rand_seed),
    )
    totals = {"n": torch.zeros((), dtype=torch.int64, device=device)}

    def run(st, bounces):
        for bounce in bounces:
            st, n = _bounce(scene, settings, feats, st, bounce, sample_i)
            totals["n"] = totals["n"] + n
        return st

    n_iters = settings.max_total_depth + 1
    c = settings.compact_after
    # a batch of (pixel, iteration) lanes runs uncompacted: compaction
    # changes no lane's arithmetic
    do_compact = (0 < c < n_iters and settings.compact_factor > 1
                  and not isinstance(sample_i, torch.Tensor) and R >= 1024)
    if not do_compact:
        st = run(st, range(n_iters))
    else:
        st = run(st, range(c))
        K = max(R // settings.compact_factor, 512)
        if int(st.active.sum()) <= K:
            # stable: live lanes first, in their original order; each
            # lane's state scatters back to its own pixel afterwards
            perm = torch.argsort((~st.active).to(torch.int32), stable=True)
            idx = perm[:K]
            head = run(_PathState(*(None if a is None else a[idx]
                                    for a in st)), range(c, n_iters))
            st = _PathState(*(None if full is None
                              else torch.index_copy(full, 0, idx, h)
                              for full, h in zip(st, head)))
        else:
            st = run(st, range(c, n_iters))

    out = {
        "color": _bf16(st.accum) if settings.state_bf16 else st.accum,
        "base_color": st.aux_base,
        "depth_normal": st.aux_dn,
        "rays_traced": totals["n"],
    }
    return out


def _trace_closest(scene, ro, rd, t_max, active):
    """Mode dispatch: the flattened scene or the two-level walk.  Returns
    (hit, inst); inst is None in flatten mode."""
    t_min = torch.zeros_like(t_max)
    if scene.mode == "tlas":
        h = trace_closest_tlas(scene.bvh_soa, ro, rd, t_min, t_max, active,
                               max_leaf=scene.max_leaf,
                               stack_size=scene.stack_size)
        return h, h.inst
    return trace_closest_soa(scene.tri_soa, ro, rd, t_min, t_max,
                             active), None


def _trace_occlusion(scene, ro, rd, t_max, active):
    """Any-hit (shadow) trace, dispatched like :func:`_trace_closest`."""
    t_min = torch.zeros_like(t_max)
    if scene.mode == "tlas":
        return trace_occlusion_tlas(scene.bvh_soa, ro, rd, t_min, t_max,
                                    active, max_leaf=scene.max_leaf,
                                    stack_size=scene.stack_size)
    return trace_occlusion_soa(scene.tri_soa, ro, rd, t_min, t_max, active)


def _bf16(x):
    """``x`` rounded to bfloat16 and back (the control's storage)."""
    return x.to(torch.bfloat16).to(x.dtype)


def _bounce(scene, settings: PassSettings, feats, st: _PathState, bounce: int,
            sample_i: int):
    """One wavefront bounce (``ray_tpu``'s ``bounce_step``).  Returns the
    next state and the number of rays traced (closest + shadow)."""
    if settings.state_bf16:
        st = st._replace(**{k: _bf16(getattr(st, k)) for k in (
            "ro", "rd", "t_max", "throughput", "bsdf_pdf", "accum")})
    ro, rd, t_max, throughput, bsdf_pdf, active, depth = st[:7]
    ior_stack, accum, aux_base, aux_dn = (st.ior_stack, st.accum, st.aux_base,
                                          st.aux_dn)
    cone_width, cone_spread, seed = st.cone_width, st.cone_spread, st.seed
    Rl = ro.shape[0]
    device = ro.device
    have_lights = scene.num_lights > 0
    is_first = bounce == 0
    limit0 = settings.clamp_direct if is_first else settings.clamp_indirect

    def add(acc, contrib, mask):
        """Masked radiance add."""
        return acc + torch.where(mask[:, None], contrib, 0.0)

    total_depth = depth[:, 0] + depth[:, 1] + depth[:, 2]
    hit, hit_inst = _trace_closest(scene, ro, rd, t_max, active)
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
            scene, ro, rd, seg_end)
        light_first = active & (al_i >= 0) & (al_t < seg_end)
        al_safe = torch.clamp_min(al_i, 0).long()
        lcol = scene.lights["col"][al_safe] * al_spot[:, None]
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
        # the reference's default single jittered tap (CoreRef.cpp:19)
        fetch_kw = {"rand": tex_rand}
    mix_rx, term_r = rng.scrambled_2d_rand(
        rand_dim + rng.RAND_DIM_BSDF_PICK, seed, sample_i)
    ext_ior = (_peek_ior(ior_stack, hit.backface) if feats.any_refr
               else torch.ones((Rl,), dtype=torch.float32, device=device))
    # no Mix node, normal map or tangent rotation (finalize refuses them)
    mix_rand, mix_weight = mix_rx, torch.ones_like(mix_rx)

    # path regularization applies once a DIFFUSE bounce is on the path
    # (ShadeRef.cpp:1468); it only reaches the glossy lobes
    reg_alpha = torch.where(depth[:, 0] > 0, settings.regularize_alpha, 0.0)
    params = uber.gather_uber_params(
        scene, mat_id, surf.uv, rd, surf.N, hit.backface, ext_ior, tex_rand,
        regularize_alpha=reg_alpha, lam=lam, feats=feats, fetch_kw=fetch_kw,
    )
    if settings.lighting_only and is_first:
        # lightmap mode: ignore albedo at the primary vertex
        params = params._replace(base_color=torch.ones_like(params.base_color))

    # ---------- emissive hit (ShadeRef.cpp:1502-1539) ----------
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

    # ---------- NEE (SampleLightSource + eval + shadow ray) ----------
    n_shadow = None
    if settings.use_nee and have_lights:
        pick_r, _ = rng.scrambled_2d_rand(
            rand_dim + rng.RAND_DIM_LIGHT_PICK, seed, sample_i)
        luv_x, luv_y = rng.scrambled_2d_rand(
            rand_dim + rng.RAND_DIM_LIGHT, seed, sample_i)
        ls = light_sampling.sample_light_source(
            scene, surf.P, surf.T, surf.B, surf.N, pick_r,
            torch.stack([luv_x, luv_y], dim=-1))
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
        occluded = _trace_occlusion(scene, sh_o, sh_d, sh_dist * 0.999,
                                    shadow_active)
        visible = nee_valid & ((~ls.cast_shadow) | (~occluded))
        sh_contrib = _clamp_contribution(throughput * nee_col, limit0)
        accum = add(accum, sh_contrib, visible)
        n_shadow = shadow_active.sum()

    # ---------- BSDF sampling / next bounce ----------
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
    # the cone advances to the hit and spreads by the sampled lobe's alpha
    # (ShadeRef.cpp:1458-1459 + per-lobe increments)
    cone_width = torch.where(next_active, cw_at_hit, cone_width)
    cone_spread = torch.where(next_active, cone_spread + bs.cone_spread_inc,
                              cone_spread)

    n = active.sum()
    if n_shadow is not None:
        n = n + n_shadow
    new = _PathState(ro=ro, rd=rd, t_max=t_max, throughput=throughput,
                     bsdf_pdf=bsdf_pdf, active=next_active, depth=depth,
                     ior_stack=ior_stack, accum=accum, aux_base=aux_base,
                     aux_dn=aux_dn, cone_width=cone_width,
                     cone_spread=cone_spread, seed=seed)
    return new, n
