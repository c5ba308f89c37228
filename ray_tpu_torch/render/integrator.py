"""The wavefront path-tracing integrator, forward pass.

The port of ``ray_tpu.render.integrator.render_tile``: one call renders one
sample of one tile — primary rays → [closest-hit trace → surface → uber
BSDF → light-tree NEE + shadow (any-hit) trace → BSDF sample, Russian
roulette] × bounces → per-pixel radiance + AUX.  ``ray_tpu`` runs the
bounce body under ``lax.scan``; here it is a Python loop over
``max_total_depth + 1`` bounces of whole-wavefront tensor ops, with
active-lane masks.

Backward: PyTorch autograd through the whole tile, with stored residuals
(``ray_tpu``'s ``remat=False``).  Set float columns of ``scene.materials``
and ``env_col`` to leaf tensors with ``requires_grad=True``
(``dataclasses.replace``, as ``bench.py`` does) and ``out["color"]``
carries their gradient: every render-time read of them goes through the
scene passed in.  Hits are detached, as ``ray_tpu``'s traces are
(``stop_gradient``); surface interpolation, BSDF and light math are
recomputed from the scene tables with out-of-place ops, and the only other
detached values are the ones ``ray_tpu`` detaches (light-tree picking
position and tables, the ray-cone footprint).  Stochastic decisions use
detached comparisons.  ``remat=True`` (path replay) is not ported: ROADMAP
Queue 1 item 10.

Render options and scene features this slice does not carry raise
``NotImplementedError`` naming their ROADMAP entry.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ray_tpu_torch._roadmap import not_ported
from ray_tpu_torch.ops import rng
from ray_tpu_torch.ops.linalg import (
    MAX_DIST,
    dot,
    offset_ray,
    power_heuristic,
    safe_div_pos,
)
from ray_tpu_torch.ops.traverse import trace_closest_soa, trace_occlusion_soa
from ray_tpu_torch.render import light_sampling, surface as surface_mod, uber
from ray_tpu_torch.render.bsdf.microfacet import PI
from ray_tpu_torch.render.raygen import generate_primary_rays


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
    # path-replay backprop (checkpointed bounce bodies): ROADMAP item 10
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
    tex_filter: str = "stochastic"
    # count non-finite live-lane state per bounce → out["nonfinite"]
    nan_check: bool = False


class _PathState(NamedTuple):
    ro: torch.Tensor          # (R, 3)
    rd: torch.Tensor          # (R, 3)
    t_max: torch.Tensor       # (R,)
    throughput: torch.Tensor  # (R, 3)
    bsdf_pdf: torch.Tensor    # (R,) pdf of the sampled direction, for MIS
    active: torch.Tensor      # (R,) bool
    depth: torch.Tensor       # (R, 4) i32 diffuse/specular/refraction/transparency
    accum: torch.Tensor       # (R, 3) radiance
    aux_base: torch.Tensor    # (R, 3) base color at the primary hit
    aux_dn: torch.Tensor      # (R, 4) normal + depth at the primary hit


def _clamp_contribution(col, limit: float):
    """Per-contribution energy clamp (limit <= 0 → off)."""
    if limit <= 0.0:
        return col
    s = col.sum(dim=-1, keepdim=True)
    scale = torch.where(s > limit, limit / torch.clamp_min(s, 1e-12), 1.0)
    return col * scale


def _add(acc, contrib, mask):
    """Masked radiance add."""
    return acc + torch.where(mask[:, None], contrib, 0.0)


def _check_supported(scene, settings: PassSettings, cache_mode: str) -> None:
    if scene.mode != "flatten":
        raise not_ported("the two-level TLAS scene mode", "Queue 1 item 17")
    if scene.has_visibility:
        raise not_ported("per-ray-type visibility masks", "Queue 1 item 20")
    if scene.has_transparency:
        raise not_ported("transparency", "Queue 1 item 21")
    if scene.has_textures:
        raise not_ported("textures", "Queue 1 item 16")
    if settings.remat:
        raise not_ported("remat (path-replay backprop)", "Queue 1 item 10")
    if settings.compact_after:
        raise not_ported("occupancy compaction", "Queue 1 item 22")
    if settings.output_sh:
        raise not_ported("the SH-L1 radiance output", "Queue 1 item 33")
    if cache_mode != "off":
        raise not_ported("the spatial radiance cache", "Queue 1 item 24")
    light_sampling.check_light_kinds(scene)


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
    cache_mode: str = "off",
):
    """Render one sample of a (tile_h, tile_w) tile on the scene's device.

    ``iteration`` (≥ 1) and ``rand_seed`` are ints: a sample is a pure
    function of (pixel, iteration, dimension, seed).  ``pixel_mask``:
    optional (R,) bool — False lanes trace nothing.  Returns a dict with
    'color' (R,3) radiance, 'base_color' (R,3), 'depth_normal' (R,4) and
    'rays_traced' (closest + shadow rays, a 0-dim int64 tensor)."""
    _check_supported(scene, settings, cache_mode)
    device = scene.device
    rays = generate_primary_rays(
        cam, filter_table, x0, y0, iteration, rand_seed,
        width=width, height=height, tile_w=tile_w, tile_h=tile_h,
        use_filter_table=use_filter_table, device=device,
    )
    R = tile_w * tile_h
    seed = rng.pixel_seed(rays.px, rays.py, rand_seed)
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
        accum=f32((R, 3), 0.0),
        aux_base=f32((R, 3), 0.0),
        aux_dn=f32((R, 4), 0.0),
    )
    n_traced = torch.zeros((), dtype=torch.int64, device=device)
    nonfinite = torch.zeros((), dtype=torch.int64, device=device)
    for bounce in range(settings.max_total_depth + 1):
        st, n, bad = _bounce(scene, settings, feats, st, bounce, seed,
                             sample_i)
        n_traced = n_traced + n
        if bad is not None:
            nonfinite = nonfinite + bad

    out = {
        "color": st.accum,
        "base_color": st.aux_base,
        "depth_normal": st.aux_dn,
        "rays_traced": n_traced,
    }
    if settings.nan_check:
        out["nonfinite"] = nonfinite
    return out


def _bounce(scene, settings: PassSettings, feats, st: _PathState, bounce: int,
            seed, sample_i: int):
    """One wavefront bounce (``ray_tpu``'s ``bounce_step``).  Returns the
    next state, the number of rays traced (closest + shadow) and, with
    ``nan_check``, the count of non-finite live-lane values."""
    ro, rd, t_max, throughput, bsdf_pdf, active, depth = st[:7]
    accum, aux_base, aux_dn = st.accum, st.aux_base, st.aux_dn
    Rl = ro.shape[0]
    device = ro.device
    have_lights = scene.num_lights > 0
    is_first = bounce == 0
    limit0 = settings.clamp_direct if is_first else settings.clamp_indirect

    total_depth = depth[:, 0] + depth[:, 1] + depth[:, 2]
    hit = trace_closest_soa(
        scene.bvh_soa, scene.tri_soa, ro, rd, torch.zeros_like(t_max), t_max,
        active, max_leaf=scene.max_leaf, stack_size=scene.stack_size,
    )
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
    accum = _add(accum, env_contrib, active & miss & env_keep)

    alive = active & (~miss)

    # ---------- surface attributes (one packed row gather per hit) ----
    tri_row = surface_mod.fetch_tri_row(scene, hit.prim)
    surf = surface_mod.compute_surface(
        scene, hit.prim, hit.u, hit.v, hit.backface, ro, rd, hit.t,
        row=tri_row,
    )
    mat_id = surface_mod.pick_hit_material(scene, hit.prim, hit.backface,
                                           row=tri_row)
    alive = alive & (mat_id >= 0)

    mix_rx, term_r = rng.scrambled_2d_rand(
        rand_dim + rng.RAND_DIM_BSDF_PICK, seed, sample_i)
    ext_ior = torch.ones((Rl,), dtype=torch.float32, device=device)
    mat_id, mix_rand, mix_weight = surface_mod.resolve_mix(
        scene, mat_id, surf.uv, mix_rx, rd, surf.N, ext_ior, hit.backface,
        None,
    )
    surf = surface_mod.apply_normal_map(scene, mat_id, surf, rd, None)
    surf = surface_mod.apply_tangent_rotation(scene, mat_id, surf)

    # path regularization applies once a DIFFUSE bounce is on the path
    # (ShadeRef.cpp:1468); it only reaches the glossy lobes
    reg_alpha = torch.where(depth[:, 0] > 0, settings.regularize_alpha, 0.0)
    params = uber.gather_uber_params(
        scene, mat_id, surf.uv, rd, surf.N, hit.backface, ext_ior, None,
        regularize_alpha=reg_alpha, feats=feats,
    )
    if settings.lighting_only and is_first:
        # lightmap mode: ignore albedo at the primary vertex
        params = params._replace(base_color=torch.ones_like(params.base_color))

    # ---------- emissive hit (ShadeRef.cpp:1502-1539) ----------
    emis_mask = alive & (params.emission.amax(dim=-1) > 0.0)
    mis_w = torch.ones((Rl,), dtype=torch.float32, device=device)
    if settings.use_nee and have_lights:
        lid = surface_mod.hit_light_id(scene, hit.prim, row=tri_row)
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
    accum = _add(accum, emis_contrib, emis_mask & hit_keep)

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
        occluded = trace_occlusion_soa(
            scene.bvh_soa, scene.tri_soa, sh_o, sh_d,
            torch.zeros((Rl,), dtype=torch.float32, device=device),
            sh_dist * 0.999, shadow_active,
            max_leaf=scene.max_leaf, stack_size=scene.stack_size,
        )
        visible = nee_valid & ((~ls.cast_shadow) | (~occluded))
        sh_contrib = _clamp_contribution(throughput * nee_col, limit0)
        accum = _add(accum, sh_contrib, visible)
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

    n = active.sum()
    if n_shadow is not None:
        n = n + n_shadow
    bad = None
    if settings.nan_check:
        # every live-lane quantity the next bounce consumes must be finite
        bad = torch.zeros((), dtype=torch.int64, device=device)
        for arr in (ro, rd, throughput, bsdf_pdf):
            nf = ~torch.isfinite(arr)
            if nf.dim() == 2:
                nf = nf.any(dim=-1)
            bad = bad + (nf & next_active).sum()
        for arr in (accum, aux_base, aux_dn):
            bad = bad + (~torch.isfinite(arr)).any(dim=-1).sum()
    new = _PathState(ro=ro, rd=rd, t_max=t_max, throughput=throughput,
                     bsdf_pdf=bsdf_pdf, active=next_active, depth=depth,
                     accum=accum, aux_base=aux_base, aux_dn=aux_dn)
    return new, n, bad
