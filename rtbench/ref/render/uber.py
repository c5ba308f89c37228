"""The uber-BSDF: one superset parameter block evaluated for every hit.

The port of ``ray_tpu.render.uber``: DIFFUSE (Oren-Nayar, uniform-
hemisphere sampled), GLOSSY (the GGX specular lobe alone), REFRACTIVE (the
GGX refraction lobe alone, Fresnel pick probability 0), EMISSIVE,
TRANSPARENT (a straight pass-through tinted by the base color) and
PRINCIPLED (Burley diffuse with sheen, GGX specular, GTR1 clearcoat and
GGX refraction, with the Cycles-style lobe weights).  MIX nodes resolve to
one of these before the uber block (``surface.resolve_mix``).  A node type
pins the lobe weights of the principled superset; evaluation is arithmetic
and selects.  As in ``ray_tpu``, the set of node types in the scene is
static (:class:`MatFeatures`) and lobe families no material can reach are
traced away.  ``ray_tpu``'s one-hot matmul material reads become
``index_select`` reads with the same values.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from rtbench.ref.ops.linalg import dot, lum, safe_div_pos, saturate
from rtbench.ref.render.bsdf import lobes
from rtbench.ref.render.bsdf.microfacet import calc_alpha, fresnel_dielectric_cos
from rtbench.ref.scene.materials import MAT_FLAG_IMP_SAMPLE, ShadingNode
from rtbench.ref.scene.textures import sample_bilinear, texture_lod

# ray types (reference internal/Constants.inl:58-63)
RAY_TYPE_CAMERA = 0
RAY_TYPE_DIFFUSE = 1
RAY_TYPE_SPECULAR = 2
RAY_TYPE_REFR = 3
RAY_TYPE_SHADOW = 4

MAX_CONE_SPREAD_INCREMENT = 0.05  # reference Constants.inl:108


@dataclasses.dataclass(frozen=True)
class MatFeatures:
    """Static per-scene shading features, derived from the set of node
    *types* present (``SceneFlat.mat_types``)."""

    principled: bool = True
    diffuse: bool = True      # a plain DIFFUSE node exists
    glossy: bool = True       # a GLOSSY node exists
    refractive: bool = True   # a REFRACTIVE node exists
    transparent: bool = True  # a TRANSPARENT node exists

    @property
    def any_diffuse(self) -> bool:
        return self.principled or self.diffuse

    @property
    def any_spec(self) -> bool:
        return self.principled or self.glossy

    @property
    def any_refr(self) -> bool:
        return self.principled or self.refractive

    @property
    def coat(self) -> bool:
        return self.principled


def mat_features(mat_types) -> MatFeatures:
    """Features for a static node-type tuple."""
    s = frozenset(int(t) for t in mat_types)
    return MatFeatures(principled=ShadingNode.PRINCIPLED in s,
                       diffuse=ShadingNode.DIFFUSE in s,
                       glossy=ShadingNode.GLOSSY in s,
                       refractive=ShadingNode.REFRACTIVE in s,
                       transparent=ShadingNode.TRANSPARENT in s)


class UberParams(NamedTuple):
    """Resolved, texture-applied shading parameters for a wavefront of hits
    (``ray_tpu``'s block)."""

    # lobe pick weights (normalized)
    w_diffuse: torch.Tensor
    w_specular: torch.Tensor
    w_clearcoat: torch.Tensor
    w_refraction: torch.Tensor
    # diffuse
    use_principled_diffuse: torch.Tensor  # bool: Burley vs Oren-Nayar
    base_color: torch.Tensor              # (R,3)
    sheen_color: torch.Tensor             # (R,3)
    roughness: torch.Tensor
    metallic: torch.Tensor
    transmission: torch.Tensor
    # specular
    spec_col: torch.Tensor                # (R,3)
    spec_col_90: torch.Tensor             # (R,3)
    spec_alpha: torch.Tensor              # (R,2)
    spec_ior: torch.Tensor
    spec_F0: torch.Tensor
    # clearcoat
    coat_roughness2: torch.Tensor
    coat_ior: torch.Tensor
    coat_F0: torch.Tensor
    # transmission
    refr_spec_alpha: torch.Tensor         # (R,2) reflection component alpha
    trans_alpha: torch.Tensor             # (R,2)
    trans_eta: torch.Tensor
    trans_fresnel: torch.Tensor
    int_ior: torch.Tensor
    # emission / passthrough
    emission: torch.Tensor                # (R,3)
    is_emissive: torch.Tensor             # bool
    is_transparent: torch.Tensor          # bool
    imp_sample: torch.Tensor              # bool: emissive geo is NEE-sampled


def _spec_ior_from_specular(specular):
    # 1e-12 floor keeps d(ior)/d(specular) finite at specular == 0
    return (2.0 / (1.0 - torch.sqrt(torch.clamp_min(0.08 * specular, 1e-12)))) - 1.0


def gather_uber_params(scene, mat_id, uv, I, N, backfacing, ext_ior, tex_rand,
                       regularize_alpha=0.0, lam=None, min_roughness=0.0,
                       feats: MatFeatures = None, fetch_kw=None):
    """Gather material columns for each hit and resolve node-type semantics
    into the uber parameter block (reference ShadeRef.cpp:1419-1649).
    ``lam``: optional (R,) ray-cone LOD λ, from which each texture fetch
    derives its mip level; ``fetch_kw``: the stochastic-filter arguments of
    :func:`sample_bilinear`."""
    if feats is None:
        feats = mat_features(scene.mat_types)
    m = scene.materials
    i = torch.clamp_min(mat_id, 0).long()
    R = uv.shape[0]
    dev = uv.device
    zero = torch.zeros((R,), dtype=torch.float32, device=dev)
    one = torch.ones((R,), dtype=torch.float32, device=dev)
    zero2 = torch.zeros((R, 2), dtype=torch.float32, device=dev)
    zero3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)

    def col(name):
        # index_select, not m[name][i]: its backward is one index_add_ per
        # column, where indexing's backward (a sorted index_put_) runs each
        # material's millions of duplicate rows serially on CUDA
        return m[name].index_select(0, i)

    mtype = m["type"][i]
    base_color = col("base_color")
    base_tex = m["base_texture"][i]
    roughness = col("roughness")
    rough_tex = m["roughness_texture"][i]
    strength = col("strength")
    emis_strength = col("emission_strength")
    emission_color = col("emission_color")
    flags = m["flags"][i]
    metallic = specular = specular_tint = transmission = zero
    transmission_roughness = clearcoat = clearcoat_roughness = zero
    sheen = sheen_tint = anisotropic = zero
    mat_ior = one
    if feats.principled:
        metallic = col("metallic")
        specular = col("specular")
        specular_tint = col("specular_tint")
        transmission = col("transmission")
        transmission_roughness = col("transmission_roughness")
        clearcoat = col("clearcoat")
        clearcoat_roughness = col("clearcoat_roughness")
        sheen = 2.0 * col("sheen")
        sheen_tint = col("sheen_tint")
    if feats.any_spec:
        anisotropic = col("anisotropic")
    if feats.any_refr:
        mat_ior = col("ior")

    def _fetch(tex_id):
        if not scene.has_textures:  # static: no fetch at all
            return torch.ones((R, 4), dtype=torch.float32, device=dev)
        lod = None if lam is None else texture_lod(scene.textures, tex_id, lam)
        return sample_bilinear(scene.textures, tex_id, uv, lod,
                               **(fetch_kw or {}))

    tex = _fetch(base_tex)
    base_color = base_color * torch.where((base_tex >= 0)[:, None],
                                          tex[:, :3], 1.0)
    rtex = _fetch(rough_tex)
    roughness = roughness * torch.where(rough_tex >= 0, rtex[:, 0], 1.0)
    if min_roughness > 0.0:  # spatial-cache update pass (ShadeRef.cpp:1450)
        roughness = torch.clamp_min(roughness, min_roughness)

    if feats.principled:
        met_tex = m["metallic_texture"][i]
        mtex = _fetch(met_tex)
        metallic = metallic * torch.where(met_tex >= 0, mtex[:, 0], 1.0)
        spec_tex = m["specular_texture"][i]
        stex = _fetch(spec_tex)
        specular = specular * torch.where(spec_tex >= 0, stex[:, 0], 1.0)

    base_color_lum = lum(base_color)

    is_principled = mtype == ShadingNode.PRINCIPLED
    is_diffuse_node = mtype == ShadingNode.DIFFUSE
    is_glossy = mtype == ShadingNode.GLOSSY
    is_refractive = mtype == ShadingNode.REFRACTIVE
    is_emissive = mtype == ShadingNode.EMISSIVE
    is_transparent = mtype == ShadingNode.TRANSPARENT

    if feats.principled:
        tint_color = torch.where(
            (base_color_lum > 0.0)[:, None],
            base_color / torch.clamp_min(base_color_lum, 1e-12)[:, None],
            0.0,
        )
        # ---- principled parameter derivation (ShadeRef.cpp:1556-1640) ----
        sheen_color = sheen[:, None] * (
            (1.0 - sheen_tint)[:, None] + sheen_tint[:, None] * tint_color
        )
        p_spec_col = (
            (1.0 - specular_tint)[:, None]
            + specular_tint[:, None] * tint_color
        )
        p_spec_col = (
            (1.0 - metallic)[:, None] * (specular[:, None] * 0.08 * p_spec_col)
            + metallic[:, None] * base_color
        )
        p_spec_ior = _spec_ior_from_specular(specular)
        p_spec_F0 = fresnel_dielectric_cos(torch.ones_like(p_spec_ior),
                                           p_spec_ior)

        coat_ior = _spec_ior_from_specular(clearcoat)
        coat_F0 = fresnel_dielectric_cos(torch.ones_like(coat_ior), coat_ior)
        coat_roughness2 = calc_alpha(
            clearcoat_roughness, zero, regularize_alpha
        )[:, 0]

        # approx spec color lum w/ Fresnel toward white (ShadeRef.cpp:1629)
        FN = (
            fresnel_dielectric_cos(dot(I, N, False), p_spec_ior) - p_spec_F0
        ) / torch.clamp_min(1.0 - p_spec_F0, 1e-6)
        approx_spec_col = p_spec_col + FN[:, None] * (1.0 - p_spec_col)
        spec_color_lum = lum(approx_spec_col)

        # Cycles-style lobe weights (ShadeRef.cpp:32-52)
        bcl = base_color_lum + sheen * (1.0 - base_color_lum)
        w_d = bcl * (1.0 - metallic) * (1.0 - transmission)
        final_trans = transmission * (1.0 - metallic)
        w_s = torch.where(
            (specular != 0.0) | (metallic != 0.0),
            spec_color_lum * (1.0 - final_trans), 0.0,
        )
        w_c = 0.25 * clearcoat * (1.0 - metallic)
        w_r = final_trans * bcl
        total = w_d + w_s + w_c + w_r
        inv_total = torch.where(total > 0.0,
                                1.0 / torch.clamp_min(total, 1e-12), 0.0)
        w_d, w_s, w_c, w_r = (w * inv_total for w in (w_d, w_s, w_c, w_r))
    else:
        sheen_color = zero3
        coat_ior = one
        coat_F0 = zero
        coat_roughness2 = zero

    # ---- node-type overrides ----
    w_diffuse = torch.where(is_diffuse_node, one, zero)
    w_specular = torch.where(is_glossy, one, zero) if feats.glossy else zero
    w_clearcoat = zero
    w_refraction = (torch.where(is_refractive, one, zero) if feats.refractive
                    else zero)
    if feats.principled:
        w_diffuse = torch.where(is_principled, w_d, w_diffuse)
        w_specular = torch.where(is_principled, w_s, w_specular)
        w_clearcoat = torch.where(is_principled, w_c, w_clearcoat)
        w_refraction = torch.where(is_principled, w_r, w_refraction)

    if feats.any_spec:
        g_spec_ior = torch.full_like(roughness,
                                     float(_spec_ior_from_specular(
                                         torch.tensor(0.5))))
        g_spec_F0 = fresnel_dielectric_cos(torch.ones_like(g_spec_ior),
                                           g_spec_ior)
        if feats.principled:
            spec_ior = torch.where(is_principled, p_spec_ior, g_spec_ior)
            spec_F0 = torch.where(is_principled, p_spec_F0, g_spec_F0)
            spec_col = torch.where(is_principled[:, None], p_spec_col,
                                   base_color)
            spec_col_90 = torch.where(
                is_principled[:, None], torch.ones_like(base_color),
                base_color)
        else:
            spec_ior = g_spec_ior
            spec_F0 = g_spec_F0
            spec_col = base_color
            spec_col_90 = base_color
        spec_alpha = calc_alpha(roughness, anisotropic, regularize_alpha)
    else:
        spec_ior = one
        spec_F0 = zero
        spec_col = zero3
        spec_col_90 = zero3
        spec_alpha = zero2

    if feats.any_refr:
        eta = torch.where(
            backfacing,
            safe_div_pos(mat_ior, ext_ior),
            safe_div_pos(ext_ior, mat_ior),
        )
        refr_spec_alpha = calc_alpha(roughness, zero, regularize_alpha)
        if feats.principled:
            trans_roughness = (
                1.0 - (1.0 - roughness) * (1.0 - transmission_roughness)
            )
            trans_fresnel = fresnel_dielectric_cos(
                dot(I, N, False), safe_div_pos(torch.ones_like(eta), eta)
            )
            trans_alpha = torch.where(
                is_principled[:, None],
                calc_alpha(trans_roughness, zero, regularize_alpha),
                refr_spec_alpha,
            )
            # a Refractive node always transmits: fresnel pick prob 0
            trans_fresnel = torch.where(is_principled, trans_fresnel, 0.0)
        else:
            trans_alpha = refr_spec_alpha
            trans_fresnel = zero
    else:
        eta = one
        refr_spec_alpha = zero2
        trans_alpha = zero2
        trans_fresnel = zero

    emission = torch.where(
        is_emissive[:, None],
        base_color * strength[:, None],
        emission_color * emis_strength[:, None],
    )
    if feats.principled:
        sheen_color = torch.where(is_principled[:, None], sheen_color, 0.0)
        metallic = torch.where(is_principled, metallic, 0.0)
        transmission = torch.where(is_principled, transmission, 0.0)

    return UberParams(
        w_diffuse=w_diffuse,
        w_specular=w_specular,
        w_clearcoat=w_clearcoat,
        w_refraction=w_refraction,
        use_principled_diffuse=is_principled,
        base_color=base_color,
        sheen_color=sheen_color,
        roughness=roughness,
        metallic=metallic,
        transmission=transmission,
        spec_col=spec_col,
        spec_col_90=spec_col_90,
        spec_alpha=spec_alpha,
        spec_ior=spec_ior,
        spec_F0=spec_F0,
        coat_roughness2=coat_roughness2,
        coat_ior=coat_ior,
        coat_F0=coat_F0,
        refr_spec_alpha=refr_spec_alpha,
        trans_alpha=trans_alpha,
        trans_eta=eta,
        trans_fresnel=trans_fresnel,
        int_ior=mat_ior,
        emission=emission,
        is_emissive=is_emissive,
        is_transparent=is_transparent,
        imp_sample=(flags & MAT_FLAG_IMP_SAMPLE) != 0,
    )


def _eval_diffuse(p: UberParams, V, N, L, feats: MatFeatures):
    """(f_cos, pdf) of the node's diffuse lobe: Burley on principled lanes,
    Oren-Nayar on DIFFUSE lanes."""
    if feats.principled and feats.diffuse:
        f_or, pdf_or = lobes.eval_oren_diffuse(V, N, L, p.roughness,
                                               p.base_color)
        f_pr, pdf_pr = lobes.eval_principled_diffuse(
            V, N, L, p.roughness, p.base_color, p.sheen_color)
        f_dif = torch.where(p.use_principled_diffuse[:, None], f_pr, f_or)
        pdf_dif = torch.where(p.use_principled_diffuse, pdf_pr, pdf_or)
    elif feats.principled:
        f_dif, pdf_dif = lobes.eval_principled_diffuse(
            V, N, L, p.roughness, p.base_color, p.sheen_color)
    else:
        f_dif, pdf_dif = lobes.eval_oren_diffuse(V, N, L, p.roughness,
                                                 p.base_color)
    if feats.principled:
        f_dif = f_dif * ((1.0 - p.metallic) * (1.0 - p.transmission))[:, None]
    return f_dif, pdf_dif


def eval_uber(p: UberParams, T, B, N, I, L,
              feats: MatFeatures = MatFeatures()):
    """Mixture f_cos + pdf for NEE (reference Evaluate_PrincipledNode,
    ShadeRef.cpp:811-903, generalized to all node types)."""
    n_dot_l = dot(N, L, False)
    f_total = torch.zeros_like(p.base_color)
    pdf_total = torch.zeros_like(n_dot_l)

    if feats.any_diffuse:
        f_dif, pdf_dif = _eval_diffuse(p, -I, N, L, feats)
        on = (p.w_diffuse > 0.0) & (n_dot_l > 0.0)
        f_total = f_total + torch.where(on[:, None], f_dif, 0.0)
        pdf_total = pdf_total + torch.where(on, p.w_diffuse * pdf_dif, 0.0)

    if feats.any_spec:
        f_sp, pdf_sp = lobes.eval_ggx_specular(
            T, B, N, I, L, p.spec_alpha, p.spec_ior, p.spec_F0, p.spec_col,
            p.spec_col_90,
        )
        on = (p.w_specular > 0.0) & (n_dot_l > 0.0)
        f_total = f_total + torch.where(on[:, None], f_sp, 0.0)
        pdf_total = pdf_total + torch.where(on, p.w_specular * pdf_sp, 0.0)

    if feats.coat:
        f_cc, pdf_cc = lobes.eval_clearcoat(
            T, B, N, I, L, p.coat_roughness2, p.coat_ior, p.coat_F0
        )
        on = (p.w_clearcoat > 0.0) & (n_dot_l > 0.0)
        f_total = f_total + torch.where(on[:, None], 0.25 * f_cc[:, None], 0.0)
        pdf_total = pdf_total + torch.where(on, p.w_clearcoat * pdf_cc, 0.0)

    if feats.any_refr:
        # refraction: reflective component
        white = torch.ones_like(p.base_color)
        f_rr, pdf_rr = lobes.eval_ggx_specular(
            T, B, N, I, L, p.refr_spec_alpha,
            torch.ones_like(p.spec_ior), torch.zeros_like(p.spec_F0), white,
            white,
        )
        on = (p.w_refraction > 0.0) & (p.trans_fresnel != 0.0) & (n_dot_l > 0.0)
        f_total = f_total + torch.where(
            on[:, None], f_rr * p.trans_fresnel[:, None], 0.0)
        pdf_total = pdf_total + torch.where(
            on, p.w_refraction * p.trans_fresnel * pdf_rr, 0.0)

        # refraction: transmissive component
        f_rt, pdf_rt = lobes.eval_ggx_refraction(
            T, B, N, I, L, p.trans_alpha, p.trans_eta, p.base_color
        )
        on = (p.w_refraction > 0.0) & (p.trans_fresnel != 1.0) & (n_dot_l < 0.0)
        f_total = f_total + torch.where(
            on[:, None], f_rt * (1.0 - p.trans_fresnel)[:, None], 0.0)
        pdf_total = pdf_total + torch.where(
            on, p.w_refraction * (1.0 - p.trans_fresnel) * pdf_rt, 0.0)

    return f_total, pdf_total


class BsdfSample(NamedTuple):
    dir: torch.Tensor          # (R, 3)
    weight: torch.Tensor       # (R, 3) throughput multiplier f_cos/(pdf·P)
    pdf: torch.Tensor          # (R,) pdf for next-hit MIS
    ray_type: torch.Tensor     # (R,) i32
    flip_origin: torch.Tensor  # (R,) bool — offset origin along -plane_N
    cone_spread_inc: torch.Tensor  # (R,) ray-cone spread growth


def sample_uber(p: UberParams, T, B, N, I, rand2, mix_rand,
                feats: MatFeatures = MatFeatures()):
    """Pick one lobe by ``mix_rand`` against the normalized lobe weights and
    sample it (reference Sample_PrincipledNode, ShadeRef.cpp:905-1035)."""
    R = mix_rand.shape[0]
    dev = mix_rand.device
    zero = torch.zeros((R,), dtype=torch.float32, device=dev)
    zero3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    false = torch.zeros((R,), dtype=torch.bool, device=dev)

    cdf_d = p.w_diffuse
    cdf_s = cdf_d + p.w_specular
    cdf_c = cdf_s + p.w_clearcoat

    pick_d = (mix_rand < cdf_d) if feats.any_diffuse else false
    pick_s = ((~pick_d) & (mix_rand < cdf_s)) if feats.any_spec else false
    pick_c = (((~pick_d) & (~pick_s) & (mix_rand < cdf_c)) if feats.coat
              else false)
    pick_r = (((~pick_d) & (~pick_s) & (~pick_c) & (p.w_refraction > 0.0))
              if feats.any_refr else false)

    # --- diffuse ---
    if feats.any_diffuse:
        if feats.principled and feats.diffuse:
            dir_u = lobes.sample_uniform_hemisphere(T, B, N, rand2)
            dir_c = lobes.sample_cosine_hemisphere(T, B, N, rand2)
            dir_dif = torch.where(p.use_principled_diffuse[:, None], dir_c,
                                  dir_u)
        elif feats.principled:
            dir_dif = lobes.sample_cosine_hemisphere(T, B, N, rand2)
        else:
            dir_dif = lobes.sample_uniform_hemisphere(T, B, N, rand2)
        f_dif, pdf_dif = _eval_diffuse(p, -I, N, dir_dif, feats)
        w_dif = f_dif * safe_div_pos(
            1.0, pdf_dif * torch.clamp_min(p.w_diffuse, 1e-9)
        )[:, None]
        pdf_dif_out = pdf_dif * p.w_diffuse
    else:
        dir_dif, w_dif, pdf_dif_out = zero3, zero3, zero

    # --- specular ---
    if feats.any_spec:
        dir_sp, f_sp, pdf_sp = lobes.sample_ggx_specular(
            T, B, N, I, p.spec_alpha, p.spec_ior, p.spec_F0, p.spec_col,
            p.spec_col_90, rand2,
        )
        w_sp = f_sp * safe_div_pos(
            1.0, pdf_sp * torch.clamp_min(p.w_specular, 1e-9)
        )[:, None]
        pdf_sp_out = pdf_sp * p.w_specular
    else:
        dir_sp, w_sp, pdf_sp_out = zero3, zero3, zero

    # --- clearcoat ---
    if feats.coat:
        dir_cc, f_cc, pdf_cc = lobes.sample_clearcoat(
            T, B, N, I, p.coat_roughness2, p.coat_ior, p.coat_F0, rand2
        )
        w_cc = (
            0.25 * f_cc
            * safe_div_pos(1.0, pdf_cc * torch.clamp_min(p.w_clearcoat, 1e-9))
        )[:, None] * torch.ones_like(p.base_color)
        pdf_cc_out = pdf_cc * p.w_clearcoat
    else:
        dir_cc, w_cc, pdf_cc_out = zero3, zero3, zero

    # --- refraction branch: inner split reflect vs refract by fresnel ---
    if feats.any_refr:
        r_inner = saturate(
            safe_div_pos(mix_rand - cdf_c, torch.clamp_min(p.w_refraction, 1e-9))
        )
        pick_rr = pick_r & (r_inner < p.trans_fresnel)   # reflect
        white = torch.ones_like(p.base_color)
        dir_rr, f_rr, pdf_rr = lobes.sample_ggx_specular(
            T, B, N, I, p.refr_spec_alpha,
            torch.ones_like(p.spec_ior), torch.zeros_like(p.spec_F0), white,
            white, rand2,
        )
        dir_rt, f_rt, pdf_rt = lobes.sample_ggx_refraction(
            T, B, N, I, p.trans_alpha, p.trans_eta, p.base_color, rand2
        )
        dir_refr = torch.where(pick_rr[:, None], dir_rr, dir_rt)
        f_refr = torch.where(pick_rr[:, None], f_rr, f_rt)
        pdf_refr = torch.where(pick_rr, pdf_rr, pdf_rt)
        w_refr = f_refr * safe_div_pos(
            1.0, pdf_refr * torch.clamp_min(p.w_refraction, 1e-9)
        )[:, None]
        pdf_refr_out = pdf_refr * p.w_refraction
    else:
        pick_rr = false
        dir_refr, w_refr, pdf_refr_out = zero3, zero3, zero

    def sel(va, vb, vc, vd):
        def m(x):
            return x[:, None] if va.dim() == 2 else x
        return torch.where(m(pick_d), va,
                           torch.where(m(pick_s), vb,
                                       torch.where(m(pick_c), vc, vd)))

    out_dir = sel(dir_dif, dir_sp, dir_cc, dir_refr)
    out_w = sel(w_dif, w_sp, w_cc, w_refr)
    out_pdf = sel(pdf_dif_out, pdf_sp_out, pdf_cc_out, pdf_refr_out)

    # ray-cone spread growth per lobe: full increment for diffuse, scaled
    # by the lobe's min GGX alpha for glossy lobes (ShadeRef.cpp:686-1009)
    inc_refr = torch.where(
        pick_rr,
        p.refr_spec_alpha.amin(dim=-1),
        p.trans_alpha.amin(dim=-1),
    ) if feats.any_refr else zero
    cone_inc = MAX_CONE_SPREAD_INCREMENT * sel(
        torch.ones_like(out_pdf),
        p.spec_alpha.amin(dim=-1) if feats.any_spec else zero,
        p.coat_roughness2,
        inc_refr,
    )
    ray_type = torch.where(
        pick_d, RAY_TYPE_DIFFUSE,
        torch.where(
            pick_s | pick_c | pick_rr, RAY_TYPE_SPECULAR,
            torch.where(pick_r, RAY_TYPE_REFR, 0),
        ),
    ).to(torch.int32)
    flip_origin = pick_r & (~pick_rr)

    if feats.transparent:
        # a Transparent node passes straight through, tinted by its base
        # color (CoreRef.cpp:3143-3145); ray type 5 = transparency
        tr = p.is_transparent
        out_dir = torch.where(tr[:, None], I, out_dir)
        out_w = torch.where(tr[:, None], p.base_color, out_w)
        out_pdf = torch.where(tr, lobes.DELTA_PDF, out_pdf)
        ray_type = torch.where(tr, 5, ray_type).to(torch.int32)
        flip_origin = flip_origin | tr
        cone_inc = torch.where(tr, 0.0, cone_inc)

    # emissive / no-lobe: dead sample
    dead = p.is_emissive | ((~pick_d) & (~pick_s) & (~pick_c) & (~pick_r)
                            & (~p.is_transparent))
    out_w = torch.where(dead[:, None], 0.0, out_w)
    out_pdf = torch.where(dead, 0.0, out_pdf)

    return BsdfSample(
        dir=out_dir, weight=out_w, pdf=out_pdf, ray_type=ray_type,
        flip_origin=flip_origin, cone_spread_inc=cone_inc,
    )
