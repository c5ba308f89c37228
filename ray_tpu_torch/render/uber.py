"""The uber-BSDF: one superset parameter block evaluated for every hit.

The port of ``ray_tpu.render.uber`` for the node types this slice carries:
DIFFUSE (Oren-Nayar, uniform-hemisphere sampled) and EMISSIVE.  As in
``ray_tpu``, the set of node types in the scene is static
(:class:`MatFeatures`) and lobe families no material can reach are traced
away; a scene with GLOSSY, REFRACTIVE, MIX, TRANSPARENT or PRINCIPLED
nodes raises (ROADMAP Queue 1 item 29).  ``ray_tpu``'s one-hot matmul
material reads become plain indexing with the same values.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ray_tpu_torch._roadmap import not_ported
from ray_tpu_torch.ops.linalg import dot, safe_div_pos
from ray_tpu_torch.render.bsdf import lobes
from ray_tpu_torch.scene.materials import MAT_FLAG_IMP_SAMPLE, ShadingNode

# ray types (reference internal/Constants.inl:58-63)
RAY_TYPE_CAMERA = 0
RAY_TYPE_DIFFUSE = 1
RAY_TYPE_SPECULAR = 2
RAY_TYPE_REFR = 3
RAY_TYPE_SHADOW = 4

_PORTED_NODES = frozenset({ShadingNode.DIFFUSE, ShadingNode.EMISSIVE})


@dataclasses.dataclass(frozen=True)
class MatFeatures:
    """Static per-scene shading features, derived from the set of node
    *types* present (``SceneFlat.mat_types``)."""

    principled: bool = True
    diffuse: bool = True      # a plain DIFFUSE node exists
    glossy: bool = True
    refractive: bool = True
    transparent: bool = True

    @property
    def any_diffuse(self) -> bool:
        return self.principled or self.diffuse


def mat_features(mat_types) -> MatFeatures:
    """Features for a static node-type tuple.  Raises for node types the
    port does not carry yet."""
    s = frozenset(int(t) for t in mat_types)
    missing = s - _PORTED_NODES
    if missing:
        names = sorted(k for k, v in vars(ShadingNode).items()
                       if not k.startswith("_") and v in missing)
        raise not_ported(f"material node types {names}", "Queue 1 item 29")
    return MatFeatures(
        principled=False,
        diffuse=ShadingNode.DIFFUSE in s,
        glossy=False,
        refractive=False,
        transparent=False,
    )


class UberParams(NamedTuple):
    """Resolved shading parameters for a wavefront of hits (the fields of
    ``ray_tpu``'s block that the ported node types use)."""

    w_diffuse: torch.Tensor
    base_color: torch.Tensor             # (R,3)
    roughness: torch.Tensor
    int_ior: torch.Tensor
    emission: torch.Tensor               # (R,3)
    is_emissive: torch.Tensor            # bool
    is_transparent: torch.Tensor         # bool
    imp_sample: torch.Tensor             # bool: emissive geo is NEE-sampled


def gather_uber_params(scene, mat_id, uv, I, N, backfacing, ext_ior, tex_rand,
                       regularize_alpha=0.0, lam=None, min_roughness=0.0,
                       feats: MatFeatures = None, fetch_kw=None):
    """Gather material columns for each hit and resolve node-type semantics
    into the uber parameter block (reference ShadeRef.cpp:1419-1649)."""
    if feats is None:
        feats = mat_features(scene.mat_types)
    if scene.has_textures:
        raise not_ported("textures", "Queue 1 item 16")
    m = scene.materials
    i = torch.clamp_min(mat_id, 0).long()

    mtype = m["type"][i]
    # index_select, not m[...][i]: its backward is one index_add_ per column,
    # where indexing's backward (a sorted index_put_) runs each material's
    # millions of duplicate rows serially on CUDA
    base_color = m["base_color"].index_select(0, i)
    roughness = m["roughness"].index_select(0, i)
    strength = m["strength"].index_select(0, i)
    emis_strength = m["emission_strength"].index_select(0, i)
    emission_color = m["emission_color"].index_select(0, i)
    flags = m["flags"][i]
    if min_roughness > 0.0:  # spatial-cache update pass (ShadeRef.cpp:1450)
        roughness = torch.clamp_min(roughness, min_roughness)

    is_emissive = mtype == ShadingNode.EMISSIVE
    one = torch.ones_like(roughness)
    zero = torch.zeros_like(roughness)
    w_diffuse = torch.where(mtype == ShadingNode.DIFFUSE, one, zero)

    emission = torch.where(
        is_emissive[:, None],
        base_color * strength[:, None],
        emission_color * emis_strength[:, None],
    )
    return UberParams(
        w_diffuse=w_diffuse,
        base_color=base_color,
        roughness=roughness,
        int_ior=one,
        emission=emission,
        is_emissive=is_emissive,
        is_transparent=mtype == ShadingNode.TRANSPARENT,
        imp_sample=(flags & MAT_FLAG_IMP_SAMPLE) != 0,
    )


def eval_uber(p: UberParams, T, B, N, I, L, feats: MatFeatures):
    """Mixture f_cos + pdf for NEE (reference Evaluate_*Node)."""
    n_dot_l = dot(N, L, False)
    f_total = torch.zeros_like(p.base_color)
    pdf_total = torch.zeros_like(n_dot_l)
    if feats.any_diffuse:
        f_dif, pdf_dif = lobes.eval_oren_diffuse(
            -I, N, L, p.roughness, p.base_color
        )
        on = (p.w_diffuse > 0.0) & (n_dot_l > 0.0)
        f_total = f_total + torch.where(on[:, None], f_dif, 0.0)
        pdf_total = pdf_total + torch.where(on, p.w_diffuse * pdf_dif, 0.0)
    return f_total, pdf_total


class BsdfSample(NamedTuple):
    dir: torch.Tensor          # (R, 3)
    weight: torch.Tensor       # (R, 3) throughput multiplier f_cos/(pdf·P)
    pdf: torch.Tensor          # (R,) pdf for next-hit MIS
    ray_type: torch.Tensor     # (R,) i32
    flip_origin: torch.Tensor  # (R,) bool — offset origin along -plane_N
    cone_spread_inc: torch.Tensor  # (R,) ray-cone spread growth


def sample_uber(p: UberParams, T, B, N, I, rand2, mix_rand,
                feats: MatFeatures):
    """Pick one lobe by ``mix_rand`` against the normalized lobe weights and
    sample it (reference Sample_*Node)."""
    R = mix_rand.shape[0]
    zero = torch.zeros((R,), dtype=torch.float32, device=mix_rand.device)
    zero3 = torch.zeros((R, 3), dtype=torch.float32, device=mix_rand.device)

    if feats.any_diffuse:
        pick_d = mix_rand < p.w_diffuse
        dir_dif = lobes.sample_uniform_hemisphere(T, B, N, rand2)
        f_dif, pdf_dif = lobes.eval_oren_diffuse(
            -I, N, dir_dif, p.roughness, p.base_color
        )
        w_dif = f_dif * safe_div_pos(
            1.0, pdf_dif * torch.clamp_min(p.w_diffuse, 1e-9)
        )[:, None]
        pdf_dif_out = pdf_dif * p.w_diffuse
    else:
        pick_d = torch.zeros((R,), dtype=torch.bool, device=mix_rand.device)
        dir_dif, w_dif, pdf_dif_out = zero3, zero3, zero

    # the other lobes (specular, clearcoat, refraction) are not reachable
    # with the ported node types: a lane that does not pick diffuse is dead
    out_dir = torch.where(pick_d[:, None], dir_dif, zero3)
    out_w = torch.where(pick_d[:, None], w_dif, zero3)
    out_pdf = torch.where(pick_d, pdf_dif_out, zero)

    MAX_CONE_SPREAD_INCREMENT = 0.05
    cone_inc = MAX_CONE_SPREAD_INCREMENT * torch.where(
        pick_d, torch.ones_like(out_pdf), zero)
    ray_type = torch.where(pick_d, RAY_TYPE_DIFFUSE, 0).to(torch.int32)
    flip_origin = torch.zeros_like(pick_d)

    # emissive / no-lobe: dead sample
    dead = p.is_emissive | (~pick_d)
    out_w = torch.where(dead[:, None], 0.0, out_w)
    out_pdf = torch.where(dead, 0.0, out_pdf)

    return BsdfSample(
        dir=out_dir, weight=out_w, pdf=out_pdf, ray_type=ray_type,
        flip_origin=flip_origin, cone_spread_inc=cone_inc,
    )
