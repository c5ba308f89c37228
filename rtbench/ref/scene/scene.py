"""Scene container + finalize ("scene compile"), flatten and tlas modes.

A frozen copy of ``ray_tpu_torch.scene.scene``'s builder verbs and
finalize, cut to what the benchmark's configurations use, so a scene
compiles to the port's tables: flatten mode pre-transforms every instance
into one world-space BVH; tlas mode (a mesh instanced more than once)
builds one object-space BVH per mesh, a TLAS over the instances and, past
256 unique triangles, the unified 8-wide table that the traversal walks.
Textures pack into the flat texel table (:mod:`.textures`).  What the
reference does not follow raises: material types other than DIFFUSE,
PRINCIPLED and EMISSIVE, alpha, normal maps, anisotropic rotation, light
types other than spheres (emissive triangles register their own),
sky portals, per-instance visibility, an environment map and compressed
textures.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from rtbench.ref.ops.traverse import INST_LEAF_FLAG
from rtbench.ref.scene import lights as lights_mod
from rtbench.ref.scene.bvh import (
    LEAF_COUNT_BITS,
    LEAF_COUNT_MASK,
    build_bvh2,
    bvh_depth,
    pack_bvh_soa,
    pack_node_columns,
    pack_tri_soa,
    tri_bounds,
)
from rtbench.ref.scene.lights import LightDesc, LightType, pack_lights
from rtbench.ref.scene.materials import MaterialDesc, ShadingNode, pack_materials
from rtbench.ref.scene.textures import TexturePacker
from rtbench.ref.scene.visibility import RAY_ALL
from rtbench.ref.scene.wbvh import build_wtlas, finish_wtlas
from rtbench.ref.utils.device import resolve_device

# ray_tpu adds an 8-wide BVH layout ("wrows_tlas") above this many unique
# triangles
WIDE_BVH_MIN_TRIS = 256
# what the reference follows (the module docstring)
FOLLOWED_MATERIALS = (ShadingNode.DIFFUSE, ShadingNode.PRINCIPLED,
                      ShadingNode.EMISSIVE)
FOLLOWED_LIGHTS = (LightType.SPHERE,)


def _to_torch(x, device):
    """numpy array / dict of arrays / None → tensors on ``device``."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _to_torch(v, device) for k, v in x.items()}
    a = np.array(x, copy=True, order="C")  # keeps 0-dim arrays 0-dim
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass(frozen=True)
class SceneFlat:
    """Frozen, device-resident scene: every array field is a torch tensor
    (or a dict of tensors) on one device.  Field names, layouts and static
    fields are ``ray_tpu.scene.scene.SceneFlat``'s."""

    # geometry (world space)
    vertices: Any        # (V, 3) f32
    normals: Any         # (V, 3) f32 shading normals
    uvs: Any             # (V, 2) f32
    tri_vidx: Any        # (T, 3) i32, in BVH leaf order
    tri_mat: Any         # (T, 2) i32 front/back material ids (-1 = none)
    tri_light: Any       # (T,) i32 light id for emissive tris (-1 = none)
    bvh_soa: Any         # dict of (N,) node columns + packed (N, 14) rows
    tri_soa: Any         # dict of (T,) columns + packed (T, 9), leaf order
    root_lo: Any         # (3,) f32
    root_hi: Any         # (3,) f32
    materials: Any       # dict of SoA columns (differentiable leaves)
    lights: Any          # dict of SoA columns
    textures: Any        # dict: flat texel buffer + records
    env_col: Any         # (3,) f32 multiplier/color
    env_map: Any         # () i32 texture id (-1 = constant color)
    env_rotation: Any    # () f32 y-rotation, radians
    env_marginal_cdf: Any  # (H,) f32
    env_cond_cdf: Any      # (H*W,) f32 row-major
    env_pdf: Any           # (H*W,) f32 solid-angle pdf
    light_tree: Any        # dict of node columns + per-light links
    # static metadata
    max_leaf: int
    num_lights: int
    env_light_index: int
    stack_size: int
    light_kinds: tuple     # per light (type, visible, doublesided, sky_portal)
    env_tab_w: int
    env_tab_h: int
    light_tree_depth: int = 0
    mode: str = "flatten"
    has_visibility: bool = False
    tri_vis: Any = None          # (T,) i32 visibility per leaf tri
    inst: Any = None             # tlas only
    tri_light_local: Any = None  # tlas only
    tri_solid: Any = None        # (T, 2) bool front/back side blocks shadows
    has_transparency: bool = False
    tri_surf: Any = None         # (T, 41) packed per-triangle surface row
    has_textures: bool = True
    has_mix: bool = True
    has_normal_maps: bool = True
    has_aniso_rotation: bool = False
    mat_types: tuple = (0, 1, 2, 3, 4, 5, 6)

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @classmethod
    def from_numpy(cls, arrays: dict, static: dict, device=None) -> "SceneFlat":
        """The scene on ``device`` from numpy ``arrays`` (arrays, dicts of
        arrays or None) and ``static`` fields."""
        device = resolve_device(device)
        kw = {k: _to_torch(v, device) for k, v in arrays.items()}
        kw.update({k: static[k] for k in static})
        return cls(**kw)


# radial-tangent rotation: maps a local position to (-z, 0, x)
# (the reference's "rotate around Y by 90 degrees in 2d", ShadeRef.cpp:1357)
_R90 = np.array([[0.0, 0.0, -1.0],
                 [0.0, 0.0, 0.0],
                 [1.0, 0.0, 0.0]], np.float64)


def _pack_tri_surf(vertices, normals, uvs, tri_vidx, tri_mats, tri_solid,
                   tri_light, tangent_q=None, tangent_q0=None):
    """Per-triangle surface attributes as one (T, 41) f32 row.  Layout:
    p0 p1 p2 (9) | n0 n1 n2 (9) | uv0 uv1 uv2 (6) | mat_f mat_b (2) |
    solid_f solid_b (2) | light (1) | tanq (9) | tanq0 (3).  Int columns
    ride as exact f32 (< 2^24).  ``tangent_q``/``tangent_q0``: the affine
    map from the world hit position to the object-space radial tangent."""
    p = vertices[tri_vidx]            # (T, 3, 3)
    n = normals[tri_vidx]
    t = uvs[tri_vidx]                 # (T, 3, 2)
    T = tri_vidx.shape[0]
    if tangent_q is None:
        tangent_q = np.broadcast_to(_R90, (T, 3, 3))
    if tangent_q0 is None:
        tangent_q0 = np.zeros((T, 3), np.float64)
    return np.concatenate([
        p.reshape(T, 9).astype(np.float32),
        n.reshape(T, 9).astype(np.float32),
        t.reshape(T, 6).astype(np.float32),
        tri_mats.astype(np.float32),
        tri_solid.astype(np.float32),
        tri_light.astype(np.float32)[:, None],
        np.ascontiguousarray(tangent_q.reshape(T, 9)).astype(np.float32),
        np.ascontiguousarray(tangent_q0.reshape(T, 3)).astype(np.float32),
    ], axis=1)


@dataclasses.dataclass
class _Mesh:
    vertices: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray
    tri_mat: np.ndarray  # (T,2) front/back material ids


class Scene:
    """Mutable scene builder (the verbs of ``ray_tpu.scene.scene.Scene``)."""

    def __init__(self):
        self._textures = TexturePacker()
        self._materials: list[MaterialDesc] = []
        self._meshes: list[_Mesh] = []
        self._instances: list[tuple[int, Optional[np.ndarray], int]] = []
        self._lights: list[LightDesc] = []
        self.env_col = np.array([0.0, 0.0, 0.0], np.float32)
        self.env_map = -1
        self.env_rotation = 0.0

    # -- resources ---------------------------------------------------------
    def add_texture(self, image, srgb: bool = False,
                    generate_mips: bool = True, compress: bool = False) -> int:
        """Add an image (H, W, C float in [0, 1] or uint8); returns its
        texture id.  Uncompressed only."""
        if compress:
            raise ValueError("the reference packs no compressed texture")
        return self._textures.add(image, srgb=srgb,
                                  generate_mips=generate_mips,
                                  compress=compress)

    def add_material(self, desc: MaterialDesc) -> int:
        from rtbench.ref.scene.materials import NO_TEXTURE

        if desc.type not in FOLLOWED_MATERIALS:
            raise ValueError(f"the reference follows no material type "
                             f"{desc.type}")
        if (desc.alpha != 1.0 or desc.alpha_texture != NO_TEXTURE
                or desc.normal_map >= 0 or desc.anisotropic_rotation != 0.0):
            raise ValueError("the reference follows no alpha, normal map or "
                             "anisotropic rotation")
        self._materials.append(desc)
        return len(self._materials) - 1

    def add_mesh(
        self,
        vertices,
        indices,
        normals=None,
        uvs=None,
        material: int = 0,
        back_material: Optional[int] = None,
        tri_materials=None,
    ) -> int:
        """Add an indexed triangle mesh.  ``tri_materials``: optional (T, 2)
        per-triangle front/back material ids."""
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        if normals is None:
            normals = compute_vertex_normals(v, idx)
        n = np.asarray(normals, np.float32).reshape(-1, 3)
        if uvs is None:
            uvs = np.zeros((v.shape[0], 2), np.float32)
        uv = np.asarray(uvs, np.float32).reshape(-1, 2)
        if tri_materials is not None:
            tm = np.asarray(tri_materials, np.int32).reshape(-1, 2)
        else:
            bm = material if back_material is None else back_material
            tm = np.tile(
                np.array([[material, bm]], np.int32), (idx.shape[0], 1)
            )
        if tm.shape[0] != idx.shape[0]:
            raise ValueError("tri_materials needs one row per triangle")
        self._meshes.append(_Mesh(v, n, uv, idx, tm))
        return len(self._meshes) - 1

    def add_instance(self, mesh: int, xform=None, visibility: int = None) -> int:
        """Add a mesh instance: 4×4 transform + per-ray-type visibility
        bitmask (scene.visibility; default visible to every ray type)."""
        xf = None if xform is None else np.asarray(xform, np.float32).reshape(4, 4)
        vis = RAY_ALL if visibility is None else int(visibility)
        if vis != RAY_ALL:
            raise ValueError("the reference follows no per-instance visibility")
        self._instances.append((mesh, xf, vis))
        return len(self._instances) - 1

    def add_light(self, desc: LightDesc) -> int:
        if desc.type not in FOLLOWED_LIGHTS or desc.sky_portal:
            raise ValueError(f"the reference follows no light type "
                             f"{desc.type} and no sky portal")
        self._lights.append(desc)
        return len(self._lights) - 1

    def set_environment(self, color=(0, 0, 0), map_id: int = -1,
                        rotation: float = 0.0):
        """A constant environment ``color``; the reference follows no
        environment map (``map_id`` >= 0)."""
        if map_id >= 0:
            raise ValueError("the reference follows no environment map")
        self.env_col = np.asarray(color, np.float32)
        self.env_map = int(map_id)
        self.env_rotation = float(rotation)

    # -- finalize ----------------------------------------------------------
    def finalize(self, max_leaf: int | None = None,
                 light_tree_min_lights: int = 2,
                 instancing: str = "auto", *, device=None) -> SceneFlat:
        """Compile to a :class:`SceneFlat` on ``device`` (default: CUDA).

        ``instancing``: 'flatten' pre-transforms every instance to world
        space and builds one BVH; 'auto' picks it unless a mesh is instanced
        more than once, which needs the two-level TLAS compile.
        ``max_leaf`` defaults to 8 in flatten mode and 4 in tlas mode, as
        in ``ray_tpu``."""
        device = resolve_device(device)
        if not self._instances:
            for m in range(len(self._meshes)):
                self._instances.append((m, None, RAY_ALL))

        if instancing == "auto":
            ids = [i[0] for i in self._instances]
            instancing = "tlas" if len(ids) != len(set(ids)) else "flatten"
        if instancing == "tlas":
            return self._finalize_tlas(
                max_leaf if max_leaf is not None else 4,
                light_tree_min_lights, device)
        if instancing != "flatten":
            raise ValueError(f"unknown instancing mode {instancing!r}")
        return self._finalize_flatten(
            max_leaf if max_leaf is not None else 8,
            light_tree_min_lights, device)

    def _emissive_light_of(self, mat_id: int):
        """TRI-light registration rule: (radiance color, two_sided) for
        emissive importance-sampled materials, else None."""
        mats = self._materials if self._materials else [MaterialDesc()]
        if mat_id < 0 or mat_id >= len(mats):
            return None
        d = mats[mat_id]
        emissive = d.type == ShadingNode.EMISSIVE or (
            d.type == ShadingNode.PRINCIPLED
            and max(d.emission_color) * d.emission_strength > 0.0
        )
        if not (emissive and d.importance_sample):
            return None
        if d.type == ShadingNode.EMISSIVE:
            col = np.asarray(d.base_color) * d.strength
        else:
            col = np.asarray(d.emission_color) * d.emission_strength
        return col, d.two_sided

    def _finalize_flatten(self, max_leaf, light_tree_min_lights, device):
        verts, norms, uvs, tris, tri_mat, tri_vis = [], [], [], [], [], []
        tan_q, tan_q0 = [], []
        voffset = 0
        for mesh_id, xf, vis in self._instances:
            m = self._meshes[mesh_id]
            v, n = m.vertices, m.normals
            nt = m.indices.shape[0]
            if xf is not None:
                r = xf[:3, :3]
                t = xf[:3, 3]
                v = v @ r.T + t
                rinv = np.linalg.inv(np.asarray(r, np.float64))
                n_mat = rinv.T
                n = n @ n_mat.T
                n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
                q = n_mat @ _R90 @ rinv
                q0 = -(q @ np.asarray(t, np.float64))
            else:
                q = _R90
                q0 = np.zeros(3, np.float64)
            tan_q.append(np.broadcast_to(q, (nt, 3, 3)))
            tan_q0.append(np.broadcast_to(q0, (nt, 3)))
            verts.append(v.astype(np.float32))
            norms.append(n.astype(np.float32))
            uvs.append(m.uvs)
            tris.append(m.indices + voffset)
            tri_mat.append(m.tri_mat)
            tri_vis.append(np.full(m.indices.shape[0], vis, np.int32))
            voffset += v.shape[0]
        tangent_q = (np.concatenate(tan_q) if tan_q
                     else np.broadcast_to(_R90, (1, 3, 3)))
        tangent_q0 = (np.concatenate(tan_q0) if tan_q0
                      else np.zeros((1, 3), np.float64))

        vertices = np.concatenate(verts) if verts else np.zeros((3, 3), np.float32)
        normals = np.concatenate(norms) if norms else np.zeros((3, 3), np.float32)
        uv = np.concatenate(uvs) if uvs else np.zeros((3, 2), np.float32)
        tri_vidx = (
            np.concatenate(tris) if tris else np.array([[0, 1, 2]], np.int32)
        )
        tri_mats = (
            np.concatenate(tri_mat) if tri_mat else np.full((1, 2), -1, np.int32)
        )
        tri_viss = (
            np.concatenate(tri_vis) if tri_vis
            else np.full(1, 0x7fffffff, np.int32)
        )
        # BVH over world-space triangles; permute tri arrays to leaf order so
        # the traversal kernel indexes them directly (no extra indirection).
        lo, hi = tri_bounds(vertices, tri_vidx)
        bvh = build_bvh2(lo, hi, max_leaf=max_leaf, fat_leaves=True)
        perm = bvh.prim_indices
        tri_vidx = tri_vidx[perm]
        tri_mats = tri_mats[perm]
        tri_viss = tri_viss[perm]
        tangent_q = tangent_q[perm]
        tangent_q0 = tangent_q0[perm]

        # emissive triangles with importance_sample → TRI lights
        light_descs = list(self._lights)
        tri_areas = {}
        tri_light = np.full(tri_vidx.shape[0], -1, np.int32)
        seen_orig = {}  # original tri id -> light index (SBVH duplicates)
        for t in range(tri_vidx.shape[0]):
            em = self._emissive_light_of(int(tri_mats[t, 0]))
            if em is None:
                continue
            orig_id = int(perm[t])
            if orig_id in seen_orig:
                tri_light[t] = seen_orig[orig_id]
                continue
            col, two_sided = em
            p = vertices[tri_vidx[t]]
            area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
            li = len(light_descs)
            light_descs.append(
                LightDesc(
                    type=LightType.TRI,
                    color=tuple(col),
                    tri_index=int(t),
                    doublesided=two_sided,
                    tri_verts=np.asarray(p, np.float32),
                )
            )
            tri_areas[li] = float(area)
            tri_light[t] = li
            seen_orig[orig_id] = li

        common = self._pack_common(
            light_descs, tri_areas, vertices, tri_vidx, light_tree_min_lights
        )
        tri_solid = np.ones(tri_mats.shape, np.bool_)  # every side blocks shadows
        tri_soa = pack_tri_soa(vertices, tri_vidx)
        bvh_soa = pack_bvh_soa(bvh)
        arrays = {
            "vertices": vertices,
            "normals": normals,
            "uvs": uv,
            "tri_vidx": tri_vidx,
            "tri_mat": tri_mats,
            "tri_light": tri_light,
            "tri_vis": tri_viss,
            "tri_solid": tri_solid,
            "tri_surf": _pack_tri_surf(
                vertices, normals, uv, tri_vidx, tri_mats, tri_solid,
                tri_light, tangent_q=tangent_q, tangent_q0=tangent_q0,
            ),
            "bvh_soa": bvh_soa,
            "tri_soa": tri_soa,
            "root_lo": bvh.root_lo,
            "root_hi": bvh.root_hi,
            **common["arrays"],
        }
        static = {
            "max_leaf": max_leaf,
            "stack_size": bvh_depth(bvh) + 4,
            "mode": "flatten",
            **common["static"],
        }
        return SceneFlat.from_numpy(arrays, static, device)

    def _finalize_tlas(self, max_leaf, light_tree_min_lights, device):
        """Two-level compile (``ray_tpu``'s ``_finalize_tlas``): one
        object-space BVH per mesh shared by its instances, a TLAS over the
        instance boxes, all binary nodes in one code space (TLAS rows
        first), and past 256 unique triangles the unified 8-wide table
        ``wrows_tlas``."""
        meshes = self._meshes
        if not meshes:
            raise ValueError("tlas mode needs at least one mesh")

        # --- per-mesh BLAS (shared by all instances of the mesh) ---
        blas = [None] * len(meshes)
        mesh_used = sorted({m for m, _, _ in self._instances})
        for mi in mesh_used:
            m = meshes[mi]
            lo, hi = tri_bounds(m.vertices, m.indices)
            blas[mi] = build_bvh2(lo, hi, max_leaf=max_leaf, fat_leaves=True)

        # --- concatenated object-space geometry in BLAS leaf order ---
        verts, norms, uvs, tris, tri_mat = [], [], [], [], []
        v_off, t_off = 0, 0
        tri_base = {}
        mesh_emissive = {}  # mesh -> [(leaf-local tri, col, two_sided)]
        tri_light_local_parts = []
        for mi in mesh_used:
            m = meshes[mi]
            perm = blas[mi].prim_indices
            verts.append(m.vertices)
            norms.append(m.normals)
            uvs.append(m.uvs)
            tris.append(m.indices[perm] + v_off)
            tri_mat.append(m.tri_mat[perm])
            tri_base[mi] = t_off
            # per-mesh emissive ordinals (light id = inst light_base + ordinal)
            local = np.full(perm.shape[0], -1, np.int32)
            em_list = []
            seen_orig = {}  # original tri id -> ordinal (SBVH duplicates)
            for t in range(perm.shape[0]):
                em = self._emissive_light_of(int(m.tri_mat[perm[t], 0]))
                if em is None:
                    continue
                orig_id = int(perm[t])
                if orig_id in seen_orig:
                    local[t] = seen_orig[orig_id]
                    continue
                local[t] = len(em_list)
                seen_orig[orig_id] = local[t]
                em_list.append((t, em[0], em[1]))
            mesh_emissive[mi] = em_list
            tri_light_local_parts.append(local)
            v_off += m.vertices.shape[0]
            t_off += perm.shape[0]

        vertices = np.concatenate(verts)
        normals = np.concatenate(norms)
        uv = np.concatenate(uvs)
        tri_vidx = np.concatenate(tris)
        tri_mats = np.concatenate(tri_mat)
        tri_light_local = np.concatenate(tri_light_local_parts)
        if tri_vidx.shape[0] >= (1 << 24):
            raise ValueError("tlas mode caps at 16M unique triangles")

        # --- instance transforms + world AABBs ---
        n_inst = len(self._instances)
        fwd = np.zeros((n_inst, 3, 4), np.float64)   # world-from-object
        inv = np.zeros((n_inst, 3, 4), np.float64)   # object-from-world
        inst_lo = np.zeros((n_inst, 3), np.float32)
        inst_hi = np.zeros((n_inst, 3), np.float32)
        inst_vis = np.zeros(n_inst, np.int32)
        for i, (mi, xf, vis) in enumerate(self._instances):
            A = np.eye(3) if xf is None else np.asarray(xf, np.float64)[:3, :3]
            b = np.zeros(3) if xf is None else np.asarray(xf, np.float64)[:3, 3]
            Ainv = np.linalg.inv(A)
            fwd[i, :, :3], fwd[i, :, 3] = A, b
            inv[i, :, :3], inv[i, :, 3] = Ainv, -Ainv @ b
            rl, rh = blas[mi].root_lo, blas[mi].root_hi
            corners = np.array(
                [[rl[0] if c & 1 else rh[0],
                  rl[1] if c & 2 else rh[1],
                  rl[2] if c & 4 else rh[2]] for c in range(8)]
            )
            wc = corners @ A.T + b
            inst_lo[i] = wc.min(0).astype(np.float32)
            inst_hi[i] = wc.max(0).astype(np.float32)
            inst_vis[i] = vis

        # --- TLAS over instance AABBs (one instance per leaf) ---
        tlas = build_bvh2(inst_lo, inst_hi, max_leaf=1)
        n_tlas = tlas.num_nodes

        def retag_tlas(code):
            if code >= 0:
                return code  # TLAS-internal: stays a low index
            v = -code - 1
            first, count = v >> LEAF_COUNT_BITS, v & LEAF_COUNT_MASK
            if count == 0:
                return -1  # empty leaf: decodes as a 0-count tri leaf
            return -((INST_LEAF_FLAG | int(tlas.prim_indices[first])) + 1)

        tlas_child = np.vectorize(retag_tlas)(tlas.child).astype(np.int32)

        # --- merge node arrays: TLAS rows, then each BLAS with offsets ---
        node_base = {}
        all_lo = [tlas.child_lo]
        all_hi = [tlas.child_hi]
        all_child = [tlas_child]
        base = n_tlas
        for mi in mesh_used:
            b = blas[mi]
            node_base[mi] = base
            c = b.child
            internal = c >= 0
            v = -c - 1
            first = (v >> LEAF_COUNT_BITS) + tri_base[mi]
            count = v & LEAF_COUNT_MASK
            leaf_new = -(((first << LEAF_COUNT_BITS) | count) + 1)
            all_child.append(
                np.where(internal, c + base,
                         np.where(count > 0, leaf_new, -1)).astype(np.int32)
            )
            all_lo.append(b.child_lo)
            all_hi.append(b.child_hi)
            base += b.num_nodes
        nodes_soa = pack_node_columns(
            np.concatenate(all_lo), np.concatenate(all_hi),
            np.concatenate(all_child),
        )
        tri_soa = pack_tri_soa(vertices, tri_vidx)

        # the unified wide two-level table, the one the traversal walks
        if tri_vidx.shape[0] > WIDE_BVH_MIN_TRIS:
            wt, mesh_root, wbase = build_wtlas(
                tlas, tlas.prim_indices, inv.astype(np.float32), inst_vis,
                [blas[mi] for mi in mesh_used], mesh_used, tri_base,
                tri_soa["packed"], max_leaf,
            )
            finish_wtlas(wt, [mi for mi, _, _ in self._instances],
                         mesh_root, wbase)
            nodes_soa["wrows_tlas"] = wt["wrows_tlas"]
            nodes_soa["winst_base"] = np.int32(wbase)

        # --- per-instance columns for the shading transforms ---
        inst_cols = {"vis": inst_vis}
        inst_cols["blas_root"] = np.array(
            [node_base[mi] for mi, _, _ in self._instances], np.int32
        )
        for r in range(3):
            for c in range(3):
                inst_cols[f"inv{r}{c}"] = inv[:, r, c].astype(np.float32)
                inst_cols[f"m{r}{c}"] = fwd[:, r, c].astype(np.float32)
        for ax, name in enumerate("xyz"):
            inst_cols[f"invt{name}"] = inv[:, ax, 3].astype(np.float32)
            inst_cols[f"mt{name}"] = fwd[:, ax, 3].astype(np.float32)

        # --- per-instance TRI lights from emissive mesh triangles ---
        light_descs = list(self._lights)
        tri_areas = {}
        light_base = np.zeros(n_inst, np.int32)
        for i, (mi, xf, vis) in enumerate(self._instances):
            light_base[i] = len(light_descs)
            A, b = fwd[i, :, :3], fwd[i, :, 3]
            for t_local, col, two_sided in mesh_emissive[mi]:
                perm = blas[mi].prim_indices
                p_obj = meshes[mi].vertices[meshes[mi].indices[perm[t_local]]]
                p = (p_obj @ A.T + b).astype(np.float32)
                area = 0.5 * np.linalg.norm(
                    np.cross(p[1] - p[0], p[2] - p[0])
                )
                li = len(light_descs)
                light_descs.append(
                    LightDesc(
                        type=LightType.TRI,
                        color=tuple(np.asarray(col, np.float64)),
                        tri_index=int(tri_base[mi] + t_local),
                        doublesided=two_sided,
                        tri_verts=p,
                    )
                )
                tri_areas[li] = float(area)
        inst_cols["light_base"] = light_base

        common = self._pack_common(
            light_descs, tri_areas, vertices, tri_vidx, light_tree_min_lights
        )
        tri_solid = np.ones(tri_mats.shape, np.bool_)  # every side blocks shadows
        max_blas_depth = max(bvh_depth(blas[mi]) for mi in mesh_used)
        arrays = {
            "vertices": vertices,
            "normals": normals,
            "uvs": uv,
            "tri_vidx": tri_vidx,
            "tri_mat": tri_mats,
            "tri_light": np.full(tri_vidx.shape[0], -1, np.int32),
            "tri_light_local": tri_light_local,
            "tri_solid": tri_solid,
            "tri_surf": _pack_tri_surf(
                vertices, normals, uv, tri_vidx, tri_mats, tri_solid,
                tri_light_local,
            ),
            "bvh_soa": nodes_soa,
            "tri_soa": tri_soa,
            "root_lo": tlas.root_lo,
            "root_hi": tlas.root_hi,
            "inst": inst_cols,
            **common["arrays"],
        }
        static = {
            "max_leaf": max_leaf,
            "stack_size": bvh_depth(tlas) + max_blas_depth + 6,
            "mode": "tlas",
            **common["static"],
        }
        return SceneFlat.from_numpy(arrays, static, device)

    def _pack_common(self, light_descs, tri_areas, vertices, tri_vidx,
                     light_tree_min_lights):
        """Mode-independent tail of finalize: env light + material/light/
        texture tables + light tree + env importance tables."""
        env_light_index = -1
        if float(np.max(self.env_col)) > 0.0:
            env_light_index = len(light_descs)
            light_descs.append(
                LightDesc(type=LightType.ENV, color=tuple(self.env_col))
            )

        materials = pack_materials(self._materials)
        lights = pack_lights(light_descs, tri_areas)

        light_tree_depth = 0
        if len(light_descs) >= light_tree_min_lights:
            from rtbench.ref.scene.light_tree import (
                build_light_tree,
                light_bounds_and_cones,
            )

            bounds = light_bounds_and_cones(
                light_descs, vertices, tri_vidx, tri_areas, env_mean_lum=1.0)
            light_tree, light_tree_depth = build_light_tree(bounds)
        else:
            light_tree = {
                "lo": np.zeros((1, 3), np.float32),
                "hi": np.zeros((1, 3), np.float32),
                "axis": np.zeros((1, 3), np.float32),
                "flux": np.zeros(1, np.float32),
                "omega_n": np.zeros(1, np.float32),
                "omega_e": np.zeros(1, np.float32),
                "left": np.full(1, -1, np.int32),
                "right": np.full(1, -1, np.int32),
                "parent": np.full(1, -1, np.int32),
                "side": np.zeros(1, np.int32),
                "leaf_node": np.zeros(max(len(light_descs), 1), np.int32),
            }

        # no environment map: ray_tpu's placeholder importance tables
        env_marginal = np.ones(1, np.float32)
        env_cond = np.ones(1, np.float32)
        env_pdf = np.full(1, 0.25 / np.pi, np.float32)
        env_tab_h = env_tab_w = 0

        return {
            "arrays": {
                "materials": materials,
                "lights": lights,
                "textures": self._textures.pack(),
                "env_col": self.env_col,
                "env_map": np.int32(self.env_map),
                "env_rotation": np.float32(self.env_rotation),
                "env_marginal_cdf": env_marginal,
                "env_cond_cdf": env_cond,
                "env_pdf": env_pdf,
                "light_tree": light_tree,
            },
            "static": {
                "num_lights": len(light_descs),
                "env_light_index": env_light_index,
                "has_textures": len(self._textures.num_mips) > 0,
                "has_mix": any(
                    d.type == ShadingNode.MIX for d in self._materials
                ),
                "has_normal_maps": any(
                    d.normal_map >= 0 for d in self._materials
                ),
                "has_aniso_rotation": any(
                    d.anisotropic_rotation != 0.0 for d in self._materials
                ),
                "mat_types": tuple(
                    sorted({int(d.type) for d in self._materials})
                ) or (ShadingNode.DIFFUSE,),
                "light_kinds": tuple(
                    (int(d.type), lights_mod.effective_visible(d),
                     bool(d.doublesided), bool(d.sky_portal))
                    for d in light_descs
                ),
                "env_tab_w": env_tab_w,
                "env_tab_h": env_tab_h,
                "light_tree_depth": light_tree_depth,
            },
        }


def compute_vertex_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    p = vertices[indices]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    out = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(out, indices[:, k], fn)
    norm = np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    return (out / norm).astype(np.float32)
