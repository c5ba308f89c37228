"""Hierarchical light tree for many-light NEE (host-side build).

A copy of ``ray_tpu.scene.light_tree`` (numpy only): the port builds the
same tables without importing the JAX package.

TPU-native re-design of the reference's light BVH
(internal/SceneCPU.cpp:1214-1520 ``RebuildLightTree_nolock`` +
internal/Core.cpp:859 flatten): a *binary* SAH tree over per-light bounds
carrying {flux, axis, normal-cone angle ω_n, emission angle ω_e} per node —
the quantities ``calc_lnode_importance`` (internal/CoreRef.cpp:870) needs for
stochastic descent.  The reference flattens to an 8-wide quantized cwbvh so
one SIMD op tests 8 children; on TPU the whole *wavefront* is the vector
axis, so a binary tree with compute-both-children-select per step is the
natural layout (two gathers per level instead of a horizontal 8-lane reduce).

The tree is emitted as flat SoA columns (one row per node) plus per-node
``parent``/``side`` links and a per-light ``leaf_node`` map so MIS factors
can be re-evaluated by walking leaf→root (the analogue of the reference's
root→leaf re-descent in ``EvalTriLightFactor``, internal/CoreRef.cpp:4594).

Everything here runs once at Finalize in numpy; the device-side descent and
pdf evaluation live in ray_tpu_torch/render/light_sampling.py.
"""

from __future__ import annotations

import math

import numpy as np

MAX_DIST = 3.402823466e30


def light_bounds_and_cones(descs, scene_vertices, scene_tri_vidx, tri_areas,
                           env_mean_lum: float = 1.0):
    """Per-light AABB + emission cone + flux (SceneCPU.cpp:1246-1358).

    Returns dict of numpy arrays over the light list: lo, hi (L,3), axis
    (L,3), omega_n, omega_e, flux (L,).
    """
    from rtbench.ref.scene.lights import LightType

    n = len(descs)
    lo = np.zeros((n, 3), np.float64)
    hi = np.zeros((n, 3), np.float64)
    axis = np.zeros((n, 3), np.float64)
    omega_n = np.zeros(n, np.float64)
    omega_e = np.zeros(n, np.float64)
    flux = np.zeros(n, np.float64)

    for i, d in enumerate(descs):
        col = np.asarray(d.color, np.float64)
        lum = float(col.sum())
        area = 1.0
        ax = np.array([0.0, 1.0, 0.0])
        on, oe = 0.0, 0.0
        pos = np.asarray(d.position, np.float64)
        if d.type == LightType.SPHERE:
            r = max(d.radius, 0.0)
            lo[i] = pos - r
            hi[i] = pos + r
            if r > 0.0:
                area = 4.0 * math.pi * r * r
            on, oe = math.pi, 0.5 * math.pi
        elif d.type == LightType.TRI:
            if d.tri_verts is not None:
                p = np.asarray(d.tri_verts, np.float64)
            else:
                p = scene_vertices[scene_tri_vidx[d.tri_index]].astype(np.float64)
            lo[i] = p.min(0)
            hi[i] = p.max(0)
            fwd = np.cross(p[1] - p[0], p[2] - p[0])
            l = np.linalg.norm(fwd)
            area = 0.5 * l
            ax = fwd / max(l, 1e-12)
            on = math.pi if d.doublesided else 0.0
            oe = 0.5 * math.pi
        elif d.type == LightType.ENV:
            lum = (lum / 3.0) * float(env_mean_lum)
            lo[i] = -MAX_DIST
            hi[i] = MAX_DIST
            on, oe = math.pi, 0.5 * math.pi
        axis[i] = ax
        omega_n[i] = on
        omega_e[i] = oe
        flux[i] = lum * max(area, 0.0)

    return {
        "lo": lo, "hi": hi, "axis": axis,
        "omega_n": omega_n, "omega_e": omega_e, "flux": flux,
    }


def _sah_split(lo, hi, ids):
    """Best axis+position binary split by surface-area heuristic (sweep).
    Returns (left_ids, right_ids) or None for a forced median split."""
    if len(ids) == 2:
        return ids[:1], ids[1:]
    c = 0.5 * (lo[ids] + hi[ids])
    best = None
    for ax in range(3):
        order = ids[np.argsort(c[:, ax], kind="stable")]
        slo, shi = lo[order], hi[order]
        # prefix/suffix bounds; clip so infinite (MAX_DIST) boxes don't
        # overflow the area products
        pre_lo = np.minimum.accumulate(slo, 0)
        pre_hi = np.maximum.accumulate(shi, 0)
        suf_lo = np.minimum.accumulate(slo[::-1], 0)[::-1]
        suf_hi = np.maximum.accumulate(shi[::-1], 0)[::-1]

        def _area(alo, ahi):
            e = np.clip(ahi - alo, 0.0, 1e32)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        k = len(order)
        counts = np.arange(1, k, dtype=np.float64)
        cost = counts * _area(pre_lo, pre_hi)[:-1] + (
            (k - counts) * _area(suf_lo, suf_hi)[1:]
        )
        j = int(np.argmin(cost))
        if best is None or cost[j] < best[0]:
            best = (cost[j], order[: j + 1], order[j + 1:])
    return best[1], best[2]


def build_light_tree(bounds: dict) -> dict:
    """Build the binary light BVH and propagate flux/cones bottom-up
    (SceneCPU.cpp:1375-1460).  Returns flat SoA columns:

      per node: lo/hi/axis (3 cols each), flux, omega_n, omega_e,
                left, right (i32; >=0 internal child, <0 → leaf light
                ~code), parent (i32, -1 at root), side (i32 0/1)
      per light: leaf_node (L,) i32 node id whose subtree is that light
      depth: static int — max root→leaf edge count
    """
    L = bounds["flux"].shape[0]
    nodes = []  # dicts

    def new_node():
        nodes.append({
            "lo": np.zeros(3), "hi": np.zeros(3), "axis": np.zeros(3),
            "flux": 0.0, "omega_n": 0.0, "omega_e": 0.0,
            "left": 0, "right": 0, "light": -1,
        })
        return len(nodes) - 1

    def build(ids):
        ni = new_node()
        nd = nodes[ni]
        nd["lo"] = bounds["lo"][ids].min(0)
        nd["hi"] = bounds["hi"][ids].max(0)
        if len(ids) == 1:
            i = int(ids[0])
            nd["light"] = i
            nd["axis"] = bounds["axis"][i]
            nd["flux"] = float(bounds["flux"][i])
            nd["omega_n"] = float(bounds["omega_n"][i])
            nd["omega_e"] = float(bounds["omega_e"][i])
            return ni, 0
        l_ids, r_ids = _sah_split(bounds["lo"], bounds["hi"], ids)
        li, dl = build(l_ids)
        ri, dr = build(r_ids)
        nd = nodes[ni]
        nd["left"], nd["right"] = li, ri
        # cone merge (SceneCPU.cpp:1427-1455): fold each child in turn
        for ci in (li, ri):
            c = nodes[ci]
            nd["flux"] += c["flux"]
            if np.linalg.norm(nd["axis"]) == 0.0:
                nd["axis"] = c["axis"].copy()
                nd["omega_n"] = c["omega_n"]
            else:
                a1, a2 = nd["axis"], c["axis"]
                angle = math.acos(float(np.clip(np.dot(a1, a2), -1.0, 1.0)))
                s = a1 + a2
                sl = np.linalg.norm(s)
                nd["axis"] = s / sl if sl != 0.0 else np.array([0.0, 1.0, 0.0])
                nd["omega_n"] = min(
                    0.5 * (nd["omega_n"]
                           + max(nd["omega_n"], angle + c["omega_n"])),
                    math.pi,
                )
            nd["omega_e"] = max(nd["omega_e"], c["omega_e"])
        return ni, max(dl, dr) + 1

    root, depth = build(np.arange(L))
    assert root == 0

    n = len(nodes)
    out = {
        "lo": np.stack([nd["lo"] for nd in nodes]).astype(np.float32),
        "hi": np.stack([nd["hi"] for nd in nodes]).astype(np.float32),
        "axis": np.stack([nd["axis"] for nd in nodes]).astype(np.float32),
        "flux": np.array([nd["flux"] for nd in nodes], np.float32),
        "omega_n": np.array([nd["omega_n"] for nd in nodes], np.float32),
        "omega_e": np.array([nd["omega_e"] for nd in nodes], np.float32),
    }
    left = np.zeros(n, np.int32)
    right = np.zeros(n, np.int32)
    parent = np.full(n, -1, np.int32)
    side = np.zeros(n, np.int32)
    leaf_node = np.zeros(L, np.int32)
    for i, nd in enumerate(nodes):
        if nd["light"] >= 0:
            leaf_node[nd["light"]] = i
            left[i] = ~np.int32(nd["light"])  # leaf code
            right[i] = ~np.int32(nd["light"])
        else:
            left[i] = nd["left"]
            right[i] = nd["right"]
            parent[nd["left"]] = i
            parent[nd["right"]] = i
            side[nd["right"]] = 1
    out.update(left=left, right=right, parent=parent, side=side,
               leaf_node=leaf_node)
    return out, depth
