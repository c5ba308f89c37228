"""Procedural test geometry (host-side numpy): spheres, boxes, quads.

A copy of ``ray_tpu.utils.geometry`` (numpy only).

Used by tests, samples and benchmarks — the counterpart of the reference's
binary mesh fixtures (tests/test_scene.cpp setup helpers)."""

from __future__ import annotations

import numpy as np


def make_quad(center, u_axis, v_axis):
    """Two-triangle quad spanning ±u, ±v around center. Returns (verts, idx)."""
    c = np.asarray(center, np.float32)
    u = np.asarray(u_axis, np.float32)
    v = np.asarray(v_axis, np.float32)
    verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v]).astype(np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return verts, idx, uvs


def make_uv_sphere(center=(0, 0, 0), radius=1.0, rings=24, segments=48):
    """UV-sphere with smooth normals."""
    c = np.asarray(center, np.float32)
    vs, ns, uvs = [], [], []
    for i in range(rings + 1):
        theta = np.pi * i / rings
        for j in range(segments + 1):
            phi = 2.0 * np.pi * j / segments
            n = np.array(
                [
                    np.sin(theta) * np.cos(phi),
                    np.cos(theta),
                    np.sin(theta) * np.sin(phi),
                ],
                np.float32,
            )
            vs.append(c + radius * n)
            ns.append(n)
            uvs.append([j / segments, i / rings])
    idx = []
    stride = segments + 1
    for i in range(rings):
        for j in range(segments):
            a = i * stride + j
            b = a + stride
            if i != 0:
                idx.append([a, a + 1, b])
            if i != rings - 1:
                idx.append([a + 1, b + 1, b])
    return (
        np.asarray(vs, np.float32),
        np.asarray(idx, np.int32),
        np.asarray(ns, np.float32),
        np.asarray(uvs, np.float32),
    )


def make_box(center=(0, 0, 0), size=(1, 1, 1)):
    """Axis-aligned box with outward flat normals (24 verts)."""
    c = np.asarray(center, np.float32)
    s = 0.5 * np.asarray(size, np.float32)
    verts, norms, idx = [], [], []
    faces = [
        (np.array([1, 0, 0]), np.array([0, 1, 0]), np.array([0, 0, 1])),
        (np.array([-1, 0, 0]), np.array([0, 1, 0]), np.array([0, 0, -1])),
        (np.array([0, 1, 0]), np.array([0, 0, 1]), np.array([1, 0, 0])),
        (np.array([0, -1, 0]), np.array([0, 0, -1]), np.array([1, 0, 0])),
        (np.array([0, 0, 1]), np.array([0, 1, 0]), np.array([-1, 0, 0])),
        (np.array([0, 0, -1]), np.array([0, 1, 0]), np.array([1, 0, 0])),
    ]
    for n, up, right in faces:
        base = len(verts)
        fc = c + n * s
        uu = right * s
        vv = up * s
        for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            verts.append(fc + du * uu + dv * vv)
            norms.append(n.astype(np.float32))
        idx.append([base, base + 2, base + 1])
        idx.append([base, base + 3, base + 2])
    return (
        np.asarray(verts, np.float32),
        np.asarray(idx, np.int32),
        np.asarray(norms, np.float32),
    )
