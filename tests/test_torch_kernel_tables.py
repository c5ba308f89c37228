"""The host-side tables of the binned and two-level kernels, on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py); what they are
given is built here, and these tests hold it:

* ``subtree_tree`` over the subtree boxes of the 20,000-triangle generator
  cloud (tests/test_traverse_pallas.py's, seed 7, the one
  tests/test_torch_cuda.py traces): every sid in exactly one leaf, each
  leaf its subtree's box bit for bit, each inner box the exact NaN-ignoring
  min / max of its members' boxes; the depth fits the kernel's search
  stack, a budget of ceil(log2 S) levels is met, and one level less
  raises.
* The pruning lemma the kernel's search rests on, with the port's own
  ``_aabb_c``: on seeded rays (caps and ``t_min`` > 0 included, zero and
  NaN direction components, NaN origins, which miss every box) and on
  boxes with inverted and flat members, a member box that is hit means its
  node is hit, with
  ``tn(node) <= tn(member)`` and ``tf(node) >= tf(member)``; the sort key's
  arithmetic (``binned_sort_key_plain``'s) likewise.
* ``binned_rows``: the row-major slab copy holds exactly the bits of
  ``slab_f`` / ``slab_i``; the wrapper builds it once per scene.
* ``check_tlas_rows``: ``trace_tlas``'s kernel reads 16-byte rows, so a
  width that is not a multiple of 4 floats (or a base that is not 16-byte
  aligned) gets a cached copy padded with zero columns; every ``max_leaf``
  in [1, 15] is taken.
* ``cuda_build.source_hash``: a kernel library's name covers its source
  and every ``csrc/*.cuh`` header, so an edited header is rebuilt.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import traverse as tt
from ray_tpu_torch.scene.binned import (
    CF,
    CI,
    PICK_STACK,
    SUB_ROWS,
    SUB_SEGS,
    pack_binned_scene,
    subtree_tree,
)
from ray_tpu_torch.scene.bvh import build_bvh2, pack_tri_soa, tri_bounds

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cloud():
    """The 20,000-triangle cloud (native builder, max_leaf 4) packed into
    subtree slabs."""
    r = np.random.RandomState(7)
    n = 20_000
    tris = ((r.rand(n, 1, 3) - 0.5) * 10.0
            + (r.rand(n, 3, 3) - 0.5) * max(0.8, 12.0 / np.sqrt(n)))
    v = tris.reshape(-1, 3).astype(np.float32)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    bvh = build_bvh2(*tri_bounds(v, idx), max_leaf=4)
    binned = pack_binned_scene(bvh, pack_tri_soa(v, idx[bvh.prim_indices]))
    assert binned["slab_i"].shape[0] // CI > 32
    return binned


def _ranges(tree):
    """(node, a, b) of every node of a subtree tree (preorder), walked as
    the kernel walks it: children at k+1 and k + 2(m-a), m the split."""
    out, todo = [], [(0, 0, (tree.shape[0] + 1) // 2)]
    while todo:
        k, a, b = todo.pop()
        out.append((k, a, b))
        if b - a > 1:
            m = int(tree[k].view(np.int32)[6])
            assert a < m < b
            todo += [(k + 1, a, m), (k + 2 * (m - a), m, b)]
    return sorted(out)


def _odd_boxes(S, seed):
    """Random boxes, every 5th flat in y, every 7th inverted."""
    r = np.random.RandomState(seed)
    lo = (r.rand(S, 3) * 10.0).astype(np.float32)
    hi = lo + (r.rand(S, 3) * 3.0).astype(np.float32)
    hi[::5, 1] = lo[::5, 1]
    lo[::7], hi[::7] = hi[::7].copy(), lo[::7].copy()
    return lo, hi


def test_subtree_tree_covers_every_sid_with_exact_boxes(cloud):
    for lo, hi in ((cloud["sub_lo"], cloud["sub_hi"]), _odd_boxes(45, 1)):
        S = lo.shape[0]
        tree, depth = subtree_tree(lo, hi)
        assert tree.shape == (2 * S - 1, 8) and tree.dtype == np.float32
        nodes = _ranges(tree)
        assert [k for k, _, _ in nodes] == list(range(2 * S - 1))
        leaves = sorted(a for _, a, b in nodes if b - a == 1)
        assert leaves == list(range(S))
        assert not tree[:, 7].any()
        for k, a, b in nodes:
            if b - a == 1:
                np.testing.assert_array_equal(tree[k, 0:3].view(np.int32),
                                              lo[a].view(np.int32))
                np.testing.assert_array_equal(tree[k, 3:6].view(np.int32),
                                              hi[a].view(np.int32))
                continue
            m_lo = np.minimum(lo[a:b], hi[a:b])
            m_hi = np.maximum(lo[a:b], hi[a:b])
            assert (tree[k, 0:3] <= m_lo).all() and (tree[k, 3:6] >= m_hi).all()
            np.testing.assert_array_equal(tree[k, 0:3], m_lo.min(axis=0))
            np.testing.assert_array_equal(tree[k, 3:6], m_hi.max(axis=0))
        assert depth <= PICK_STACK
        need = int(np.ceil(np.log2(S)))
        assert subtree_tree(lo, hi, max_depth=need)[1] == need
        with pytest.raises(ValueError, match="search stack"):
            subtree_tree(lo, hi, max_depth=need - 1)


def _rays(R, box_lo, box_hi, seed):
    r = np.random.RandomState(seed)
    span = box_hi - box_lo
    ro = (box_lo - 0.3 * span + r.rand(R, 3) * 1.6 * span).astype(np.float32)
    rd = r.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::10, 0] = 0.0
    rd[3::10, 2] = 0.0
    rd[5::40, 1] = np.nan
    ro[7::40, 0] = np.nan
    t_min = np.where(r.rand(R) < 0.3, r.rand(R) * 4.0, 0.0).astype(np.float32)
    t_max = np.where(r.rand(R) < 0.5, 1e30, r.rand(R) * 20.0).astype(
        np.float32)
    return [torch.from_numpy(a) for a in (ro, rd, t_min, t_max)]


def _slab(box, ray, key):
    """(hit, tn, tf) of every ray (rows) against every box (columns): the
    trace's ``_aabb_c`` (tf the exit it compares with, before the slack),
    or the sort key's arithmetic (``binned_sort_key_plain``)."""
    ro, rd, t_min, t_max = ray
    lo, hi = (torch.from_numpy(np.ascontiguousarray(box[:, c]))
              for c in (slice(0, 3), slice(3, 6)))
    inv = tt._safe_inv(rd)
    c = lambda a: a[:, None]  # noqa: E731
    if not key:
        hit, tn = tt._aabb_c(c(ro[:, 0]), c(ro[:, 1]), c(ro[:, 2]),
                             c(inv[:, 0]), c(inv[:, 1]), c(inv[:, 2]),
                             lo[:, 0], lo[:, 1], lo[:, 2], hi[:, 0],
                             hi[:, 1], hi[:, 2], c(t_min), c(t_max))
        t = [((b[:, a] - c(ro[:, a])) * c(inv[:, a]))
             for b in (lo, hi) for a in range(3)]
        tf = torch.minimum(
            torch.minimum(torch.maximum(t[0], t[3]), torch.maximum(t[1], t[4])),
            torch.minimum(torch.maximum(t[2], t[5]), c(t_max)))
        return hit, tn, tf
    t0 = (lo[None] - ro[:, None]) * inv[:, None]
    t1 = (hi[None] - ro[:, None]) * inv[:, None]
    tn = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=-1), c(t_min))
    tf = torch.minimum(torch.amax(torch.maximum(t0, t1), dim=-1) * tt.SLAB_SLACK,
                       c(t_max))
    return tn <= tf, tn, tf


@pytest.mark.parametrize("key", [False, True], ids=["trace", "sort_key"])
def test_pruning_lemma(cloud, key):
    cases = [(cloud["sub_lo"], cloud["sub_hi"], 2_000),
             (*_odd_boxes(45, 2), 1_000)]
    for lo, hi, R in cases:
        tree, _ = subtree_tree(lo, hi)
        ray = _rays(R, np.minimum(lo, hi).min(0), np.maximum(lo, hi).max(0),
                    R)
        nh, ntn, ntf = _slab(tree, ray, key)
        mh, mtn, mtf = _slab(np.concatenate([lo, hi], 1), ray, key)
        n_hits = 0
        for k, a, b in _ranges(tree):
            if b - a == 1:
                continue
            h = mh[:, a:b]
            n_hits += int(h.sum())
            assert bool((nh[:, k:k + 1] | ~h).all())
            assert bool(((ntn[:, k:k + 1] <= mtn[:, a:b]) | ~h).all())
            assert bool(((ntf[:, k:k + 1] >= mtf[:, a:b]) | ~h).all())
        assert n_hits > 500
        # a NaN origin misses every box (a NaN direction component is
        # safe_inv's -1e7, a finite slab; its triangle tests are NaN)
        nan_ray = torch.isnan(ray[0]).any(1)
        assert bool(nan_ray.any())
        assert not bool(nh[nan_ray].any()) and not bool(mh[nan_ray].any())


def test_binned_rows_hold_the_slab_bits(cloud):
    slab_f = torch.from_numpy(cloud["slab_f"])
    slab_i = torch.from_numpy(cloud["slab_i"])
    S = slab_i.shape[0] // CI
    node, tri = tt.binned_rows(slab_f, slab_i)
    assert node.shape == (S * SUB_ROWS, 16) and tri.shape == (S * SUB_ROWS, 12)
    fb = cloud["slab_f"].view(np.int32)
    ib = cloud["slab_i"]
    nb, tb = node.numpy().view(np.int32), tri.numpy().view(np.int32)
    for s in (0, 1, S // 2, S - 1):
        col = lambda t, stride, c: t[(s * stride + c * SUB_SEGS):  # noqa: E731
                                     (s * stride + (c + 1) * SUB_SEGS)].reshape(-1)
        rows = slice(s * SUB_ROWS, (s + 1) * SUB_ROWS)
        for c in range(12):
            np.testing.assert_array_equal(nb[rows, c], col(fb, CF, c))
        for c in range(2):
            np.testing.assert_array_equal(nb[rows, 12 + c], col(ib, CI, c))
        for c in range(9):
            np.testing.assert_array_equal(tb[rows, c], col(fb, CF, 12 + c))
        np.testing.assert_array_equal(tb[rows, 9], col(ib, CI, 2))
    assert not nb[:, 14:].any() and not tb[:, 10:].any()


def test_kernel_tables_are_built_once_per_scene(cloud):
    binned = {k: torch.from_numpy(a) for k, a in cloud.items()}
    first = tt._binned_kernel_tables(binned)
    assert tt._binned_kernel_tables(dict(binned)) is first
    tree, _ = subtree_tree(cloud["sub_lo"], cloud["sub_hi"])
    np.testing.assert_array_equal(first[2].numpy(), tree)
    other = dict(binned, slab_f=binned["slab_f"].clone())
    assert tt._binned_kernel_tables(other) is not first


def test_check_tlas_rows_wants_float4_rows():
    for max_leaf in range(1, 16):
        rows = torch.rand((16, tt.tlas_width(max_leaf)))
        table = tt.check_tlas_rows(rows)
        W = rows.shape[1]
        assert table.shape[1] % 4 == 0 and table.data_ptr() % 16 == 0
        assert table.shape[1] - W < 4
        assert (table is rows) == (W % 4 == 0)
        assert torch.equal(table[:, :W], rows) and not table[:, W:].any()
    shifted = torch.rand(16 * 56 + 1)[1:].view(16, 56)
    table = tt.check_tlas_rows(shifted)
    assert table.data_ptr() % 16 == 0 and torch.equal(table, shifted)
    with pytest.raises(ValueError, match="rows"):
        tt.check_tlas_rows(torch.zeros((16, 40)))


def test_source_hash_covers_headers(tmp_path):
    """A kernel's library name changes with its source, with any header in
    ``csrc`` (the brute and BVH kernels share ``tri_test.cuh``) and with
    nothing else there."""
    from ray_tpu_torch.ops import cuda_build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    (tmp_path / "notes.txt").write_text("a")
    first = cuda_build.source_hash(tmp_path, "k")
    (tmp_path / "notes.txt").write_text("b")
    assert cuda_build.source_hash(tmp_path, "k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = cuda_build.source_hash(tmp_path, "k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert cuda_build.source_hash(tmp_path, "k") not in (first, second)
