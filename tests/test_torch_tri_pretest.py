"""The divide-free pre-test of the brute and BVH kernels, and the cached
row tables they read, on the CPU.

The kernels (``ray_tpu_torch/csrc/tri_test.cuh``) reject a ray-triangle
pair without the IEEE divide where the signs and sizes of U, V, T and det
prove that the full Möller–Trumbore test fails; only the pairs left run the
full test.  That keeps them bit-equal to ``trace_brute_plain`` /
``trace_bvh_plain`` exactly when the pre-test never rejects a pair that the
full test takes.  ``ops/traverse.py``'s ``tri_pretest_plain`` is the same
predicate in PyTorch; here it is held against ``trace_brute_plain``'s full
test (one triangle, closest hit, so the bound is ``t_max``) on float32
inputs:

* ``chip_smoke.py``'s edge cases (``edge_tris`` / ``edge_rays``, the card's
  stress inputs): det exactly 0, subnormal det (1 / det = +-inf), U and V
  whose products with 1 / det round to -0 (a pass with u = -0), rays
  through vertices and along edges (u + v = 1), t exactly at t_min and at
  t_max, t_max one step above a t below 0, t_min < 0, zero, inf and NaN
  direction components, NaN origins;
* hypothesis: random triangles (seeded, or hypothesis's own floats)
  scaled by 2^-80 .. 2^60 (subnormal and zero coordinates included), rays
  aimed at barycentric edge values or anywhere, from in front of the
  triangle or past it, with zero, inf and NaN components, bounds at the
  pair's own t, one step above it, or anywhere, t_min below 0.

Each rule is also held at its own boundary (a divisor over the whole
float32 range, the bound's value 1-3 float steps away): the margin of the
rule is what keeps the full test's rounding from passing such a pair.

The row tables: ``tri_rows`` holds p0 and the plain versions' own float32
edges ``p1 - p0``, ``p2 - p0`` bit for bit, ``node_rows`` the packed node
bits, and the wrappers build each once per table.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from ray_tpu_torch.ops import traverse as tt

# one intra-op thread, as in tests/test_torch_scene.py
torch.set_num_threads(1)


def _full_and_pre(tris, ro, rd, t_min, t_max):
    """(full, pre), each (T, R) bool: trace_brute_plain's verdict on each
    triangle alone and the pre-test's, for every lane."""
    R = ro.shape[0]
    rows = tt.tri_rows(tris)
    on = torch.ones(R, dtype=torch.bool)
    full, pre = [], []
    for k in range(tris.shape[0]):
        full.append(tt.trace_brute_plain(tris[k:k + 1], ro, rd, t_min, t_max,
                                         on).prim >= 0)
        pre.append(tt.tri_pretest_plain(rows[k].expand(R, 12), ro, rd, t_min,
                                        t_max))
    return torch.stack(full), torch.stack(pre)


def test_pretest_never_rejects_a_hit_on_the_edge_cases():
    tris, n_special = chip_smoke.edge_tris(26, 3)
    rays = chip_smoke.edge_rays(tris, np.arange(n_special), 6000, 4,
                                torch.device("cpu"))
    ro, rd, t_min, t_max, _ = rays
    t9 = torch.from_numpy(tris)
    full, pre = _full_and_pre(t9, ro, rd, t_min, t_max)
    assert not bool((full & ~pre).any())
    # the pre-test does its job: most pairs stop without a divide
    assert float((~pre).float().mean()) > 0.8
    # the edge cases are met: hits with u = -0 from a non-zero U (the
    # underflow edge), hits at t_min < 0, det exactly 0 and subnormal
    R = ro.shape[0]
    u_neg0 = t_neg = det0 = det_sub = 0
    for k in range(t9.shape[0]):
        hit, t, u, v, _ = tt._tri_c(*ro.unbind(1), *rd.unbind(1),
                                    t9[k].expand(R, 9), t_min, t_max)
        rows = tt.tri_rows(t9[k:k + 1]).expand(R, 12)
        e1, e2 = rows[:, 3:6], rows[:, 6:9]
        det = (e1 * torch.linalg.cross(rd, e2)).sum(1)
        u_neg0 += int((hit & (u == 0) & torch.signbit(u)).sum())
        t_neg += int((hit & (t_min < 0)).sum())
        det0 += int((det == 0).sum())
        det_sub += int(((det != 0) & (det.abs() < 2.0 ** -126)).sum())
    assert u_neg0 > 0 and t_neg > 0 and det0 > 0 and det_sub > 0


_EDGE_B = (0.0, 1.0, 0.5, 1.0 / 3.0, -1e-7, 1.0 + 1e-7, 2.0 ** -149, -1.0)
_SPECIAL = (0.0, -0.0, float("inf"), float("-inf"), float("nan"), 2.0 ** -140)
_LANE = st.tuples(
    st.one_of(st.sampled_from(_EDGE_B), st.floats(-0.5, 1.5, width=32)),
    st.one_of(st.sampled_from(_EDGE_B), st.floats(-0.5, 1.5, width=32)),
    st.booleans(),                                   # v = 1 - u
    # direction: a seed for a random one, or three floats
    st.one_of(st.integers(0, 2 ** 31 - 1),
              st.tuples(*[st.floats(-1.0, 1.0, width=32)] * 3)),
    # one direction component replaced by a special value, or none
    st.one_of(st.none(), st.none(), st.none(), st.tuples(
        st.integers(0, 2), st.sampled_from(_SPECIAL))),
    st.sampled_from([1.0, 3.0, 0.0, -1.0, 2.0 ** -40, 2.0 ** 40]),
    st.sampled_from(["zero", "zero", "neg", "-inf", "at_t", "any"]),  # t_min
    st.sampled_from(["big", "big", "inf", "at_t", "above", "any"]),  # t_max
    st.floats(-10.0, 10.0, width=32),
)


@settings(max_examples=300, deadline=None, database=None)
@given(tri=st.one_of(st.integers(0, 2 ** 31 - 1), st.lists(
           st.floats(-4.0, 4.0, width=32), min_size=9, max_size=9)),
       scale=st.one_of(st.integers(-8, 8), st.integers(-80, 60)),
       lanes=st.lists(_LANE, min_size=8, max_size=48))
def test_pretest_never_rejects_a_hit(tri, scale, lanes):
    if isinstance(tri, int):
        tri = np.random.RandomState(tri).uniform(-4.0, 4.0, 9)
    p = np.ldexp(np.array(tri, np.float32), scale).reshape(3, 3)
    tris = torch.from_numpy(p.reshape(1, 9).astype(np.float32))
    p = p.astype(np.float64)
    ro, rd, tmin_kind, tmax_kind, free = [], [], [], [], []
    with np.errstate(invalid="ignore", over="ignore"):
        for bu, bv, on_edge, d, special, dist, kmin, kmax, x in lanes:
            if on_edge:
                bv = 1.0 - bu
            target = p[0] + bu * (p[1] - p[0]) + bv * (p[2] - p[0])
            d = (np.random.RandomState(d).normal(size=3) if isinstance(d, int)
                 else np.array(d, np.float64))
            if special is not None:
                d[special[0]] = special[1]
            ro.append(target - dist * d)
            rd.append(d)
            tmin_kind.append(kmin)
            tmax_kind.append(kmax)
            free.append(x)
    ro = torch.from_numpy(np.array(ro, np.float32))
    rd = torch.from_numpy(np.array(rd, np.float32))
    R = ro.shape[0]
    _, t, _, _, _ = tt._tri_c(*ro.unbind(1), *rd.unbind(1),
                              tris.expand(R, 9), torch.zeros(R),
                              torch.full((R,), float("inf")))
    free = torch.tensor(free, dtype=torch.float32)
    def pick(kinds, name):
        return torch.tensor([k == name for k in kinds])

    t_min = torch.zeros(R)
    t_min = torch.where(pick(tmin_kind, "neg"), -free.abs() - 1.0, t_min)
    t_min = torch.where(pick(tmin_kind, "-inf"), float("-inf"), t_min)
    t_min = torch.where(pick(tmin_kind, "at_t"), t, t_min)
    t_min = torch.where(pick(tmin_kind, "any"), free, t_min)
    t_max = torch.full((R,), 1e30)
    t_max = torch.where(pick(tmax_kind, "inf"), float("inf"), t_max)
    t_max = torch.where(pick(tmax_kind, "at_t"), t, t_max)
    t_max = torch.where(pick(tmax_kind, "above"),
                        torch.nextafter(t, torch.tensor(float("inf"))), t_max)
    t_max = torch.where(pick(tmax_kind, "any"), free, t_max)
    full, pre = _full_and_pre(tris, ro, rd, t_min, t_max)
    assert not bool((full & ~pre).any())


def _positive_floats(g, n):
    """n positive float32 over the whole exponent range, subnormals
    included."""
    e = g.randint(-149, 128, n)
    return torch.from_numpy(np.ldexp(g.uniform(1.0, 2.0, n), e).astype(
        np.float32))


def _steps_up(x, k):
    for _ in range(k):
        x = torch.nextafter(x, torch.tensor(float("inf")))
    return x


def _boundary_violations(rule, margin, a, inv, g):
    """Pairs past ``rule``'s bound by 1-3 float steps whose divided result
    (RN(x RN(1 / a)), as the full test forms it; det = a > 0, which the
    sign flip reduces every case to) does not fail as the rule claims, with
    the rule's margin set to ``margin``."""
    n = a.shape[0]
    bad = 0
    if rule == "R1":        # Us < -(a tiny)  =>  u < 0 (R2, R4 alike)
        for k in (1, 2, 3):
            u = -_steps_up(a * margin, k) * inv
            bad += int((u >= 0).sum())
    elif rule == "R3":      # RN(Us + Vs) > RN(a c), u, v >= 0  =>  u + v > 1
        bound = a * margin
        us = bound * torch.from_numpy(g.rand(n).astype(np.float32))
        for k in (0, 1, 2, 3):
            vs = _steps_up(bound - us, k)
            past = (us + vs > bound) & torch.isfinite(vs)
            u, v = us * inv, vs * inv
            bad += int((past & (u >= 0) & (v >= 0) & (u + v <= 1)).sum())
    else:                   # Ts > max(RN(RN(upper a) c), 0)  =>  t >= upper
        upper = torch.where(torch.from_numpy(g.rand(n) < 0.8),
                            _positive_floats(g, n), -_positive_floats(g, n))
        upper = torch.where(torch.from_numpy(g.rand(n) < 0.1), 0.0, upper)
        bound = torch.fmax(upper * a * margin, torch.zeros_like(a))
        for k in (1, 2, 3):
            ts = _steps_up(bound, k)
            bad += int((torch.isfinite(ts) & (ts * inv < upper)).sum())
    return bad


@pytest.mark.parametrize("rule,margin", [
    ("R1", tt.PRETEST_TINY), ("R3", tt.PRETEST_SLACK),
    ("R5", tt.PRETEST_SLACK)])
def test_rule_holds_at_its_boundary(rule, margin):
    """Each rule's step of the argument, on 400,000 divisors a over the
    whole float32 range: just past the bound the full test's own rounding
    cannot save the pair; and without the margin (2^-60 or 1 + 2^-10) it
    can, so the margin is needed."""
    g = np.random.RandomState(["R1", "R3", "R5"].index(rule))
    a = _positive_floats(g, 400_000)
    a = a[(a > 0) & torch.isfinite(a)]
    inv = torch.reciprocal(a)
    assert _boundary_violations(rule, margin, a, inv, g) == 0
    bare = 0.0 if rule == "R1" else 1.0
    assert _boundary_violations(rule, bare, a, inv, g) > 0


def test_tri_rows_hold_the_plain_edges():
    tris, _ = chip_smoke.edge_tris(26, 3)
    rows = tt.tri_rows(torch.from_numpy(tris)).numpy()
    assert rows.shape == (tris.shape[0], 12) and rows.dtype == np.float32
    p0, p1, p2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    for got, want in ((rows[:, 0:3], p0), (rows[:, 3:6], p1 - p0),
                      (rows[:, 6:9], p2 - p0)):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not rows[:, 9:].view(np.int32).any()


def test_node_rows_hold_the_packed_bits():
    from ray_tpu_torch.scene.bvh import build_bvh2, pack_bvh_soa, tri_bounds

    tris, _ = chip_smoke.edge_tris(196, 3)
    v = tris.reshape(-1, 3)
    idx = np.arange(v.shape[0], dtype=np.int32).reshape(-1, 3)
    packed = pack_bvh_soa(build_bvh2(*tri_bounds(v, idx), max_leaf=15))[
        "packed"]
    rows = tt.node_rows(torch.from_numpy(packed)).numpy()
    assert rows.shape == (packed.shape[0], 16)
    np.testing.assert_array_equal(rows[:, :14].view(np.int32),
                                  packed.view(np.int32))
    assert not rows[:, 14:].view(np.int32).any()


def test_kernel_tables_are_built_once_per_table():
    tris = torch.from_numpy(chip_smoke.edge_tris(26, 3)[0])
    first = tt._brute_kernel_tables(tris)
    assert tt._brute_kernel_tables(tris) is first
    assert tt._brute_kernel_tables(tris.clone()) is not first
    tris.mul_(2.0)  # modified in place: built again
    again = tt._brute_kernel_tables(tris)
    assert again is not first
    assert torch.equal(again[0], tt.tri_rows(tris))
    nodes = torch.zeros((8, 14))
    pair = tt._bvh_kernel_tables(nodes, tris)
    assert tt._bvh_kernel_tables(nodes, tris) is pair
    assert tt._bvh_kernel_tables(nodes, tris.clone()) is not pair
