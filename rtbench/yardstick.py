"""The benchmark's fixed arithmetic: peaks, the traversal's byte bound,
the loss, the ray rates and the statistics of a window.

Frozen here so that a change to the program cannot move the yardstick:

* the byte terms of a trace launch and the H100's HBM rate are
  ``chip_smoke.py``'s (lines 295-315, ``PEAK_BYTES_PER_S``,
  ``BYTES_PER_LANE``, ``BYTES_PER_ACTIVE_LANE``,
  ``TLAS_EXTRA_BYTES_PER_LANE``) and ``launch_bound``'s sum (lines
  935-992): each input byte read once, each output byte written once;
* the loss and the Mray/s arithmetic are ``bench.py``'s (lines 68 and
  103), rewritten in PyTorch.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s at the 700 W limit
PEAK_HBM_BYTES_PER_S = 3.35e12

# every lane reads t_max, active (5 B) and writes t, u, v, prim, backface
# (17 B); an active lane also reads ro, rd, t_min (28 B).  trace_tlas also
# writes the instance row (4 B) and reads a ray mask when given (4 B)
BYTES_PER_LANE = 22
BYTES_PER_ACTIVE_LANE = 28
TLAS_EXTRA_BYTES_PER_LANE = 4

# the two-level kernels, which write the instance row
TLAS_KERNELS = ("trace_tlas", "trace_tlas_bin")


def launch_bytes(kernel: str, lanes: int, active: int, table_bytes: int,
                 has_ray_mask: bool) -> int:
    """Bytes one trace launch needs (``launch_bound``): every lane's
    flags and hit, every active lane's ray, the tables once.  ``kernel`` is
    the wrapper's name; a two-level walk writes one word a lane more, and
    reads one more with the rays' mask, as the masked BVH2 walk does."""
    lane_bytes = BYTES_PER_LANE
    if kernel in TLAS_KERNELS:
        lane_bytes += TLAS_EXTRA_BYTES_PER_LANE * (2 if has_ray_mask else 1)
    elif kernel == "trace_bvh" and has_ray_mask:
        lane_bytes += TLAS_EXTRA_BYTES_PER_LANE
    return lane_bytes * lanes + BYTES_PER_ACTIVE_LANE * active + table_bytes


def bound_seconds(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes``."""
    return nbytes / PEAK_HBM_BYTES_PER_S


def bench_loss(color, target, height: int, width: int):
    """``bench.py``'s image loss: sum((color - target)^2) / (H * W * 3)."""
    return ((color - target) ** 2).sum() / (height * width * 3)


def mrays_per_s(rays: int, seconds: float) -> float:
    """Millions of traced rays a second over a window."""
    return rays / seconds / 1e6


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_share(busy_s: float, traced_units: int, untraced_s) -> float:
    """1 - (device busy seconds a unit, over ``traced_units`` traced units)
    / (the mean of the untraced units' wall seconds)."""
    return 1.0 - (busy_s / traced_units) / (sum(untraced_s) / len(untraced_s))


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps in [lo, hi] that no interval covers, as (start, end)."""
    gaps = []
    t = lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]

