"""SHARC-style spatial radiance cache.

The port of ``ray_tpu.render.radcache`` (reference internal/RadCacheRef.*,
constants internal/Constants.inl:112-146, query exit
ShadeRef.cpp:1370-1392, update/resolve RendererCPU.h:1010-1212).  The
cache is a :class:`CacheState` of dense tensors; every function returns a
new state and leaves its input unchanged, as ``ray_tpu``'s do.

* **Keys.**  The reference's 64-bit key (17+17+17 grid position, 10 level,
  3 normal-octant bits) is two 32-bit words, held here, as in
  ``ops/rng.py``, as ``int64`` tensors in [0, 2^32): PyTorch's ``uint32``
  has no shifts on the CPU.  (0, 0) is the empty slot.
* **Claims.**  ``claim_entries`` resolves a wavefront's insertions over
  ``CLAIM_ROUNDS`` scatter-then-regather rounds over ``PROBE_LEN`` probe
  slots.  Where several lanes write one slot in a round, ``ray_tpu``'s
  XLA scatter keeps the last lane's key; the port picks that lane by a
  ``scatter_reduce("amax")`` of lane indices, which is the same in any
  order, and writes only the winners' keys: the claims are ``ray_tpu``'s
  bit for bit, collisions included, on the CPU and on CUDA alike.
* **Accumulation.**  ``accumulate`` adds lanes' radiance into
  ``rad_curr`` at entries that repeat.  On the CPU that is
  :func:`accumulate_plain` (``index_add_``, which adds in lane order, as
  XLA's scatter-add does); on CUDA it is the hand-written
  ``csrc/radcache_accumulate.cu`` (:func:`accumulate_segments`), which
  adds each entry's lanes in lane order too, without atomics, so a card's
  cache is the same from run to run and equal to the plain version on the
  same inputs.
* **Back-propagation** is ``ray_tpu``'s suffix sum: the entry at path
  vertex j receives ``sum_{k >= j} delta_k / T_j``
  (:func:`propagate_and_accumulate`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ray_tpu_torch.ops import cuda_build
from ray_tpu_torch.utils.device import resolve_device

# Constants.inl:112-146 (same names and values)
HASH_GRID_POSITION_BIT_NUM = 17
HASH_GRID_POSITION_BIT_MASK = (1 << HASH_GRID_POSITION_BIT_NUM) - 1
HASH_GRID_LEVEL_BIT_NUM = 10
HASH_GRID_LEVEL_BIT_MASK = (1 << HASH_GRID_LEVEL_BIT_NUM) - 1
HASH_GRID_LEVEL_BIAS = 2
RAD_CACHE_SAMPLE_COUNT_MAX = 128
RAD_CACHE_SAMPLE_COUNT_MIN = 8
RAD_CACHE_STALE_FRAME_NUM_MAX = 128
RAD_CACHE_PROPAGATION_DEPTH = 4
RAD_CACHE_DOWNSAMPLING_FACTOR = 4
RAD_CACHE_GRID_SCALE = 50.0
RAD_CACHE_LOG_BASE = 2.0
RAD_CACHE_MIN_ROUGHNESS = 0.4

PROBE_LEN = 16     # reference bucket size is 32 (HASH_GRID_HASH_MAP_BUCKET_SIZE)
CLAIM_ROUNDS = 3

DEFAULT_ENTRIES = 1 << 20  # reference: 1<<22; configurable

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CacheState:
    """The whole spatial cache as dense tensors on one device, each table
    with one dump row at the end where inactive lanes point."""

    key_lo: torch.Tensor    # (N+1,) int64 in [0, 2^32): low key word
    key_hi: torch.Tensor    # (N+1,) int64: high key word ((0, 0) = empty)
    rad_curr: torch.Tensor  # (N+1, 3) f32 radiance accumulating this frame
    cnt_curr: torch.Tensor  # (N+1,) i32 sample count accumulating
    rad_prev: torch.Tensor  # (N+1, 3) f32 resolved radiance sum
    cnt_prev: torch.Tensor  # (N+1,) i32 resolved sample count
    frames: torch.Tensor    # (N+1,) i32 frames since the last touch
    cam_pos: torch.Tensor   # (3,) f32 grid origin anchor

    def replace(self, **kw) -> "CacheState":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> dict:
        """The fields as ``ray_tpu``'s arrays (keys as uint32)."""
        out = {}
        for f in dataclasses.fields(self):
            a = getattr(self, f.name).cpu().numpy()
            out[f.name] = a.astype(np.uint32) if f.name.startswith("key") else a
        return out


def cache_from_numpy(fields, device=None) -> CacheState:
    """A :class:`CacheState` from ``ray_tpu``'s fields as numpy arrays (a
    mapping or a sequence in ``CacheState`` order), on ``device`` (CUDA by
    default, ``resolve_device``)."""
    device = resolve_device(device)
    names = [f.name for f in dataclasses.fields(CacheState)]
    if not isinstance(fields, dict):
        fields = dict(zip(names, fields))
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"cache fields missing: {sorted(missing)}")
    dtypes = {"key_lo": torch.int64, "key_hi": torch.int64,
              "cnt_curr": torch.int32, "cnt_prev": torch.int32,
              "frames": torch.int32}
    out = {}
    for n in names:
        a = np.array(fields[n])   # a copy: the caller's may be read-only
        if n.startswith("key"):
            a = a.astype(np.uint32).astype(np.int64)
        out[n] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtypes.get(n, torch.float32))
    return CacheState(**out)


def make_cache(entries: int = DEFAULT_ENTRIES, cam_pos=(0.0, 0.0, 0.0), *,
               device=None) -> CacheState:
    """An empty cache of ``entries`` slots (+1 dump row) on ``device``
    (CUDA by default, ``resolve_device``)."""
    device = resolve_device(device)
    n = entries + 1

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return CacheState(
        key_lo=zeros(n, dtype=torch.int64), key_hi=zeros(n, dtype=torch.int64),
        rad_curr=zeros(n, 3), cnt_curr=zeros(n, dtype=torch.int32),
        rad_prev=zeros(n, 3), cnt_prev=zeros(n, dtype=torch.int32),
        frames=zeros(n, dtype=torch.int32),
        cam_pos=torch.as_tensor(np.asarray(cam_pos, np.float32)).to(device),
    )


def _jenkins32(a):
    """Bob Jenkins' 32-bit integer hash (RadCacheRef.h:11-19) on int64
    words in [0, 2^32)."""
    a = a & _M32
    a = ((a + 0x7ED55D16) + (a << 12)) & _M32
    a = (a ^ 0xC761C23C) ^ (a >> 19)
    a = ((a + 0x165667B1) + (a << 5)) & _M32
    a = ((a + 0xD3A2646C) ^ (a << 9)) & _M32
    a = ((a + 0xFD7046C5) + (a << 3)) & _M32
    a = (a ^ 0xB55A4F09) ^ (a >> 16)
    return a


def grid_level(p, cam_pos):
    """Logarithmic grid level by camera distance (RadCacheRef.cpp:156-161)."""
    d = p - cam_pos[None, :]
    # the three-term sum in ray_tpu's reduction order
    dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    dist = torch.sqrt(torch.clamp_min(dd, 1e-12))
    lvl = torch.floor(
        torch.log2(dist) / math.log2(RAD_CACHE_LOG_BASE)
        + HASH_GRID_LEVEL_BIAS)
    return torch.clamp(lvl, 1.0, HASH_GRID_LEVEL_BIT_MASK).to(torch.int32)


def voxel_size(level):
    """Core.h:564-566."""
    return torch.pow(RAD_CACHE_LOG_BASE, level.to(torch.float32)) / (
        RAD_CACHE_GRID_SCALE * RAD_CACHE_LOG_BASE ** HASH_GRID_LEVEL_BIAS)


def compute_hash(p, n, cam_pos):
    """The 64-bit key (bit layout of RadCacheRef.cpp:22-37) as two 32-bit
    words, and the folded 32-bit slot hash (hash64, RadCacheRef.h:21-24),
    each an int64 tensor in [0, 2^32)."""
    lvl = grid_level(p, cam_pos)
    vs = voxel_size(lvl)
    gp = torch.floor(p / vs[:, None]).to(torch.int32).to(torch.int64) & _M32
    x = gp[:, 0] & HASH_GRID_POSITION_BIT_MASK
    y = gp[:, 1] & HASH_GRID_POSITION_BIT_MASK
    z = gp[:, 2] & HASH_GRID_POSITION_BIT_MASK
    lv = lvl.to(torch.int64) & HASH_GRID_LEVEL_BIT_MASK
    nb = ((n[:, 0] >= 0).to(torch.int64) + 2 * (n[:, 1] >= 0).to(torch.int64)
          + 4 * (n[:, 2] >= 0).to(torch.int64))
    # bits 0..16 = x, 17..33 = y, 34..50 = z, 51..60 = level, 61..63 = octant
    lo = x | ((y & 0x7FFF) << 17)
    hi = ((y >> 15) | (z << 2) | (lv << 19) | (nb << 29)) & _M32
    slot_hash = _jenkins32(lo) ^ _jenkins32(hi)
    return lo, hi, slot_hash


def _probe_candidates(slot_hash, n_entries: int):
    base = slot_hash % n_entries
    offs = torch.arange(PROBE_LEN, dtype=torch.int64, device=base.device)
    return (base[:, None] + offs[None, :]) % n_entries  # (R, PROBE_LEN)


def _first_true(mask):
    """Index of the first True along axis -1 (0 where there is none), and
    whether there is one."""
    return torch.argmax(mask.to(torch.int8), dim=-1), mask.any(dim=-1)


def _pick(cand, idx):
    return torch.gather(cand, 1, idx[:, None])[:, 0]


def find_entries(state: CacheState, p, n):
    """Vectorized hash_map_find (RadCacheRef.cpp:108-123): returns
    (entry (R,) int64 slot or the dump row, found (R,) bool)."""
    n_entries = state.key_lo.shape[0] - 1
    lo, hi, h = compute_hash(p, n, state.cam_pos)
    cand = _probe_candidates(h, n_entries)
    match = (state.key_lo[cand] == lo[:, None]) & (
        state.key_hi[cand] == hi[:, None])
    idx, found = _first_true(match)
    return torch.where(found, _pick(cand, idx), n_entries), found


def claim_entries(state: CacheState, p, n, active):
    """Vectorized hash_map_insert (RadCacheRef.cpp:92-106).

    Returns (new_state, entry (R,), ok (R,)).  Claims resolve over
    ``CLAIM_ROUNDS`` scatter / regather rounds; a slot that several lanes
    want in one round takes the key of the highest lane (``ray_tpu``'s
    last writer).  Lanes that cannot claim a slot get the dump row and
    ok=False."""
    n_entries = state.key_lo.shape[0] - 1
    lo, hi, h = compute_hash(p, n, state.cam_pos)
    cand = _probe_candidates(h, n_entries)
    key_lo, key_hi = state.key_lo, state.key_hi
    R = lo.shape[0]
    lane = torch.arange(R, dtype=torch.int64, device=lo.device)

    entry = torch.full((R,), n_entries, dtype=torch.int64, device=lo.device)
    ok = torch.zeros((R,), dtype=torch.bool, device=lo.device)

    def regather(entry, ok):
        s_lo, s_hi = key_lo[cand], key_hi[cand]
        m_idx, m_found = _first_true((s_lo == lo[:, None])
                                     & (s_hi == hi[:, None]))
        got = active & (~ok) & m_found
        return torch.where(got, _pick(cand, m_idx), entry), ok | got, s_lo, s_hi

    for _ in range(CLAIM_ROUNDS):
        entry, ok, s_lo, s_hi = regather(entry, ok)
        # unclaimed lanes write their key to their first empty candidate;
        # of several writers of one slot the highest lane wins
        e_idx, e_found = _first_true((s_lo == 0) & (s_hi == 0))
        want = active & (~ok) & e_found
        tgt = torch.where(want, _pick(cand, e_idx), n_entries)
        win = torch.full((n_entries + 1,), -1, dtype=torch.int64,
                         device=lo.device).scatter_reduce(
            0, tgt, torch.where(want, lane, -1), "amax")
        writer = want & (win[tgt] == lane)
        key_lo = key_lo.index_put((tgt[writer],), lo[writer])
        key_hi = key_hi.index_put((tgt[writer],), hi[writer])

    # the final regather for the last round's writers
    entry, ok, _, _ = regather(entry, ok)
    return state.replace(key_lo=key_lo, key_hi=key_hi), entry, ok


# ---------------------------------------------------------------------------
# accumulate: the plain version and the CUDA kernel
# ---------------------------------------------------------------------------

def accumulate_plain(rad_curr, cnt_curr, entry, rad, cnt, valid):
    """``rad_curr[entry[i]] += rad[i]``, ``cnt_curr[entry[i]] += cnt[i]``
    for each valid lane i, in lane order (``index_add_`` on the CPU adds
    sequentially, as XLA's scatter-add does).  Returns new tables."""
    idx = entry[valid]
    return (rad_curr.index_add(0, idx, rad[valid]),
            cnt_curr.index_add(0, idx, cnt[valid]))


def accumulate_segments(rad_curr, cnt_curr, entry, rad, cnt, valid):
    """:func:`accumulate_plain`'s function: on a CPU tensor that version, on
    a CUDA tensor ``csrc/radcache_accumulate.cu`` (or it raises).

    ``rad_curr`` (N+1, 3) f32 and ``cnt_curr`` (N+1,) i32 are the tables,
    ``entry`` (R,) int64 in [0, N+1), ``rad`` (R, 3) f32, ``cnt`` (R,)
    i32, ``valid`` (R,) bool.  The lanes are sorted by entry with a stable
    sort (invalid lanes keyed past the end), then each entry's segment adds
    its lanes in lane order, starting from the table's value (one thread a
    segment inside the kernel's tile, one warp one that runs past it): the
    plain version's sums, bit for bit, NaN bits included.  A valid lane whose entry lies
    outside the table raises ``IndexError`` on either device (one host
    sync); an invalid lane's entry is never read."""
    n_rows = rad_curr.shape[0]
    R = entry.shape[0]
    if rad_curr.device.type == "cpu":
        _check_entries(entry, valid, n_rows)
        return accumulate_plain(rad_curr, cnt_curr, entry, rad, cnt, valid)
    if rad_curr.device.type != "cuda":
        raise ValueError(f"accumulate runs on CPU or CUDA, not "
                         f"{rad_curr.device}")
    if n_rows >= 2**31 - 1 or R >= 2**31:
        raise ValueError("accumulate takes fewer than 2^31 rows and lanes")
    for name, x, dt, shape in (
            ("rad_curr", rad_curr, torch.float32, (n_rows, 3)),
            ("cnt_curr", cnt_curr, torch.int32, (n_rows,)),
            ("entry", entry, torch.int64, (R,)),
            ("rad", rad, torch.float32, (R, 3)),
            ("cnt", cnt, torch.int32, (R,)),
            ("valid", valid, torch.bool, (R,))):
        if x.device != rad_curr.device or x.dtype != dt:
            raise TypeError(f"{name} must be {dt} on {rad_curr.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")
    _check_entries(entry, valid, n_rows)
    rad_out = rad_curr.contiguous().clone()
    cnt_out = cnt_curr.contiguous().clone()
    if R == 0:
        return rad_out, cnt_out
    keys, order = sort_lanes(entry, valid, n_rows)
    launch_sorted(keys, order, rad.contiguous(), cnt.contiguous(), rad_out,
                  cnt_out)
    cuda_build.launch_counts["radcache_accumulate"] += 1
    return rad_out, cnt_out


def _check_entries(entry, valid, n_rows):
    if bool((valid & ((entry < 0) | (entry >= n_rows))).any()):
        raise IndexError(f"a valid lane's entry lies outside the table's "
                         f"{n_rows} rows")


def sort_lanes(entry, valid, n_rows):
    """The kernel's lane order: int32 keys (an invalid lane keyed
    ``n_rows``, past every entry) sorted stably, and the int64 lane index
    of each sorted key, as ``torch.sort`` gives them."""
    key = torch.where(valid, entry, n_rows).to(torch.int32)
    return torch.sort(key, stable=True)


def launch_sorted(keys, order, rad, cnt, rad_out, cnt_out):
    """One launch of ``csrc/radcache_accumulate.cu`` on lanes sorted by
    :func:`sort_lanes`, adding into ``rad_out`` / ``cnt_out`` in place
    (contiguous CUDA tensors, checked by :func:`accumulate_segments`)."""
    dev = rad_out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _accumulate_fn()(
            keys.data_ptr(), order.data_ptr(), keys.shape[0],
            rad_out.shape[0], rad.data_ptr(), cnt.data_ptr(),
            rad_out.data_ptr(), cnt_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radcache_accumulate kernel launch failed: CUDA "
                           f"error {err}")


def _accumulate_fn():
    fn = cuda_build.load("radcache_accumulate").radcache_accumulate_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int64, ctypes.c_int64, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def accumulate(state: CacheState, entry, rad, count_inc, valid):
    """accumulate_cache_voxel (RadCacheRef.cpp:138-152) over a wavefront:
    radiance and sample counts added into the current frame's tables
    (invalid lanes add nothing; ``ray_tpu`` adds their zeros to the dump
    row)."""
    rad_curr, cnt_curr = accumulate_segments(
        state.rad_curr, state.cnt_curr, entry, rad.to(torch.float32),
        count_inc.to(torch.int32), valid)
    return state.replace(rad_curr=rad_curr, cnt_curr=cnt_curr)


def query(state: CacheState, p, n, active):
    """Cache lookup for the shade-stage early exit (ShadeRef.cpp:1378-1390).
    Returns (radiance (R,3) already divided by the sample count, hit (R,)
    bool)."""
    entry, found = find_entries(state, p, n)
    cnt = state.cnt_prev[entry]
    good = active & found & (cnt >= RAD_CACHE_SAMPLE_COUNT_MIN)
    rad = state.rad_prev[entry] / torch.clamp_min(cnt, 1)[:, None].to(
        torch.float32)
    return torch.where(good[:, None], rad, 0.0), good


def resolve(state: CacheState) -> CacheState:
    """SpatialCacheResolve (RadCacheRef.cpp:232-312) without compaction:
    merge curr into prev, cap the sample count with a proportional radiance
    rescale, age untouched entries, free stale ones (``ray_tpu``'s
    ``resolve``)."""
    occupied = (state.key_lo != 0) | (state.key_hi != 0)
    rad = state.rad_prev + state.rad_curr
    cnt = state.cnt_prev + state.cnt_curr
    over = cnt > RAD_CACHE_SAMPLE_COUNT_MAX
    k = torch.where(over, RAD_CACHE_SAMPLE_COUNT_MAX
                    / torch.clamp_min(cnt, 1).to(torch.float32), 1.0)
    rad = rad * k[:, None]
    cnt = torch.clamp_max(cnt, RAD_CACHE_SAMPLE_COUNT_MAX)
    touched = state.cnt_curr > 0
    frames = torch.where(touched, 0, state.frames + 1)
    stale = occupied & (frames > RAD_CACHE_STALE_FRAME_NUM_MAX)
    keep = occupied & (~stale)
    zero3 = torch.zeros_like(rad)
    return CacheState(
        key_lo=torch.where(keep, state.key_lo, 0),
        key_hi=torch.where(keep, state.key_hi, 0),
        rad_curr=zero3,
        cnt_curr=torch.zeros_like(cnt),
        rad_prev=torch.where(keep[:, None], rad, zero3),
        cnt_prev=torch.where(keep, cnt, 0),
        frames=torch.where(keep, frames, 0).to(torch.int32),
        cam_pos=state.cam_pos,
    )


def propagate_and_accumulate(state: CacheState, deltas, throughputs,
                             positions, normals, vertex_valid):
    """The suffix-sum form of SpatialCacheUpdate (RadCacheRef.cpp:179-230):
    the entry at vertex j receives ``sum_{k >= j} delta_k / T_j`` and one
    sample at its own vertex.

    deltas, throughputs, positions, normals: (B, R, 3); vertex_valid (B, R)
    bool: a cacheable vertex at bounce k (the first
    RAD_CACHE_PROPAGATION_DEPTH real hits only)."""
    l_from = torch.cumsum(deltas.flip(0), dim=0).flip(0)
    t = torch.clamp_min(throughputs, 1e-12)
    contrib = torch.where(vertex_valid[..., None], l_from / t, 0.0)
    B, R = vertex_valid.shape
    flat_v = vertex_valid.reshape(B * R)
    state, entry, ok = claim_entries(state, positions.reshape(B * R, 3),
                                     normals.reshape(B * R, 3), flat_v)
    return accumulate(state, entry, contrib.reshape(B * R, 3),
                      torch.ones_like(entry), flat_v & ok)
