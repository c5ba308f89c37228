#!/usr/bin/env python3
"""Time the design steps of the trace kernels against the shipped ones, on
one CUDA card.

    python3 tools/kernel_variants.py [--kernels NAME,...]

Each variant is the shipped ``ray_tpu_torch/csrc/<kernel>.cu`` (with the
headers it includes written in) with one design step undone or changed by
a text edit, written to ``build/kernel_variants/`` and built with the
port's nvcc flags:

* ``trace_brute``: no lane packing (each thread runs its own lane, active
  or not) instead of a block's active lanes packed onto its first
  threads; the raw (T, 9) rows with the edges recomputed a test (instead
  of the cached p0 e1 e2 rows); no pre-test (every pair takes the IEEE
  divide); 128 threads a block instead of 256;
* ``trace_bvh``: no lane packing; the rows staged in shared memory once a
  block (the earlier design), or once a block of a grid of a few blocks an
  SM walking the rays grid-stride, instead of read through L1
  (``__ldg``); the raw (N, 14) / (T, 9) rows; compare-and-select min /
  max instead of ``max.NaN`` / ``min.NaN``; the if-if walk (a step a node
  or a leaf) instead of the while-while one; no pre-test; 128 threads a
  block instead of 256;
* ``trace_tlas``: the stack in shared memory (32 KB a block) instead of
  local memory; persistent warps (a grid that fills the card once, each
  warp taking its next 32 rays from a zeroed global counter) instead of
  one thread a ray over all rays; the registers capped at 64
  (``__launch_bounds__(128, 8)``, 8 blocks an SM);
* ``trace_binned``: one thread a ray over all rays instead of persistent
  warps (the tree still staged once a block); 128 threads a block instead
  of 64; a candidate list of 16 instead of 8; subtree-tree splits at the
  middle of each sid range instead of by surface area (the tree rebuilt
  with midpoint splits).

On the captured launches of ``chip_smoke.py``'s frames (the flagship's
1920x1080 frame for ``trace_brute``, ``cornell_sphere``'s for
``trace_bvh``, the top-right 960x540 tile of the instanced and flattened
colonnade for ``trace_tlas``, of the binned one for ``trace_binned``)
every variant's outputs are held bit-equal to the shipped kernel's, and
each is timed (CUDA events, 30 launches) beside the shipped one; the mean
per mode is printed with the card's name and power limit, after each
build's registers.  ``--kernels`` picks the kernels (default: all four).
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "ray_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernel_variants"
REPS = 30
KERNELS = ("trace_brute", "trace_bvh", "trace_tlas", "trace_binned")
# the variants that read the raw (T, 9) / (N, 14) tables
RAW_ROWS = "raw rows"


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"variant anchor not found: {old[:60]!r}")
    return src.replace(old, new)


def _source(kernel: str) -> str:
    """The shipped source with each ``#include "x.cuh"`` written in."""
    src = (CSRC / f"{kernel}.cu").read_text()
    for name in re.findall(r'#include "(\w+\.cuh)"', src):
        header = (CSRC / name).read_text().replace("#pragma once\n", "")
        src = src.replace(f'#include "{name}"', header)
    return src


# tri_test.cuh's pre-test rules, each dropped by the "no pre-test" variants
PRETEST_RULES = (
    "  if (Us < -tiny) return false;                               // R1\n",
    "  if (Vs < -tiny || Us + Vs > a * kSlack) return false;       // R2, R3\n",
    """  if ((tmn_nonneg && Ts < -tiny) ||                           // R4
      Ts > fmaxf(upper * a * kSlack, 0.0f)) {                 // R5
    return false;
  }
""")


def raw_tri(indent: str, decl: str) -> str:
    """A raw (T, 9) row ``q`` = p0 p1 p2 as tri_test.cuh's three float4 p0
    e1 e2 (``decl``: "const float4 " to declare them)."""
    return "\n".join(indent + line for line in (
        f"{decl}r0 = make_float4(q[0], q[1], q[2], q[3] - q[0]);",
        f"{decl}r1 = make_float4(q[4] - q[1], q[5] - q[2], q[6] - q[0], "
        "q[7] - q[1]);",
        f"{decl}r2 = make_float4(q[8] - q[2], 0.0f, 0.0f, 0.0f);"))


# trace_bvh's walk before the while-while loop: one step a node or a leaf
IF_IF_WALK = """  while (cur != kEmpty) {
    int32_t next = kEmpty;
    if (cur >= 0) {
      float4 q0, q1, q2, q3;
      node_row(nodes, cur, q0, q1, q2, q3);
      float t0, t1;
      const bool h0 = slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ox, oy, oz,
                           ix, iy, iz, tmn, t_best, &t0);
      const bool h1 = slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ox, oy, oz,
                           ix, iy, iz, tmn, t_best, &t1);
      const int32_t c0 = __float_as_int(q3.x);
      const int32_t c1 = __float_as_int(q3.y);
      const bool near_is_0 = t0 <= t1;
      const int32_t near_code = near_is_0 ? c0 : c1;
      const int32_t far_code = near_is_0 ? c1 : c0;
      const bool near_hit = near_is_0 ? h0 : h1;
      const bool far_hit = near_is_0 ? h1 : h0;
      if (near_hit && far_hit) {
        if (sp < stack_size) stack[sp] = far_code;
        ++sp;
      }
      next = near_hit ? near_code : (far_hit ? far_code : kEmpty);
    } else {
      const int32_t leaf = -cur - 1;
      const int first = leaf >> 4;
      const int count = leaf & 15;
      for (int k = 0; k < max_leaf && k < count; ++k) {
        float4 r0, r1, r2;
        tri_row(tris, first + k, r0, r1, r2);
        const float upper = kAnyHit ? tmx : t_best;
        if (tri_test::hit(r0, r1, r2, ox, oy, oz, dx, dy, dz, tmn,
                          tmn_nonneg, upper, t_best, u_b, v_b, bf)) {
          prim = first + k;
        }
      }
    }
    if (kAnyHit && prim >= 0) {
      sp = 0;
      next = kEmpty;
    }
    while (next == kEmpty && sp > 0) {
      const int top = sp - 1;
      next = top < stack_size ? stack[top] : kEmpty;
      sp = top;
    }
    cur = next;
  }
  out_t[r] = t_best;"""


# the shipped kernels' lane packing (live_lanes.cuh), and what the "no lane
# packing" variants put in its place
BRUTE_PACK = """  // (its barriers also end the staging)
  const int n_live = live_lanes::pack_live<kThreads>(live, s_list, s_count);
  if (static_cast<int>(threadIdx.x) >= n_live) return;

  const int64_t r = base + s_list[threadIdx.x];"""
BRUTE_NO_PACK = """  __syncthreads();
  if (!live) return;
  const int64_t r = own;"""
BVH_PACK = """  const int n_live = live_lanes::pack_live<kThreads>(live, s_list, s_count);
  if (static_cast<int>(threadIdx.x) < n_live) {
    trace_ray<kAnyHit>(base + s_list[threadIdx.x], nodes, tris, ro, rd, t_min,
                       t_max, out_t, out_prim, out_u, out_v, out_bf, max_leaf,
                       stack_size);
  }"""
BVH_NO_PACK = """  if (live) {
    trace_ray<kAnyHit>(own, nodes, tris, ro, rd, t_min, t_max, out_t,
                       out_prim, out_u, out_v, out_bf, max_leaf, stack_size);
  }"""
# the staged variants of trace_bvh: the rows copied to shared memory once
# a block, before the lane packing (whose barriers end the copy)
STAGE = """  __shared__ int s_count[kThreads / 32];
  extern __shared__ float4 s_rows[];
  const int n_node4 = n_nodes * kNode4;
  const int n_row4 = n_node4 + n_tris * kTri4;
  for (int i = threadIdx.x; i < n_row4; i += blockDim.x) {
    s_rows[i] = i < n_node4 ? nodes[i] : tris[i - n_node4];
  }
"""


def brute_variants():
    src = _source("trace_brute")
    raw = _edit(src, """  __shared__ float4 s_tri[kMaxTris * kRow4];""",
                """  __shared__ float s_tri9[kMaxTris * 9];""")
    raw = _edit(raw, """  for (int i = threadIdx.x; i < n_tris * kRow4; i += blockDim.x) {
    s_tri[i] = tris[i];
  }""", """  const float* tris9 = reinterpret_cast<const float*>(tris);
  for (int i = threadIdx.x; i < n_tris * 9; i += blockDim.x) {
    s_tri9[i] = tris9[i];
  }""")
    raw = _edit(raw, """    const float4* p = s_tri + kRow4 * k;""",
                "    const float* q = s_tri9 + 9 * k;\n"
                + raw_tri("    ", "const float4 "))
    raw = _edit(raw, "tri_test::hit(p[0], p[1], p[2],",
                "tri_test::hit(r0, r1, r2,")
    bare = src
    for rule in PRETEST_RULES:
        bare = _edit(bare, rule, "")
    return {
        "shipped": src,
        "no lane packing": _edit(src, BRUTE_PACK, BRUTE_NO_PACK),
        RAW_ROWS: raw,
        "no pre-test": bare,
        "128 threads": _edit(src, "constexpr int kThreads = 256;",
                             "constexpr int kThreads = 128;"),
    }


def bvh_variants():
    src = _source("trace_bvh")
    staged = _edit(src, "    const float4* __restrict__ tris,   // (T, 12): p0 e1 e2 0 0 0\n",
                   "    const float4* __restrict__ tris,   // (T, 12): p0 e1 e2 0 0 0\n"
                   "    int n_nodes, int n_tris,\n")
    staged = staged.replace("        nd, tr, o, d,", "        nd, tr, n_nodes, n_tris, o, d,")
    for q in ("q0 = __ldg(&n[0])", "q1 = __ldg(&n[1])", "q2 = __ldg(&n[2])",
              "q3 = __ldg(&n[3])", "r0 = __ldg(&p[0])", "r1 = __ldg(&p[1])",
              "r2 = __ldg(&p[2])"):
        staged = _edit(staged, q, q.replace("__ldg(&", "").rstrip(")"))
    staged = _edit(staged, """    int64_t r, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, const float* __restrict__ ro,""",
                   """    int64_t r, const float4* nodes, const float4* tris,
    const float* __restrict__ ro,""")
    staged = staged.replace("node_row(const float4* __restrict__ nodes,",
                            "node_row(const float4* nodes,")
    staged = staged.replace("tri_row(const float4* __restrict__ tris,",
                            "tri_row(const float4* tris,")
    smem = """  const size_t smem = sizeof(float4) * (static_cast<size_t>(n_nodes) * kNode4 +
                                        static_cast<size_t>(n_tris) * kTri4);
  const void* fn = any_hit ? reinterpret_cast<const void*>(&trace_bvh_kernel<true>)
                           : reinterpret_cast<const void*>(&trace_bvh_kernel<false>);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
"""
    staged = _edit(staged, "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n",
                   smem + "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n")
    staged = staged.replace("kThreads, 0, s>>>", "kThreads, smem, s>>>")
    staged = _edit(staged, "  __shared__ int s_count[kThreads / 32];\n", STAGE)
    a_block = _edit(staged, "s_list[threadIdx.x], nodes, tris, ro,",
                    "s_list[threadIdx.x], s_rows, s_rows + n_node4, ro,")
    # the same, the block walking chunks of kThreads rays grid-stride
    a_sm = _edit(a_block, """  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
""", """  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
       base < n_rays; base += static_cast<int64_t>(gridDim.x) * kThreads) {
""")
    a_sm = _edit(a_sm, """                       stack_size);
  }
}""", """                       stack_size);
  }
  }
}""")
    a_sm = _edit(a_sm, "  cudaStream_t s = static_cast<cudaStream_t>(stream);\n",
                 """  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  const int64_t fill = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = blocks < fill ? blocks : fill;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
""")
    a_sm = a_sm.replace("<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>",
                        "<<<static_cast<unsigned>(grid), kThreads, smem, s>>>")
    raw = _edit(src, """  const float4* n = nodes + kNode4 * i;
  q0 = __ldg(&n[0]);
  q1 = __ldg(&n[1]);
  q2 = __ldg(&n[2]);
  q3 = __ldg(&n[3]);""", """  const float* n = reinterpret_cast<const float*>(nodes) + 14 * i;
  q0 = make_float4(__ldg(n), __ldg(n + 1), __ldg(n + 2), __ldg(n + 3));
  q1 = make_float4(__ldg(n + 4), __ldg(n + 5), __ldg(n + 6), __ldg(n + 7));
  q2 = make_float4(__ldg(n + 8), __ldg(n + 9), __ldg(n + 10), __ldg(n + 11));
  q3 = make_float4(__ldg(n + 12), __ldg(n + 13), 0.0f, 0.0f);""")
    raw = _edit(raw, """  const float4* p = tris + kTri4 * k;
  r0 = __ldg(&p[0]);
  r1 = __ldg(&p[1]);
  r2 = __ldg(&p[2]);""", """  const float* g = reinterpret_cast<const float*>(tris) + 9 * k;
  float q[9];
  for (int j = 0; j < 9; ++j) q[j] = __ldg(g + j);
""" + raw_tri("  ", ""))
    select = _edit(src, """  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;""", """  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);""")
    select = _edit(select, """  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;""", """  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);""")
    start = src.index("  while (true) {\n    // ---- node steps")
    end = src.index("  out_t[r] = t_best;", start) + len("  out_t[r] = t_best;")
    ifif = src[:start] + IF_IF_WALK + src[end:]
    bare = src
    for rule in PRETEST_RULES:
        bare = _edit(bare, rule, "")
    return {
        "shipped": src,
        "no lane packing": _edit(src, BVH_PACK, BVH_NO_PACK),
        "staged a block": a_block,
        "staged a block, a few blocks an SM walking rays grid-stride": a_sm,
        RAW_ROWS: raw,
        "compare-select min / max": select,
        "if-if walk": ifif,
        "no pre-test": bare,
        "128 threads": _edit(src, "constexpr int kThreads = 256;",
                             "constexpr int kThreads = 128;"),
    }


def tlas_variants():
    tlas = _source("trace_tlas")
    smem = _edit(tlas, "    int32_t stack[kMaxStack];\n",
                 "    __shared__ int32_t s_stack[kMaxStack * kThreads];\n")
    smem = _edit(smem, "stack[sp] = ", "s_stack[sp * kThreads + threadIdx.x] = ")
    smem = _edit(smem, "stack[top]", "s_stack[top * kThreads + threadIdx.x]")
    pers = _edit(tlas, """    int stack_size) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n_rays) {
    trace_ray<kAnyHit>(r, rows, w4, ro, rd, t_min, t_max, active, ray_mask,
                       out_t, out_prim, out_u, out_v, out_bf, out_inst,
                       max_leaf, stack_size);
  }
}""", """    int stack_size, int* __restrict__ counter) {
  const int lane = threadIdx.x & 31;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n_rays) break;
    const int r = base + lane;
    if (r < n_rays) {
      trace_ray<kAnyHit>(r, rows, w4, ro, rd, t_min, t_max, active,
                         ray_mask, out_t, out_prim, out_u, out_v, out_bf,
                         out_inst, max_leaf, stack_size);
    }
  }
}""")
    pers = _edit(pers, "    int stack_size, int any_hit, void* stream) {",
                 "    int stack_size, void* counter, int any_hit, void* stream) {")
    pers = _edit(pers, """  const int blocks = static_cast<int>((n_rays + kThreads - 1) / kThreads);""",
                 """  int sms = 0, per_sm = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, any_hit ? (const void*)&trace_tlas_kernel<true>
                       : (const void*)&trace_tlas_kernel<false>, kThreads, 0);
  const int64_t need = (n_rays + kThreads - 1) / kThreads;
  const int64_t fill = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(need < fill ? need : fill);""")
    pers = pers.replace("        max_leaf, stack_size);",
                        "        max_leaf, stack_size, static_cast<int*>(counter));")
    return {
        "shipped": tlas,
        "shared-memory stack": smem,
        "persistent warps": pers,
        "64 registers": _edit(tlas, "__launch_bounds__(kThreads) trace_tlas_kernel(",
                              "__launch_bounds__(kThreads, 8) trace_tlas_kernel("),
    }


def binned_variants():
    binned = _source("trace_binned")
    one = _edit(binned, """  const int lane = threadIdx.x & 31;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n_rays) break;
    const int r = base + lane;
    if (r < n_rays) {""", """  {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < n_rays) {""")
    one = _edit(one, """  const int err = persistent_blocks(kernel, n_rays, &blocks);
  if (err != 0) return err;""", """  (void)kernel;
  blocks = static_cast<int>((n_rays + kThreads - 1) / kThreads);""")
    return {
        "shipped": binned,
        "one thread a ray": one,
        "128 threads a block": _edit(
            binned, "constexpr int kThreads = 64;", "constexpr int kThreads = 128;"),
        "16 candidates": _edit(
            binned, "constexpr int kList = 8;", "constexpr int kList = 16;"),
        "midpoint splits": binned,
    }


VARIANTS = {"trace_brute": brute_variants, "trace_bvh": bvh_variants,
            "trace_tlas": tlas_variants, "trace_binned": binned_variants}


def build(srcs):
    """{(kernel, name): the variant's bound C entry point}, all built at
    once; prints each build's registers."""
    from ray_tpu_torch.ops import cuda_build, traverse

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, src) in enumerate(srcs.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(src)
        procs[key] = (OUT / f"v{i}.so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(OUT / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ours = {"trace_brute": traverse._brute_fn, "trace_bvh": traverse._bvh_fn,
            "trace_tlas": traverse._tlas_fn,
            "trace_binned": traverse._binned_fn}
    fns = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"{key[0]} {key[1]}: registers {', '.join(regs)}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), f"{key[0]}_launch")
        fn.argtypes = list(ours[key[0]]().argtypes)
        fn.restype = ctypes.c_int
        if key == ("trace_tlas", "persistent warps"):
            fn.argtypes.insert(-2, ctypes.c_void_p)
        fns[key] = fn
    return fns


def midpoint_tree(binned):
    """The binned scene's subtree tree with every split at the middle of
    its sid range (a balanced tree), on the card."""
    import numpy as np
    import torch

    from ray_tpu_torch.scene import binned as binned_mod

    lo = binned["sub_lo"].cpu().numpy()
    hi = binned["sub_hi"].cpu().numpy()
    S = lo.shape[0]
    tree = np.zeros((2 * S - 1, 8), np.float32)
    todo = [(0, 0, S)]
    while todo:
        k, a, b = todo.pop()
        if b - a == 1:
            tree[k, 0:3], tree[k, 3:6] = lo[a], hi[a]
            continue
        tree[k, 0:3] = np.fmin.reduce(np.fmin(lo[a:b], hi[a:b]), axis=0)
        tree[k, 3:6] = np.fmax.reduce(np.fmax(lo[a:b], hi[a:b]), axis=0)
        m = (a + b) // 2
        tree.view(np.int32)[k, 6] = m
        todo += [(k + 1, a, m), (k + 2 * (m - a), m, b)]
    assert binned_mod.PICK_STACK >= int(np.ceil(np.log2(S)))
    return torch.from_numpy(tree).to(binned["sub_lo"].device)


def variant_launch(key, fn, args, any_hit, counter):
    """chip_smoke.raw_launch of the variant ``key`` on a captured launch:
    (closure, outputs)."""
    import chip_smoke as cs

    kernel, name = key
    tables = cs.split_args(kernel, args)[0]
    arrays = None
    if name == RAW_ROWS:
        arrays = tables
    elif name == "midpoint splits":
        arrays = (*cs.kernel_arrays(kernel, tables)[:2],
                  midpoint_tree(tables[0]))
    if name == "persistent warps":
        def call(*a, fn=fn):
            return fn(*a[:-2], counter(), *a[-2:])
        return cs.raw_launch(kernel, args, any_hit, fn=call, arrays=arrays)
    return cs.raw_launch(kernel, args, any_hit, fn=fn, arrays=arrays)


def main() -> int:
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.render.integrator import PassSettings

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    kernels = (sys.argv[sys.argv.index("--kernels") + 1].split(",")
               if "--kernels" in sys.argv else KERNELS)
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    fns = build({(k, name): src for k in kernels
                 for name, src in VARIANTS[k]().items()})
    st = PassSettings(max_total_depth=5, min_total_depth=2)
    big = PassSettings(max_total_depth=5, min_total_depth=2, compact_after=2,
                       compact_factor=4)
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    used = [0]

    def counter():
        used[0] += 1
        return counters.data_ptr() + 4 * used[0]

    scenes = {"flagship": (cs.flagship, "trace_brute"),
              "cornell_sphere": (cs.cornell_sphere, "trace_bvh"),
              "colonnade": (cs.colonnade, "trace_tlas"),
              "colonnade flatten": (cs.colonnade, "trace_tlas"),
              "colonnade binned": (cs.colonnade_binned, "trace_binned")}
    for label, (make, kernel) in scenes.items():
        if kernel not in kernels:
            continue
        sc, cam = make()
        scene = sc.finalize(**cs.FINALIZE.get(label, {}))
        if label.startswith("colonnade"):
            tw, th = cs.WIDTH // 2, cs.HEIGHT // 2
            _, calls = cs.capture_frame(scene, cam, big, 1, cs.WIDTH - tw, 0,
                                        tw, th)
        else:
            _, calls = cs.capture_frame(scene, cam, st, 1)
        times = {k: {False: [], True: []} for k in fns if k[0] == kernel}
        for _, args, any_hit in calls:
            ref = None
            for key in times:
                launch, outs = variant_launch(key, fns[key], args, any_hit,
                                              counter)
                launch()
                torch.cuda.synchronize()
                if ref is None:
                    ref = [o.clone() for o in outs]
                elif not all(cs.same_bits(a, b) for a, b in zip(outs, ref)):
                    cs.fail(f"{label}: {key[1]} differs from the shipped "
                            f"{kernel}")
                times[key][any_hit].append(cs.time_launches(launch, REPS))
        for key, by_mode in times.items():
            print(f"{label}: {kernel} {key[1]}: closest "
                  f"{statistics.fmean(by_mode[False]):.5f} ms, any-hit "
                  f"{statistics.fmean(by_mode[True]):.5f} ms a launch (mean "
                  f"of {len(by_mode[False])} + {len(by_mode[True])} launches) "
                  f"[{cs.CARD}]", flush=True)
        del scene, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
