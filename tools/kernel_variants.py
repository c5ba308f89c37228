#!/usr/bin/env python3
"""Time the design steps of the binned and two-level kernels against the
shipped ones, on one CUDA card.

    python3 tools/kernel_variants.py

Each variant is the shipped ``ray_tpu_torch/csrc/trace_binned.cu`` or
``trace_tlas.cu`` with one design step undone or changed by a text edit
(written to ``build/kernel_variants/``, built with the port's nvcc flags):

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

On the captured launches of ``chip_smoke.py``'s phase-10 tiles (the
top-right 960x540 tile of the instanced and flattened colonnade for
``trace_tlas``, of the binned one for ``trace_binned``) every variant's
outputs are held bit-equal to the shipped kernel's, and each is timed
(CUDA events, 30 launches) beside the shipped one; the mean per mode is
printed with the card's name and power limit.
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
OUT = ROOT / "build" / "kernel_variants"
REPS = 30


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"variant anchor not found: {old[:60]!r}")
    return src.replace(old, new)


def variants():
    """{(kernel, name): source} of the variants (the shipped one as
    ``shipped``)."""
    csrc = ROOT / "ray_tpu_torch" / "csrc"
    tlas = (csrc / "trace_tlas.cu").read_text()
    binned = (csrc / "trace_binned.cu").read_text()
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
    cap = _edit(tlas, "__launch_bounds__(kThreads) trace_tlas_kernel(",
                "__launch_bounds__(kThreads, 8) trace_tlas_kernel(")
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
        ("trace_tlas", "shipped"): tlas,
        ("trace_tlas", "shared-memory stack"): smem,
        ("trace_tlas", "persistent warps"): pers,
        ("trace_tlas", "64 registers"): cap,
        ("trace_binned", "shipped"): binned,
        ("trace_binned", "one thread a ray"): one,
        ("trace_binned", "128 threads a block"): _edit(
            binned, "constexpr int kThreads = 64;", "constexpr int kThreads = 128;"),
        ("trace_binned", "16 candidates"): _edit(
            binned, "constexpr int kList = 8;", "constexpr int kList = 16;"),
        ("trace_binned", "midpoint splits"): binned,
    }


def build(srcs):
    from ray_tpu_torch.ops import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, src) in enumerate(srcs.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(src)
        procs[key] = (OUT / f"v{i}.so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(OUT / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"{key[0]} {key[1]}: registers {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(so))
        if key[0] == "trace_tlas":
            lib.trace_tlas_launch.argtypes = [
                p, i, i, p, p, p, p, p, p, i64, p, p, p, p, p, p, i, i,
                *([p] if key[1] == "persistent warps" else []), i, p]
        else:
            lib.trace_binned_launch.argtypes = [
                p, p, p, i, p, p, p, p, p, i64, p, p, p, p, p, i, i, p, i, p]
        libs[key] = lib
    return libs


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


def main() -> int:
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import traverse
    from ray_tpu_torch.render.integrator import PassSettings

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    libs = build(variants())
    st = PassSettings(max_total_depth=5, min_total_depth=2, compact_after=2,
                      compact_factor=4)
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    used = [0]

    def counter():
        used[0] += 1
        return counters.data_ptr() + 4 * used[0]

    makers = {"colonnade": cs.colonnade, "colonnade flatten": cs.colonnade,
              "colonnade binned": cs.colonnade_binned}
    for label, make in makers.items():
        sc, cam = make()
        scene = sc.finalize(**cs.FINALIZE.get(label, {}))
        tw, th = cs.WIDTH // 2, cs.HEIGHT // 2
        _, calls = cs.capture_frame(scene, cam, st, 1, cs.WIDTH - tw, 0, tw,
                                    th)
        kernel = calls[0][0]
        times = {k: {False: [], True: []} for k in libs if k[0] == kernel}
        for _, args, any_hit in calls:
            tables, rays, extra = cs.split_args(kernel, args)
            if kernel == "trace_binned":
                rays = cs.sorted_rays(tables[0], rays)
                node_rows, tri_rows, tree = traverse._binned_kernel_tables(
                    tables[0])
                mid = midpoint_tree(tables[0])
                S = cs.binned_arrays(tables[0])[1]
            R = rays[0].shape[0]
            ref = None
            for key in times:
                lib = libs[key]
                outs = [torch.empty(R, dtype=d, device="cuda") for d in (
                    torch.float32, torch.int32, torch.float32, torch.float32,
                    torch.bool, torch.int32)]
                ptrs = [t.data_ptr() for t in rays]
                stream = torch.cuda.current_stream().cuda_stream
                if kernel == "trace_tlas":
                    (rows,), (mask, ml, ss) = tables, extra
                    fixed = (rows.data_ptr(), rows.shape[0], rows.shape[1],
                             *ptrs, None if mask is None else mask.data_ptr(),
                             R, *(o.data_ptr() for o in outs), ml, ss)

                    def launch(lib=lib, fixed=fixed,
                               ctr=key[1] == "persistent warps"):
                        return lib.trace_tlas_launch(
                            *fixed, *((counter(),) if ctr else ()),
                            int(any_hit), stream)
                else:
                    t = mid if key[1] == "midpoint splits" else tree
                    fixed = (node_rows.data_ptr(), tri_rows.data_ptr(),
                             t.data_ptr(), S, *ptrs, R,
                             *(o.data_ptr() for o in outs[:5]), *extra,
                             tables[0]["stack_arr"].shape[0])

                    def launch(lib=lib, fixed=fixed):
                        return lib.trace_binned_launch(*fixed, counter(),
                                                       int(any_hit), stream)
                if launch() != 0:
                    cs.fail(f"{key} launch failed")
                torch.cuda.synchronize()
                n_out = 6 if kernel == "trace_tlas" else 5
                if ref is None:
                    ref = [o.clone() for o in outs[:n_out]]
                elif not all(cs.same_bits(a, b) for a, b in zip(outs, ref)):
                    cs.fail(f"{label}: {key[1]} differs from the shipped "
                            f"{kernel}")

                def timed(launch=launch):
                    if launch() != 0:
                        cs.fail(f"{key} launch failed while timing")
                times[key][any_hit].append(cs.time_launches(timed, REPS))
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
