"""The port's CUDA kernels on the card (skipped on machines without CUDA).

Run on a CUDA machine with
``python -m pytest tests/test_torch_cuda.py --noconftest -m cuda`` (the
suite's conftest needs JAX, which the port does not); ``chip_smoke.py``
runs the same checks at the flagship frame's full size.  Each kernel is
held bit-exact against its plain PyTorch version, and each scene's path
is shown to launch its kernel: the flagship ``trace_brute``, the
``cornell_sphere`` scene (376 triangles) ``trace_bvh``, the instanced
colonnade ``trace_tlas``, a big flatten scene ``trace_tlas`` over its
``wrows`` (the wide route) and, finalized with ``pallas_binned=True``,
``trace_binned``.  The shading slice's scenes (the four CPU goldens' and
the alpha box) hold every trace launch of a tile, the transparency
marches' included, bit-exact against the plain version, and one golden
renders at its 400 samples within the goldens' gate.  The traversal
slice: ``trace_tlas_bin`` (the binary two-level walk of tlas scenes of
≤ 256 unique triangles), the masked ``trace_bvh`` and wide-route
instantiations and ``trace_tlas`` at ``max_leaf`` 6 and 7 (padded rows)
bit-exact, and every launch of a tile of the slice's scenes.  The sky
and texture slice: every launch of a tile of ``physical_sky``,
``tex_features``, ``sphere_hlbvh`` (``fast_build=True``) and the flagship
with ``output_sh``, and the compressed-texture decode on the card against
the CPU.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels build there)")


def _case(n_tris, n_rays, seed):
    r = np.random.RandomState(seed)
    tris = ((r.rand(n_tris, 1, 3) - 0.5) * 10.0
            + (r.rand(n_tris, 3, 3) - 0.5) * max(0.8, 12.0 / np.sqrt(n_tris)))
    ro = (r.rand(n_rays, 3) - 0.5) * 12.0
    rd = (r.rand(n_rays, 3) - 0.5) * 6.0 - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    dev = torch.device("cuda")
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return (f(tris.reshape(n_tris, 9)), f(ro), f(rd),
            torch.zeros(n_rays, device=dev),
            f(np.where(r.rand(n_rays) < 0.8, 1e30, r.rand(n_rays) * 8.0)),
            torch.tensor(r.rand(n_rays) < 0.9, device=dev))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris", [1, 8, 24, 33, 40])
def test_trace_brute_kernel_bit_exact(n_tris, any_hit):
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops.traverse import trace_brute, trace_brute_plain

    case = _case(n_tris, 300_001, n_tris)
    before = cuda_build.launch_counts.copy()
    k = trace_brute(*case, any_hit=any_hit)
    p = trace_brute_plain(*case, any_hit=any_hit)
    torch.cuda.synchronize()
    name = "trace_brute_anyhit" if any_hit else "trace_brute_closest"
    assert cuda_build.launch_counts[name] == before[name] + 1
    for f in k._fields:
        a, b = getattr(k, f), getattr(p, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def test_trace_brute_rejects_bad_inputs():
    _need_cuda()
    from ray_tpu_torch.ops.traverse import trace_brute

    tris, ro, rd, tmin, tmax, act = _case(8, 64, 0)
    with pytest.raises(ValueError):
        trace_brute(tris, ro[:, :2].contiguous(), rd, tmin, tmax, act)
    with pytest.raises(ValueError):
        trace_brute(tris, ro.t().contiguous().t(), rd, tmin, tmax, act)
    with pytest.raises(TypeError):
        trace_brute(tris, ro.double(), rd, tmin, tmax, act)
    with pytest.raises(ValueError):
        trace_brute(tris, ro.cpu(), rd, tmin, tmax, act)
    with pytest.raises(ValueError):
        trace_brute(_case(41, 64, 0)[0], ro, rd, tmin, tmax, act)


def test_flagship_tile_launches_the_kernel():
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render.integrator import PassSettings, render_tile
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    sc, cam = cornell_scene()
    scene = sc.finalize()
    assert scene.device.type == "cuda"
    cuda_build.reset_launch_counts()
    out = render_tile(scene, cam, None, 832, 476, 1, 0, width=1920,
                      height=1080, tile_w=256, tile_h=128,
                      settings=PassSettings(max_total_depth=5,
                                            min_total_depth=2),
                      use_filter_table=False)
    assert bool(torch.isfinite(out["color"]).all())
    assert cuda_build.launch_counts["trace_brute_closest"] == 6
    assert cuda_build.launch_counts["trace_brute_anyhit"] == 6


def _bvh_case(n_tris, n_rays, seed, max_leaf):
    from ray_tpu_torch.scene.bvh import (
        build_bvh2, bvh_depth, pack_bvh_soa, tri_bounds)

    tris, ro, rd, tmin, tmax, act = _case(n_tris, n_rays, seed)
    v = tris.cpu().numpy().reshape(-1, 3)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    bvh = build_bvh2(*tri_bounds(v, idx), max_leaf=max_leaf)
    dev = tris.device
    nodes = torch.from_numpy(pack_bvh_soa(bvh)["packed"]).to(dev)
    leaf_tris = torch.from_numpy(
        np.ascontiguousarray(v[idx[bvh.prim_indices]].reshape(n_tris, 9))).to(dev)
    r = np.random.RandomState(seed + 3)
    tmin = torch.tensor(np.where(r.rand(n_rays) < 0.3, r.rand(n_rays) * 4.0,
                                 0.0), dtype=torch.float32, device=dev)
    return (nodes, leaf_tris, ro, rd, tmin, tmax, act, max_leaf,
            bvh_depth(bvh) + 4)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris,max_leaf,stack", [
    (41, 4, None), (100, 4, None), (300, 8, None), (512, 8, None),
    (512, 4, 2),   # a stack shallower than the tree: overflow semantics
    (512, 1, None),  # 511 node rows: the largest tables
])
def test_trace_bvh_kernel_bit_exact(n_tris, max_leaf, stack, any_hit):
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops.traverse import trace_bvh, trace_bvh_plain

    case = _bvh_case(n_tris, 300_001, n_tris, max_leaf)
    if stack is not None:
        case = case[:-1] + (stack,)
    before = cuda_build.launch_counts.copy()
    k = trace_bvh(*case, any_hit=any_hit)
    p = trace_bvh_plain(*case, any_hit=any_hit)
    torch.cuda.synchronize()
    name = "trace_bvh_anyhit" if any_hit else "trace_bvh_closest"
    assert cuda_build.launch_counts[name] == before[name] + 1
    assert 0 < int((p.prim >= 0).sum()) < 300_001
    for f in k._fields:
        a, b = getattr(k, f), getattr(p, f)
        assert a.device == b.device and a.dtype == b.dtype, f
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def test_trace_bvh_rejects_bad_inputs():
    _need_cuda()
    from ray_tpu_torch.ops.traverse import trace_bvh

    nodes, tris, ro, rd, tmin, tmax, act, ml, ss = _bvh_case(100, 64, 0, 4)
    rays = (ro, rd, tmin, tmax, act)
    with pytest.raises(ValueError):
        trace_bvh(nodes[:, :13].contiguous(), tris, *rays, ml, ss)
    with pytest.raises(ValueError):
        trace_bvh(nodes, tris, ro[:, :2].contiguous(), *rays[1:], ml, ss)
    with pytest.raises(TypeError):
        trace_bvh(nodes.double(), tris, *rays, ml, ss)
    with pytest.raises(ValueError):
        trace_bvh(nodes.cpu(), tris, *rays, ml, ss)
    # the 512-row cap is gone (a TPU's VMEM): masks of the wrong shape,
    # type or device, or a ray mask without per-triangle masks, raise
    vis = torch.full((tris.shape[0],), 31, dtype=torch.int32, device="cuda")
    mask = torch.full((64,), 1, dtype=torch.int32, device="cuda")
    for bad in (dict(tri_vis=vis[:-1], ray_mask=mask),
                dict(tri_vis=vis, ray_mask=mask[:-1]),
                dict(tri_vis=vis.cpu(), ray_mask=mask),
                dict(ray_mask=mask)):
        with pytest.raises((ValueError, TypeError)):
            trace_bvh(nodes, tris, *rays, ml, ss, **bad)
    with pytest.raises(TypeError):
        trace_bvh(nodes, tris, *rays, ml, ss, tri_vis=vis.float(),
                  ray_mask=mask)
    for bad_leaf, bad_stack in ((0, ss), (16, ss), (ml, 0), (ml, 65)):
        with pytest.raises(ValueError):
            trace_bvh(nodes, tris, *rays, bad_leaf, bad_stack)


def test_cornell_sphere_tile_launches_the_bvh_kernel():
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render.integrator import PassSettings, render_tile
    from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
    from ray_tpu_torch.utils.geometry import make_uv_sphere
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    sc, cam = cornell_scene()
    m = sc.add_material(MaterialDesc(type=ShadingNode.DIFFUSE,
                                     base_color=(0.2, 0.3, 0.8), roughness=0.5))
    v, idx, n, uv = make_uv_sphere(center=(0.4, -0.64, -0.3), radius=0.35,
                                   rings=12, segments=16)
    sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
    scene = sc.finalize()
    assert scene.num_tris == 376 and "wrows" in scene.bvh_soa
    cuda_build.reset_launch_counts()
    out = render_tile(scene, cam, None, 640, 760, 1, 0, width=1920,
                      height=1080, tile_w=256, tile_h=128,
                      settings=PassSettings(max_total_depth=5,
                                            min_total_depth=2),
                      use_filter_table=False)
    assert bool(torch.isfinite(out["color"]).all())
    assert cuda_build.launch_counts["trace_bvh_closest"] == 6
    assert cuda_build.launch_counts["trace_bvh_anyhit"] == 6
    assert cuda_build.launch_counts["trace_brute_closest"] == 0


def _tlas_case(n_inst, n_rays, seed, stack=None, mask=False):
    from ray_tpu_torch.utils.test_scenes import instanced_scene

    scene = instanced_scene(n_inst=n_inst).finalize(device="cuda")
    r = np.random.RandomState(seed)
    dev = torch.device("cuda")
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    ro = (r.rand(n_rays, 3) - 0.5) * 8.0
    rd = r.randn(n_rays, 3)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ray_mask = None
    if mask:
        ray_mask = torch.tensor(np.where(r.rand(n_rays) < 0.5, 0x7fffffff, 2),
                                dtype=torch.int32, device=dev)
    return (scene.bvh_soa["wrows_tlas"], int(scene.bvh_soa["winst_base"]),
            f(ro), f(rd), f(np.where(r.rand(n_rays) < 0.3, r.rand(n_rays), 0.0)),
            f(np.where(r.rand(n_rays) < 0.8, 1e30, r.rand(n_rays) * 6.0)),
            torch.tensor(r.rand(n_rays) < 0.9, device=dev), ray_mask,
            scene.max_leaf, stack or scene.stack_size)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_inst,stack,mask", [
    (6, None, False), (64, None, False), (64, None, True),
    (64, 4, False),   # a stack shallower than the tree: overflow semantics
])
def test_trace_tlas_kernel_bit_exact(n_inst, stack, mask, any_hit):
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops.traverse import trace_tlas, trace_tlas_plain

    case = _tlas_case(n_inst, 300_001, n_inst, stack, mask)
    before = cuda_build.launch_counts.copy()
    k = trace_tlas(*case, any_hit=any_hit)
    p = trace_tlas_plain(*case, any_hit=any_hit)
    torch.cuda.synchronize()
    name = "trace_tlas_anyhit" if any_hit else "trace_tlas_closest"
    assert cuda_build.launch_counts[name] == before[name] + 1
    assert 0 < int((p.prim >= 0).sum()) < 300_001
    for f in k._fields:
        a, b = getattr(k, f), getattr(p, f)
        assert a.device == b.device and a.dtype == b.dtype, f
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def test_trace_tlas_rejects_bad_inputs():
    _need_cuda()
    from ray_tpu_torch.ops.traverse import trace_tlas

    rows, base, ro, rd, tmin, tmax, act, _, ml, ss = _tlas_case(6, 64, 0)
    rays = (ro, rd, tmin, tmax, act)
    with pytest.raises(ValueError):   # width != max(56, 11 max_leaf, 14)
        trace_tlas(rows[:, :55].contiguous(), base, *rays, None, ml, ss)
    with pytest.raises(ValueError):   # the table has 56 columns, not 88
        trace_tlas(rows, base, *rays, None, 8, ss)
    with pytest.raises(ValueError):
        trace_tlas(rows.t().contiguous().t(), base, *rays, None, ml, ss)
    with pytest.raises(TypeError):
        trace_tlas(rows.double(), base, *rays, None, ml, ss)
    with pytest.raises(ValueError):
        trace_tlas(rows.cpu(), base, *rays, None, ml, ss)
    with pytest.raises(ValueError):
        trace_tlas(rows, base, ro[:, :2].contiguous(), *rays[1:], None, ml, ss)
    with pytest.raises(TypeError):
        trace_tlas(rows, base, *rays, torch.zeros(64, device="cuda"), ml, ss)
    with pytest.raises(ValueError):
        trace_tlas(rows, base, *rays, torch.zeros(63, dtype=torch.int32,
                                                  device="cuda"), ml, ss)
    for bad_stack in (0, 65):
        with pytest.raises(ValueError):
            trace_tlas(rows, base, *rays, None, ml, bad_stack)


def test_colonnade_tile_launches_the_tlas_kernel():
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render.integrator import PassSettings, render_tile
    from ray_tpu_torch.utils.test_scenes import colonnade_scene

    sc, cam = colonnade_scene()
    scene = sc.finalize()
    assert scene.device.type == "cuda" and scene.mode == "tlas"
    cuda_build.reset_launch_counts()
    out = render_tile(scene, cam, None, 832, 476, 1, 0, width=1920,
                      height=1080, tile_w=256, tile_h=128,
                      settings=PassSettings(max_total_depth=5,
                                            min_total_depth=2,
                                            compact_after=2,
                                            compact_factor=4),
                      use_filter_table=False)
    assert bool(torch.isfinite(out["color"]).all())
    assert float(out["color"].mean()) > 0.0
    counts = dict(cuda_build.launch_counts)
    assert counts.get("trace_tlas_closest") == 6, counts
    assert counts.get("trace_tlas_anyhit") == 6, counts
    assert not any(counts.get(f"{k}_{m}") for k in ("trace_brute", "trace_bvh")
                   for m in ("closest", "anyhit")), counts


def _binned_case(n_tris, n_rays, seed, stack=None):
    """A generator cloud (max_leaf 4; the native builder from 8,192
    triangles on) packed into subtree slabs, and rays with a t window."""
    from ray_tpu_torch.scene.binned import pack_binned_scene
    from ray_tpu_torch.scene.bvh import build_bvh2, pack_tri_soa, tri_bounds

    tris, ro, rd, _, tmax, act = _case(n_tris, n_rays, seed)
    v = tris.cpu().numpy().reshape(-1, 3)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    bvh = build_bvh2(*tri_bounds(v, idx), max_leaf=4)
    binned = pack_binned_scene(bvh, pack_tri_soa(v, idx[bvh.prim_indices]))
    if stack is not None:
        binned["stack_arr"] = np.zeros(stack, np.int8)
    dev = ro.device
    r = np.random.RandomState(seed + 3)
    tmin = torch.tensor(np.where(r.rand(n_rays) < 0.3, r.rand(n_rays) * 4.0,
                                 0.0), dtype=torch.float32, device=dev)
    return ({k: torch.from_numpy(a).to(dev) for k, a in binned.items()},
            ro, rd, tmin, tmax, act, 4)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris,stack", [
    (3000, None), (20_000, None),
    (20_000, 3),   # a stack shallower than the subtrees: overflow semantics
])
def test_trace_binned_kernel_bit_exact(n_tris, stack, any_hit):
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops.traverse import (
        binned_sort_key, binned_sort_key_plain, trace_binned,
        trace_binned_plain)

    case = _binned_case(n_tris, 300_001, n_tris, stack)
    key = binned_sort_key(*case[:6])
    assert torch.equal(key, binned_sort_key_plain(
        case[0]["sub_lo"], case[0]["sub_hi"], *case[1:6]))
    before = cuda_build.launch_counts.copy()
    p = trace_binned_plain(*case, any_hit=any_hit)
    for sort_rays in (True, False):
        k = trace_binned(*case, any_hit=any_hit, sort_rays=sort_rays)
        torch.cuda.synchronize()
        assert 0 < int((p.prim >= 0).sum()) < 300_001
        for f in k._fields:
            a, b = getattr(k, f), getattr(p, f)
            assert a.device == b.device and a.dtype == b.dtype, f
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (f, sort_rays)
    name = "trace_binned_anyhit" if any_hit else "trace_binned_closest"
    assert cuda_build.launch_counts[name] == before[name] + 2
    assert (cuda_build.launch_counts["trace_binned_sortkey"]
            == before["trace_binned_sortkey"] + 1)


def _bit_exact(k, p, label):
    for f in k._fields:
        a, b = getattr(k, f), getattr(p, f)
        assert a.device == b.device and a.dtype == b.dtype, (label, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (label, f)


@pytest.fixture(scope="module")
def stress():
    """chip_smoke.py's exactness stress inputs at 100,000 rays: the
    triangle test's edge cases for trace_brute and trace_bvh (det exactly
    0 and subnormal, U and V whose products round to -0, rays through
    vertices and along edges, t exactly at t_min and t_max, t_min < 0,
    equal t, inf and NaN components; trace_bvh at max_leaf 15 and with a
    stack of 2; all lanes inactive), a binned grid cloud whose subtree
    boxes share faces, hit by axis-aligned rays on the lattice (the sid
    tie-break decides), its stack cut to 3 (the overflow path), and
    trace_tlas on width-56 (ray mask; stack 4) and width-88 tables; the
    last three with rays starting inside boxes, zero and NaN direction
    components, NaN origins and t_min > 0."""
    _need_cuda()
    import chip_smoke

    return chip_smoke.stress_cases(100_000, torch.device("cuda"))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("label", [
    "brute edge triangles", "brute all inactive",
    "bvh edge triangles, max_leaf 15", "bvh edge triangles, stack 2",
    "bvh all inactive", "grid cloud", "grid cloud, stack 3",
    "tlas width 56, ray mask", "tlas width 56, stack 4", "wide width 88"])
def test_kernels_bit_exact_under_stress(stress, label, any_hit):
    from ray_tpu_torch.ops import cuda_build, traverse

    (kernel, case), = [v for k, v in stress.items() if k.startswith(label)
                       and (label != "grid cloud" or "stack" not in k)]
    if kernel == "trace_binned":
        key = traverse.binned_sort_key(*case[:6])
        assert torch.equal(key, traverse.binned_sort_key_plain(
            case[0]["sub_lo"], case[0]["sub_hi"], *case[1:6]))
    name = f"{kernel}_{'anyhit' if any_hit else 'closest'}"
    before = cuda_build.launch_counts[name]
    k = getattr(traverse, kernel)(*case, any_hit=any_hit)
    p = getattr(traverse, f"{kernel}_plain")(*case, any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts[name] == before + 1
    hits = int((p.prim >= 0).sum())
    if "inactive" in label:
        assert hits == 0
    else:
        assert 0 < hits < p.prim.shape[0]
    _bit_exact(k, p, label)


def test_trace_tlas_rejects_rows_it_cannot_read_as_float4():
    """Rows the kernel cannot read as 16-byte loads raised here until the
    wrapper padded them: a width that is not a multiple of 4 floats
    (``max_leaf`` 6, 7, 9-11, 13-15) or a base that is not 16-byte aligned
    now runs on a cached padded copy, bit-exact; a table narrower than
    ``tlas_width(max_leaf)`` still raises."""
    _need_cuda()
    from ray_tpu_torch.ops.traverse import (
        tlas_width, trace_tlas, trace_tlas_plain)
    from ray_tpu_torch.utils.test_scenes import instanced_scene

    rows, base, ro, rd, tmin, tmax, act, _, ml, ss = _tlas_case(6, 20_000, 0)
    rays = (ro, rd, tmin, tmax, act)
    shifted = torch.zeros(rows.numel() + 1, device="cuda")[1:].view(
        rows.shape)
    shifted.copy_(rows)
    _bit_exact(trace_tlas(shifted, base, *rays, None, ml, ss),
               trace_tlas_plain(rows, base, *rays, None, ml, ss), "shifted")
    for max_leaf in (6, 7):
        sc = instanced_scene(n_inst=6).finalize(max_leaf=max_leaf)
        args = (sc.bvh_soa["wrows_tlas"], int(sc.bvh_soa["winst_base"]),
                *rays, None, max_leaf, sc.stack_size)
        assert args[0].shape[1] == tlas_width(max_leaf)
        for any_hit in (False, True):
            p = trace_tlas_plain(*args, any_hit=any_hit)
            assert int((p.prim >= 0).sum()) > 0
            _bit_exact(trace_tlas(*args, any_hit=any_hit), p,
                       f"max_leaf {max_leaf}")
    with pytest.raises(ValueError):
        trace_tlas(rows[:, :55].contiguous(), base, *rays, None, ml, ss)


def test_trace_binned_rejects_bad_inputs():
    _need_cuda()
    from ray_tpu_torch.ops.traverse import trace_binned

    binned, ro, rd, tmin, tmax, act, ml = _binned_case(3000, 64, 0)
    rays = (ro, rd, tmin, tmax, act)
    with pytest.raises(ValueError):   # slab_f rows do not match S
        trace_binned(dict(binned, slab_f=binned["slab_f"][:-8].contiguous()),
                     *rays, ml)
    with pytest.raises(TypeError):
        trace_binned(dict(binned, slab_i=binned["slab_i"].float()), *rays, ml)
    with pytest.raises(ValueError):
        trace_binned(dict(binned, sub_lo=binned["sub_lo"].cpu()), *rays, ml)
    with pytest.raises(ValueError):
        trace_binned(binned, ro[:, :2].contiguous(), *rays[1:], ml)
    with pytest.raises(ValueError):   # one subtree
        one = {k: v[:88] if k == "slab_f" else v[:16] if k == "slab_i"
               else v[:1] if k in ("sub_lo", "sub_hi") else v
               for k, v in binned.items()}
        trace_binned(one, *rays, ml)
    with pytest.raises(ValueError):
        trace_binned(dict(binned, stack_arr=torch.zeros(65)), *rays, ml)
    for bad_leaf in (0, 16):
        with pytest.raises(ValueError):
            trace_binned(binned, *rays, bad_leaf)


def _big_flatten_tile(**finalize):
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render.integrator import PassSettings, render_tile
    from ray_tpu_torch.utils.test_scenes import colonnade_scene

    sc, cam = colonnade_scene(n_cols=5)
    scene = sc.finalize(instancing="flatten", **finalize)
    assert scene.device.type == "cuda" and scene.mode == "flatten"
    cuda_build.reset_launch_counts()
    out = render_tile(scene, cam, None, 832, 476, 1, 0, width=1920,
                      height=1080, tile_w=256, tile_h=128,
                      settings=PassSettings(max_total_depth=5,
                                            min_total_depth=2,
                                            compact_after=2,
                                            compact_factor=4),
                      use_filter_table=False)
    assert bool(torch.isfinite(out["color"]).all())
    assert float(out["color"].mean()) > 0.0
    return dict(cuda_build.launch_counts)


def test_binned_colonnade_tile_launches_the_binned_kernel():
    _need_cuda()
    counts = _big_flatten_tile(pallas_binned=True)
    assert counts.get("trace_binned_closest") == 6, counts
    assert counts.get("trace_binned_anyhit") == 6, counts
    assert not any(counts.get(f"{k}_{m}")
                   for k in ("trace_brute", "trace_bvh", "trace_tlas")
                   for m in ("closest", "anyhit")), counts


def test_flatten_colonnade_tile_launches_only_the_tlas_kernel():
    """The wide route: ``trace_wide`` runs the ``trace_tlas`` kernel."""
    _need_cuda()
    counts = _big_flatten_tile()
    assert counts.get("trace_tlas_closest") == 6, counts
    assert counts.get("trace_tlas_anyhit") == 6, counts
    assert not any(counts.get(f"{k}_{m}")
                   for k in ("trace_brute", "trace_bvh", "trace_binned")
                   for m in ("closest", "anyhit")), counts


def _gather_case(n_out, seed, shape=(1024,)):
    """A float32 table with NaNs (payloads included), -0 and infinities,
    and int32 indices covering it."""
    r = np.random.default_rng(seed)
    n = int(np.prod(shape))
    bits = r.normal(size=n).astype(np.float32).view(np.uint32)
    bits[::7] = 0x7FC00000 | r.integers(0, 1 << 22, bits[::7].shape,
                                        dtype=np.uint32)
    bits[1::13] = 0x80000000
    bits[5::19] = 0xFF800000
    table = torch.from_numpy(bits.view(np.float32).reshape(shape)).cuda()
    idx = torch.from_numpy(r.integers(0, n, n_out).astype(np.int32)).cuda()
    return table, idx


@pytest.mark.parametrize("n_out,shape", [
    ((8, 128), (1024,)), ((8, 128), (1, 1024)),
    ((1080, 1920), (1024,)), ((3, 1_000_003), (1 << 20,))])
def test_gather_table_kernel_bit_exact(n_out, shape):
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops.gather_probe import gather_table, gather_table_plain

    table, idx = _gather_case(int(np.prod(n_out)), len(shape), shape)
    idx = idx.reshape(n_out)
    before = cuda_build.launch_counts["gather_table"]
    k = gather_table(table, idx)
    p = gather_table_plain(table, idx)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["gather_table"] == before + 1
    assert k.shape == idx.shape
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


def test_gather_table_rejects_bad_inputs():
    _need_cuda()
    from ray_tpu_torch.ops.gather_probe import gather_table

    table, idx = _gather_case(1024, 0)
    with pytest.raises(TypeError):
        gather_table(table.double(), idx)
    with pytest.raises(TypeError):
        gather_table(table, idx.long())
    with pytest.raises(ValueError):
        gather_table(table.reshape(2, 512), idx)
    with pytest.raises(ValueError):
        gather_table(table, idx.cpu())
    with pytest.raises(ValueError):
        gather_table(table, idx.reshape(32, 32).t())
    for bad in (-1, 1024):
        worse = idx.clone()
        worse[17] = bad
        with pytest.raises(IndexError):
            gather_table(table, worse)


@pytest.mark.parametrize("save_trace", [True, False])
def test_remat_tile_launch_counts(save_trace):
    """A 256x128 colonnade fwd+bwd tile at bench.py's big settings with
    remat: the forward launches 6 + 6 trace_tlas kernels; the backward none
    with ``remat_save_trace``, the same 6 + 6 again without it."""
    _need_cuda()
    import dataclasses

    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render.integrator import PassSettings, render_tile
    from ray_tpu_torch.utils.test_scenes import colonnade_scene

    sc, cam = colonnade_scene()
    scene = sc.finalize()
    params = {k: v.clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    scene = dataclasses.replace(scene,
                                materials={**scene.materials, **params})
    cuda_build.reset_launch_counts()
    out = render_tile(scene, cam, None, 832, 476, 1, 0, width=1920,
                      height=1080, tile_w=256, tile_h=128,
                      settings=PassSettings(max_total_depth=5,
                                            min_total_depth=2,
                                            compact_after=2,
                                            compact_factor=4, remat=True,
                                            remat_save_trace=save_trace),
                      use_filter_table=False)
    fwd = dict(cuda_build.launch_counts)
    (out["color"] ** 2).sum().backward()
    torch.cuda.synchronize()
    total = dict(cuda_build.launch_counts)
    assert fwd == {"trace_tlas_closest": 6, "trace_tlas_anyhit": 6}, fwd
    assert total == {k: v * (1 if save_trace else 2)
                     for k, v in fwd.items()}, total
    g = params["base_color"].grad
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0


def test_renderer_sample_on_the_card():
    """``create_renderer`` puts the renderer on the card; one flagship
    sample launches 6 + 6 trace_brute kernels and lands in the buffers."""
    _need_cuda()
    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    sc, cam = cornell_scene()
    scene = sc.finalize()
    r = ray_tpu.create_renderer(
        ray_tpu.RenderSettings(width=320, height=180),
        ray_tpu.PassSettings(max_total_depth=5, min_total_depth=2))
    assert r.device.type == "cuda" and r.device == scene.device
    cuda_build.reset_launch_counts()
    img = r.render(scene, cam, 1)
    px = r.pixels(cam, ray_tpu.ViewTransform.AGX)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launch_counts)
    assert counts == {"trace_brute_closest": 6, "trace_brute_anyhit": 6}, \
        counts
    assert img.device.type == px.device.type == "cuda"
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    assert bool(((px >= 0) & (px <= 1)).all())
    with pytest.raises(ValueError, match="renderer"):
        r.render(sc.finalize(device="cpu"), cam, 1)


def _shading_scene(name):
    from ray_tpu_torch.utils import test_scenes

    if name == "alpha_box":
        return test_scenes.alpha_box()
    return test_scenes.GOLDEN_SCENES[name]()


@pytest.mark.parametrize("name,kernel", [
    ("rect_disk", "trace_brute"), ("sphere_spot_line", "trace_brute"),
    ("dir_env", "trace_tlas"), ("tri_glass", "trace_brute"),
    ("alpha_box", "trace_brute")])
def test_shading_scene_launches_bit_exact(name, kernel):
    """Every trace launch of a 256x128 tile, on the kernel the scene's size
    picks (dir_env's 2,210 triangles: the wide route), equals the plain
    version's; the alpha box's tile launches march traces beyond the 6
    closest-hit ones, and no any-hit trace."""
    _need_cuda()
    from ray_tpu_torch.ops import traverse
    from ray_tpu_torch.render import integrator
    from ray_tpu_torch.render.integrator import PassSettings, render_tile

    sc, cam = _shading_scene(name)
    scene = sc.finalize()
    calls = []
    real = getattr(traverse, kernel)

    def recording(*args, any_hit=False, **kw):
        calls.append(([a.clone() if hasattr(a, "clone") else a
                       for a in args], any_hit))
        assert not any(kw.values()), kw  # no visibility masks here
        return real(*args, any_hit=any_hit)

    integrator.march_counts.clear()
    setattr(traverse, kernel, recording)
    try:
        render_tile(scene, cam, None, 832, 476, 1, 0, width=1920,
                    height=1080, tile_w=256, tile_h=128,
                    settings=PassSettings(max_total_depth=5,
                                          min_total_depth=2),
                    use_filter_table=False)
    finally:
        setattr(traverse, kernel, real)
    n_march = (integrator.march_counts["through"]
               + integrator.march_counts["transmittance"])
    n_any = sum(a for _, a in calls)
    assert len(calls) == 12 + n_march - (6 if scene.has_transparency else 0)
    assert n_any == (0 if scene.has_transparency else 6)
    if name == "alpha_box":
        assert n_march > 0
    plain = getattr(traverse, f"{kernel}_plain")
    for args, any_hit in calls:
        k = real(*args, any_hit=any_hit)
        p = plain(*args, any_hit=any_hit)
        for f in k._fields:
            a, b = getattr(k, f), getattr(p, f)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f


def test_golden_at_400_samples_on_the_card():
    """rect_disk through ``create_renderer`` at the golden's 64x64 and 400
    samples, against the committed golden: >= 28 dB PSNR and <= 40
    fireflies (tests/test_cpu_goldens.py's gate)."""
    _need_cuda()
    import pathlib

    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.utils.test_scenes import (
        GOLDEN_DEPTH, GOLDEN_RES, GOLDEN_SCENES, GOLDEN_SPP)

    golden = np.load(pathlib.Path(__file__).parent / "goldens_cpu"
                     / "rect_disk.npz")["image_u8"]
    sc, cam = GOLDEN_SCENES["rect_disk"]()
    r = ray_tpu.create_renderer(
        ray_tpu.RenderSettings(width=GOLDEN_RES, height=GOLDEN_RES),
        ray_tpu.PassSettings(**GOLDEN_DEPTH))
    r.render(sc.finalize(), cam, GOLDEN_SPP)
    out = np.clip(r.pixels(cam).cpu().numpy() * 255.0, 0, 255).astype(
        np.uint8)
    diff = np.abs(out.astype(np.float32) - golden.astype(np.float32))
    psnr = -10.0 * np.log10(max(float((diff ** 2).mean()), 1e-12) / 255.0 ** 2)
    assert psnr >= 28.0, psnr
    assert int((diff > 32).any(axis=-1).sum()) <= 40


# ---- the traversal slice --------------------------------------------------


def _slice_rays(n_rays, seed, half):
    r = np.random.RandomState(seed)
    dev = torch.device("cuda")
    ro = r.uniform(-half, half, (n_rays, 3)).astype(np.float32)
    rd = r.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(ro), t(rd), torch.zeros(n_rays, device=dev),
            t(np.where(r.rand(n_rays) < 0.8, 1e30,
                       r.rand(n_rays) * 2.0).astype(np.float32)),
            t(r.rand(n_rays) < 0.93))


def _slice_scene(name, mode):
    from ray_tpu_torch.utils import test_scenes

    sc, cam = getattr(test_scenes, name)()
    return sc.finalize(**({} if mode is None else dict(instancing=mode))), cam


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("mask", [None, 1, 16])
@pytest.mark.parametrize("name", ["cornell_tlas", "cornell_vis"])
def test_trace_tlas_bin_kernel_bit_exact(name, mask, any_hit):
    """The binary two-level walk on the flagship in tlas mode and on
    ``cornell_vis`` (three instances of a box, one scaled non-uniformly,
    each hidden from one ray type), with no ray mask, RAY_CAMERA and
    RAY_SHADOW."""
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops.traverse import trace_tlas_bin, trace_tlas_bin_plain

    scene, _ = _slice_scene(name, "tlas")
    assert "wrows_tlas" not in scene.bvh_soa
    rays = _slice_rays(300_001, 7, 0.95)
    m = None if mask is None else torch.full(
        (rays[0].shape[0],), mask, dtype=torch.int32, device="cuda")
    args = (scene.bvh_soa["packed"], scene.tri_soa["packed"], scene.inst,
            *rays, m, scene.max_leaf, scene.stack_size)
    key = f"trace_tlas_bin_{'anyhit' if any_hit else 'closest'}"
    before = cuda_build.launch_counts[key]
    k = trace_tlas_bin(*args, any_hit=any_hit)
    p = trace_tlas_bin_plain(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts[key] == before + 1
    assert 0 < int((p.prim >= 0).sum()) < p.prim.shape[0]
    _bit_exact(k, p, name)


def test_trace_tlas_bin_rejects_bad_inputs():
    _need_cuda()
    from ray_tpu_torch.ops.traverse import trace_tlas_bin

    scene, _ = _slice_scene("cornell_vis", "tlas")
    rays = _slice_rays(64, 1, 0.9)
    nodes, tris, inst = (scene.bvh_soa["packed"], scene.tri_soa["packed"],
                         scene.inst)
    ml, ss = scene.max_leaf, scene.stack_size
    with pytest.raises(ValueError):
        trace_tlas_bin(nodes[:, :13].contiguous(), tris, inst, *rays, None,
                       ml, ss)
    with pytest.raises(ValueError):
        trace_tlas_bin(nodes, tris, dict(inst, vis=inst["vis"][:-1]), *rays,
                       None, ml, ss)
    with pytest.raises(TypeError):
        trace_tlas_bin(nodes, tris, dict(inst, inv00=inst["inv00"].double()),
                       *rays, None, ml, ss)
    with pytest.raises(ValueError):
        trace_tlas_bin(nodes, tris, dict(inst, vis=inst["vis"].cpu()),
                       *rays, None, ml, ss)
    with pytest.raises(ValueError):
        trace_tlas_bin(nodes, tris, inst, *rays,
                       torch.ones(63, dtype=torch.int32, device="cuda"), ml,
                       ss)
    for bad_leaf, bad_stack in ((0, ss), (16, ss), (ml, 0), (ml, 65)):
        with pytest.raises(ValueError):
            trace_tlas_bin(nodes, tris, inst, *rays, None, bad_leaf,
                           bad_stack)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("mask", [1, 2, 16])
@pytest.mark.parametrize("name", ["cornell_vis", "sphere_vis"])
def test_masked_kernels_bit_exact(name, mask, any_hit):
    """The masked instantiations: ``trace_bvh`` with per-triangle masks
    (``cornell_vis`` flatten: 60 triangles, no ``wrows``) and the wide
    route with its visibility column (``sphere_vis`` flatten: ``wrows``),
    counted under their own names."""
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build, traverse

    scene, _ = _slice_scene(name, "flatten")
    rays = _slice_rays(300_001, 11, 0.95)
    m = torch.full((rays[0].shape[0],), mask, dtype=torch.int32,
                   device="cuda")
    if name == "cornell_vis":
        args = (scene.bvh_soa["packed"], scene.tri_soa["packed"], *rays,
                scene.max_leaf, scene.stack_size)
        kw = dict(tri_vis=scene.tri_vis, ray_mask=m)
        fn, plain, key = (traverse.trace_bvh, traverse.trace_bvh_plain,
                          "trace_bvh_vis")
    else:
        args = (scene.bvh_soa["wrows"], 0, *rays, m, scene.max_leaf,
                scene.stack_size)
        kw = dict(has_vis=True)
        fn, plain, key = (traverse.trace_tlas, traverse.trace_tlas_plain,
                          "trace_tlas_vis")
    key += "_anyhit" if any_hit else "_closest"
    before = cuda_build.launch_counts[key]
    k = fn(*args, any_hit=any_hit, **kw)
    p = plain(*args, any_hit=any_hit, **kw)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts[key] == before + 1
    assert 0 < int((p.prim >= 0).sum()) < p.prim.shape[0]
    _bit_exact(k, p, name)


SLICE_TILES = {
    ("cornell_tlas", "tlas"): {"trace_tlas_bin"},
    ("cornell_vis", "flatten"): {"trace_bvh"},
    ("cornell_vis", "tlas"): {"trace_tlas_bin"},
    ("sphere_vis", "flatten"): {"trace_tlas"},
    ("sphere_vis", "tlas"): {"trace_tlas"},
    ("env_map", None): {"trace_tlas"},
}


def _tile_launches(scene, cam, settings):
    """Every trace launch of a 256x128 tile as (kernel, args, any_hit, kw),
    and the wrappers themselves."""
    from ray_tpu_torch.ops import traverse
    from ray_tpu_torch.render.integrator import render_tile

    calls = []
    real = {k: getattr(traverse, k)
            for k in ("trace_brute", "trace_bvh", "trace_tlas",
                      "trace_tlas_bin", "trace_binned")}

    def recorder(kernel):
        def recording(*args, any_hit=False, **kw):
            calls.append((kernel, [a.clone() if hasattr(a, "clone") else a
                                   for a in args], any_hit, kw))
            return real[kernel](*args, any_hit=any_hit, **kw)
        return recording

    for k in real:
        setattr(traverse, k, recorder(k))
    try:
        render_tile(scene, cam, None, 832, 476, 1, 0, width=1920,
                    height=1080, tile_w=256, tile_h=128, settings=settings,
                    use_filter_table=False)
    finally:
        for k, fn in real.items():
            setattr(traverse, k, fn)
    return calls, real


@pytest.mark.parametrize("name,mode", sorted(SLICE_TILES, key=str))
def test_slice_scene_tile_launches_bit_exact(name, mode):
    """Every trace launch of a 256x128 tile of the slice's scenes, on the
    kernel its tables pick (with masks where the scene has per-instance
    visibility), equals the plain version's: 6 closest-hit and 6 any-hit."""
    _need_cuda()
    from ray_tpu_torch.ops import traverse
    from ray_tpu_torch.render.integrator import PassSettings

    scene, cam = _slice_scene(name, mode)
    calls, real = _tile_launches(
        scene, cam, PassSettings(max_total_depth=5, min_total_depth=2))
    assert {c[0] for c in calls} == SLICE_TILES[(name, mode)]
    assert len(calls) == 12 and sum(c[2] for c in calls) == 6
    for kernel, args, any_hit, kw in calls:
        if scene.has_visibility:
            mask = (kw.get("ray_mask") if kernel == "trace_bvh"
                    else args[8 if kernel == "trace_tlas_bin" else 7])
            assert mask is not None, kernel
        k = real[kernel](*args, any_hit=any_hit, **kw)
        p = getattr(traverse, f"{kernel}_plain")(*args, any_hit=any_hit,
                                                 **kw)
        _bit_exact(k, p, f"{name} {mode} {kernel}")


# the sky and texture slice: builder, finalize keywords, pass settings and
# the one kernel its traces take
SKY_TILES = {
    "physical_sky": ("physical_sky", {}, {}, "trace_brute"),
    "tex_features": ("tex_features", {}, {}, "trace_tlas"),
    "sphere_hlbvh": ("sphere_hlbvh", dict(fast_build=True), {}, "trace_bvh"),
    "flagship output_sh": ("cornell_scene", {}, dict(output_sh=True),
                           "trace_brute"),
}


@pytest.mark.parametrize("label", sorted(SKY_TILES))
def test_sky_slice_tile_launches_bit_exact(label):
    """Every trace launch of a 256x128 tile of the sky and texture slice's
    scenes — the baked physical sky over its 2-triangle floor, the
    compressed textures and normal maps over 2,210 triangles, the HLBVH
    ``cornell_sphere``, the flagship with the SH-L1 output — equals the
    plain version's, on the kernel its tables pick."""
    _need_cuda()
    from ray_tpu_torch.ops import traverse
    from ray_tpu_torch.render.integrator import PassSettings
    from ray_tpu_torch.utils import test_scenes

    name, fin, st, kernel = SKY_TILES[label]
    sc, cam = getattr(test_scenes, name)()
    scene = sc.finalize(**fin)
    calls, real = _tile_launches(scene, cam, PassSettings(
        max_total_depth=5, min_total_depth=2, **st))
    assert {c[0] for c in calls} == {kernel}
    assert len(calls) == 12 and sum(c[2] for c in calls) == 6
    for k_name, args, any_hit, kw in calls:
        k = real[k_name](*args, any_hit=any_hit, **kw)
        p = getattr(traverse, f"{k_name}_plain")(*args, any_hit=any_hit,
                                                 **kw)
        _bit_exact(k, p, f"{label} {k_name}")


@pytest.mark.parametrize("mode", ["bilinear", "stochastic"])
def test_compressed_decode_on_the_card(mode):
    """``sample_bilinear`` over a pack of raw, BC1, BC4, BC5 and RGBE
    records on the card against the CPU: within 1e-6, the RGBE taps
    exact."""
    _need_cuda()
    from ray_tpu_torch.scene.textures import TexturePacker, sample_bilinear

    r = np.random.default_rng(4)
    p = TexturePacker()
    p.add(r.random((8, 8, 3)).astype(np.float32))
    for k, fmt in enumerate(("bc1", "bc4", "bc5", "rgbe")):
        img = r.random((19 - k, 13 + k, 3)).astype(np.float32)
        p.add(img * (30.0 if fmt == "rgbe" else 1.0), compress=fmt)
    pack = p.pack()
    R = 100_000
    ids = r.integers(-1, 5, R).astype(np.int32)
    uv = r.uniform(-1.0, 2.0, (R, 2)).astype(np.float32)
    lod = r.uniform(0.0, 4.0, R).astype(np.float32)
    rand = r.random((R, 2)).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        tex = {k: t(v) for k, v in pack.items()}
        kw = {"rand": t(rand)} if mode == "stochastic" else {}
        outs.append(sample_bilinear(tex, t(ids), t(uv), t(lod), **kw).cpu())
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=1e-6)
    fmt = pack["tex_fmt"][pack["tex_mip0"][np.maximum(ids, 0)]]
    rgbe = torch.from_numpy((fmt == 4) & (ids >= 0))
    assert torch.equal(outs[0][rgbe], outs[1][rgbe])


# ---------------------------------------------------------------------------
# The cache and denoising slice: radcache_accumulate, the cached renderer,
# NLM and the UNet on the card
# ---------------------------------------------------------------------------

def _accumulate_case(n_entries, R, seed, dev):
    g = np.random.default_rng(seed)
    entry = torch.tensor(g.integers(0, n_entries, R), device=dev)
    valid = torch.tensor(g.random(R) < 0.8, device=dev)
    rad = torch.tensor((g.standard_normal((R, 3)) * 1e3).astype(np.float32),
                       device=dev)
    cnt = torch.tensor(g.integers(0, 4, R).astype(np.int32), device=dev)
    table = torch.tensor(g.standard_normal((n_entries + 1, 3)).astype(
        np.float32), device=dev)
    counts = torch.tensor(g.integers(0, 9, n_entries + 1).astype(np.int32),
                          device=dev)
    return table, counts, entry, rad, cnt, valid


@pytest.mark.parametrize("n_entries,R", [(1 << 6, 20_000), (1 << 20, 777_600),
                                         (1, 50_000)])
def test_radcache_accumulate_kernel_bit_exact(n_entries, R):
    """Colliding lanes (2^6 entries), an update pass's lane count over the
    default table, and one segment of 40,000 lanes: bit-equal to the plain
    version on the same inputs on the CPU, and the same in two runs."""
    _need_cuda()
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render.radcache import (accumulate_plain,
                                               accumulate_segments)

    args = _accumulate_case(n_entries, R, n_entries, torch.device("cuda"))
    cuda_build.reset_launch_counts()
    out = accumulate_segments(*args)
    again = accumulate_segments(*args)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["radcache_accumulate"] == 2
    ref = accumulate_plain(*(a.cpu() for a in args))
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o.cpu().view(torch.int32), r.view(torch.int32))
        assert torch.equal(o.view(torch.int32), a.view(torch.int32))


def test_radcache_accumulate_rejects_bad_inputs():
    _need_cuda()
    from ray_tpu_torch.render.radcache import accumulate_segments

    table, counts, entry, rad, cnt, valid = _accumulate_case(
        64, 100, 0, torch.device("cuda"))
    with pytest.raises(TypeError):
        accumulate_segments(table, counts, entry, rad.double(), cnt, valid)
    # a valid lane outside the table raises, as on the CPU
    wrong = entry.clone()
    wrong[int(torch.nonzero(valid)[0])] = 65
    with pytest.raises(IndexError, match="outside the table"):
        accumulate_segments(table, counts, wrong, rad, cnt, valid)
    # an invalid lane's entry is never read: the CPU's sums, bit for bit
    wild = torch.where(valid, entry, torch.where(
        torch.arange(100, device=entry.device) % 2 == 0, 4_000, -3))
    out = accumulate_segments(table, counts, wild, rad, cnt, valid)
    ref = accumulate_segments(*(a.cpu() for a in (table, counts, wild, rad,
                                                  cnt, valid)))
    for o, r in zip(out, ref):
        assert torch.equal(o.cpu().view(torch.int32), r.view(torch.int32))


def test_cached_renderer_on_the_card():
    """A 64x48 cached renderer: each update pass launches the accumulate
    kernel once; two runs give bit-identical caches; the image is within
    the renderer gate of the CPU path's."""
    _need_cuda()
    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    def run(backend):
        sc, cam = cornell_scene()
        r = ray_tpu.create_renderer(
            ray_tpu.RenderSettings(width=64, height=48,
                                   use_spatial_cache=True,
                                   cache_entries=1 << 16, cache_downsample=2),
            ray_tpu.PassSettings(max_total_depth=5, min_total_depth=2),
            enabled_types=(backend,))
        img = r.render(sc.finalize(device=r.device), cam, 3)
        return r, img

    cuda_build.reset_launch_counts()
    a, img_a = run("gpu")
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["radcache_accumulate"] == 3
    b, img_b = run("gpu")
    for f in ("key_lo", "key_hi", "rad_prev", "cnt_prev", "frames"):
        assert torch.equal(getattr(a.cache, f), getattr(b.cache, f)), f
    assert torch.equal(img_a, img_b)
    _, img_c = run("cpu")
    close = np.isclose(img_a.cpu().numpy(), img_c.numpy(), rtol=1e-3,
                       atol=1e-4).all(-1).mean()
    assert close >= 0.99, close


def test_denoisers_on_the_card():
    """NLM within 1e-5 relative of the CPU on >= 99.9% of values; the UNet
    (TF32 off) within 1e-4 of the output's largest value."""
    _need_cuda()
    from ray_tpu_torch.models import nlm, unet

    g = np.random.default_rng(0)
    H, W = 96, 128
    color = (g.random((H, W, 3)) ** 2 * 3).astype(np.float32)
    var = (g.random((H, W, 3)) * 0.05).astype(np.float32)
    base = g.random((H, W, 3)).astype(np.float32)
    dn = g.random((H, W, 4)).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        t = [torch.tensor(a, device=dev) for a in (color, var, base, dn)]
        den = nlm.nlm_denoise(t[0], t[1], base_color=t[2], depth_normal=t[3])
        net = unet.UNetFilter(device=dev).denoise(t[0], t[2], t[3][..., :3])
        outs.append((den.cpu().numpy(), net.cpu().numpy()))
    (gd, gn), (cd, cn) = outs
    assert np.isclose(gd, cd, rtol=1e-5, atol=1e-7).mean() >= 0.999
    assert np.abs(gn - cn).max() <= 1e-4 * np.abs(cn).max()
