"""ray_tpu_torch stands alone: no JAX, no ray_tpu, CUDA by default.

(a) A fresh interpreter imports ray_tpu_torch, renders a tiny CPU tile,
    one of a scene with visibility masks in tlas mode (the binary
    two-level walk), one under an environment map, one under the baked
    physical sky (``render/sky.py``), one of compressed textures and
    normal maps, one of an HLBVH scene (``scene/hlbvh.py``) with the
    SH-L1 output, and a CPU renderer's frame through the user's entry
    point (``create_renderer`` → ``render`` → ``pixels``); afterwards
    neither ``jax`` nor any ``ray_tpu`` module is loaded.
(b) No file under ``ray_tpu_torch/`` imports ``jax`` or ``ray_tpu``.
(c) On a machine without CUDA, ``finalize()`` with no device raises
    ``RuntimeError`` instead of falling back to the CPU; so do
    ``create_renderer()``, ``Renderer()`` and ``set_physical_sky()`` with
    no device.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ray_tpu_torch"

_CHILD = r"""
import sys
import ray_tpu_torch
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.utils.test_scenes import cornell_scene
sc, cam = cornell_scene()
out = render_tile(sc.finalize(device="cpu"), cam, None, 0, 0, 1, 0,
                  width=16, height=12, tile_w=16, tile_h=12,
                  settings=PassSettings(max_total_depth=2),
                  use_filter_table=False)
assert out["color"].shape == (192, 3)
from ray_tpu_torch.utils.test_scenes import (
    cornell_vis, env_map, physical_sky, sphere_hlbvh, tex_features)
for build, kw, st in (
        (cornell_vis, dict(instancing="tlas"), {}), (env_map, {}, {}),
        (lambda: physical_sky(env_res=(16, 8), device="cpu"), {}, {}),
        (tex_features, {}, {}),
        (sphere_hlbvh, dict(fast_build=True), dict(output_sh=True))):
    sc2, cam2 = build()
    out = render_tile(sc2.finalize(device="cpu", **kw), cam2, None, 0, 0, 1,
                      0, width=8, height=6, tile_w=8, tile_h=6,
                      settings=PassSettings(max_total_depth=2, **st),
                      use_filter_table=False)
    assert out["color"].shape == (48, 3)
import ray_tpu_torch as ray_tpu
r = ray_tpu.create_renderer(ray_tpu.RenderSettings(width=8, height=6),
                            ray_tpu.PassSettings(max_total_depth=2),
                            enabled_types=("cpu",))
r.render(sc.finalize(device="cpu"), cam, 2)
assert r.pixels(cam, ray_tpu.ViewTransform.AGX).shape == (6, 8, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_import_and_render_load_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ray_tpu"), (path, name)


def test_chip_smoke_imports_no_jax():
    for name in _imports(ROOT / "chip_smoke.py"):
        assert name.split(".")[0] not in ("jax", "jaxlib", "ray_tpu"), name


def test_finalize_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: finalize() would use it")
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    sc, _ = cornell_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        sc.finalize()


def test_set_physical_sky_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bake would use it")
    from ray_tpu_torch.scene.scene import Scene

    with pytest.raises(RuntimeError, match="CUDA"):
        Scene().set_physical_sky(env_res=(8, 4))


def test_create_renderer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the renderer would use it")
    from ray_tpu_torch.api import create_renderer
    from ray_tpu_torch.render.renderer import Renderer, RenderSettings

    with pytest.raises(RuntimeError):
        create_renderer()
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(RenderSettings(width=4, height=4))


def test_gather_wrapper_never_falls_back():
    """The gather probe's wrapper: a non-CPU, non-CUDA device or inputs
    split across devices raise rather than running the plain version."""
    from ray_tpu_torch.ops.gather_probe import gather_table

    m = torch.device("meta")
    with pytest.raises(ValueError):
        gather_table(torch.empty(1024, device=m),
                     torch.empty((8, 128), dtype=torch.int32, device=m))
    with pytest.raises(ValueError):
        gather_table(torch.zeros(1024),
                     torch.empty((8, 128), dtype=torch.int32, device=m))


def test_kernel_wrapper_never_falls_back():
    """On a non-CPU, non-CUDA device the wrapper raises rather than running
    the plain version."""
    from ray_tpu_torch.ops.traverse import trace_brute

    m = torch.device("meta")
    tris = torch.empty((4, 9), device=m)
    ro = torch.empty((8, 3), device=m)
    with pytest.raises(ValueError):
        trace_brute(tris, ro, ro, torch.empty(8, device=m),
                    torch.empty(8, device=m),
                    torch.empty(8, dtype=torch.bool, device=m))
    # inputs split across devices are refused, never moved
    with pytest.raises(ValueError):
        trace_brute(torch.zeros(4, 9), torch.zeros(8, 3), ro, torch.zeros(8),
                    torch.zeros(8), torch.ones(8, dtype=torch.bool))


def test_bvh_wrapper_never_falls_back():
    """The BVH wrapper, likewise: a non-CPU, non-CUDA device or inputs
    split across devices raise rather than running ``trace_bvh_plain``."""
    from ray_tpu_torch.ops.traverse import trace_bvh

    m = torch.device("meta")
    nodes = torch.empty((3, 14), device=m)
    tris = torch.empty((50, 9), device=m)
    ro = torch.empty((8, 3), device=m)
    rays = (ro, ro, torch.empty(8, device=m), torch.empty(8, device=m),
            torch.empty(8, dtype=torch.bool, device=m))
    with pytest.raises(ValueError):
        trace_bvh(nodes, tris, *rays, 4, 8)
    with pytest.raises(ValueError):
        trace_bvh(torch.zeros(3, 14), torch.zeros(50, 9), *rays, 4, 8)


def test_tlas_wrapper_never_falls_back():
    """The two-level wrapper, likewise: a non-CPU, non-CUDA device, or rows,
    rays or the ray mask split across devices, raise rather than running
    ``trace_tlas_plain``."""
    from ray_tpu_torch.ops.traverse import trace_tlas

    m = torch.device("meta")
    rows = torch.empty((40, 56), device=m)
    ro = torch.empty((8, 3), device=m)
    rays = (ro, ro, torch.empty(8, device=m), torch.empty(8, device=m),
            torch.empty(8, dtype=torch.bool, device=m))
    with pytest.raises(ValueError):
        trace_tlas(rows, 3, *rays, None, 4, 16)
    cpu_rays = (torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(8),
                torch.zeros(8), torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        trace_tlas(rows, 3, *cpu_rays, None, 4, 16)
    with pytest.raises(ValueError):
        trace_tlas(torch.zeros(40, 56), 3, *cpu_rays,
                   torch.empty(8, dtype=torch.int32, device=m), 4, 16)


def test_binned_wrapper_never_falls_back():
    """The binned wrapper, likewise: a non-CPU, non-CUDA device, or slabs
    and rays split across devices, raise rather than running
    ``trace_binned_plain``."""
    from ray_tpu_torch.ops.traverse import binned_sort_key, trace_binned

    m = torch.device("meta")
    binned = {"slab_f": torch.empty((2 * 88, 128), device=m),
              "slab_i": torch.empty((2 * 16, 128), dtype=torch.int32,
                                    device=m),
              "sub_lo": torch.empty((2, 3), device=m),
              "sub_hi": torch.empty((2, 3), device=m),
              "stack_arr": torch.empty(8, dtype=torch.int8, device=m)}
    ro = torch.empty((8, 3), device=m)
    rays = (ro, ro, torch.empty(8, device=m), torch.empty(8, device=m),
            torch.empty(8, dtype=torch.bool, device=m))
    with pytest.raises(ValueError):
        trace_binned(binned, *rays, 4)
    with pytest.raises(ValueError):
        binned_sort_key(binned, *rays)
    cpu_rays = (torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(8),
                torch.zeros(8), torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        trace_binned(binned, *cpu_rays, 4, sort_rays=False)
    with pytest.raises(ValueError):
        trace_binned(binned, *cpu_rays, 4)


def test_tlas_bin_wrapper_never_falls_back():
    """The binary two-level wrapper, likewise: a non-CPU, non-CUDA device,
    or tables, instance columns or rays split across devices, raise rather
    than running ``trace_tlas_bin_plain``."""
    from ray_tpu_torch.ops.traverse import INST_XFORM_COLS, trace_tlas_bin

    def inst(device):
        cols = {k: torch.zeros(3, device=device) for k in INST_XFORM_COLS}
        cols["vis"] = torch.zeros(3, dtype=torch.int32, device=device)
        cols["blas_root"] = torch.zeros(3, dtype=torch.int32, device=device)
        return cols

    m = torch.device("meta")
    ro = torch.empty((8, 3), device=m)
    rays = (ro, ro, torch.empty(8, device=m), torch.empty(8, device=m),
            torch.empty(8, dtype=torch.bool, device=m))
    with pytest.raises(ValueError):
        trace_tlas_bin(torch.empty((5, 14), device=m),
                       torch.empty((6, 9), device=m), inst(m), *rays, None,
                       4, 16)
    cpu_rays = (torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(8),
                torch.zeros(8), torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        trace_tlas_bin(torch.zeros(5, 14), torch.zeros(6, 9), inst(m),
                       *cpu_rays, None, 4, 16)
    with pytest.raises(ValueError):
        trace_tlas_bin(torch.zeros(5, 14), torch.zeros(6, 9), inst("cpu"),
                       *cpu_rays, torch.empty(8, dtype=torch.int32, device=m),
                       4, 16)


def test_masked_bvh_wrapper_never_falls_back():
    """The masked BVH2 walk: masks on another device than the rays raise
    rather than being moved."""
    from ray_tpu_torch.ops.traverse import trace_bvh

    m = torch.device("meta")
    rays = (torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(8),
            torch.zeros(8), torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        trace_bvh(torch.zeros(3, 14), torch.zeros(50, 9), *rays, 4, 8,
                  tri_vis=torch.empty(50, dtype=torch.int32, device=m))
    with pytest.raises(ValueError):
        trace_bvh(torch.zeros(3, 14), torch.zeros(50, 9), *rays, 4, 8,
                  tri_vis=torch.zeros(50, dtype=torch.int32),
                  ray_mask=torch.empty(8, dtype=torch.int32, device=m))
