"""The port's public signatures against ray_tpu's, on the CPU.

* For every name that both packages export (their ``__init__``s'
  ``__all__``) and every public function or class defined in a module
  that both packages have (``ray_tpu.<path>`` and ``ray_tpu_torch.<path>``,
  found by walking both packages), and, for a class, every public method
  that ``ray_tpu``'s class defines (``AtmosphereParams.jnp_params`` is the
  port's ``torch_params``), the port's parameters begin with
  ``ray_tpu``'s names, in ``ray_tpu``'s order, of the same kinds and with
  equal defaults (``inspect.signature``), so a call means the same in
  both; any parameter the port adds after them is keyword-only (such as
  ``Scene.finalize``'s ``device``).  The port lacks no such name.
  ``EXEMPT`` lists, each with its reason, the differences
  that stay.
* ``Scene.finalize(4)`` builds with ``max_leaf=4``;
  ``finalize(fast_build=True)`` raised for item 15, ``set_physical_sky()``
  for item 23 and ``finalize(spatial_splits=True)`` for item 18 until they
  were ported; ``PassSettings(force_xla=True)`` constructs, its fields in
  ray_tpu's order.  ``save_scene`` / ``load_scene`` raised for item 14
  until it was ported: now a scene round-trips through them, ``device``
  keyword-only.
* The repaired wrappers take ray_tpu's keywords: the tlas traces
  ``nodes=`` and ``force_xla=``, the flatten ones ``force_xla=``,
  ``render_tile`` ``cache=None``, ``scrambled_2d_rand`` ``table=False``.
"""

import dataclasses
import enum
import importlib
import inspect
import pkgutil

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.render.integrator import PassSettings as JPassSettings
from ray_tpu_torch.render.integrator import PassSettings
from ray_tpu_torch.utils.test_scenes import cornell_scene

torch.set_num_threads(1)


# (label, what differs) -> why the difference stays
EXEMPT = {
    # ray_tpu's one-hot-matmul knobs: TPU gathers written as one-hot
    # products (onehot_max rows, the column list, the one-hot operand);
    # the port's table reads are index_select, so there is nothing to set
    ("ray_tpu.render.surface.fetch_tri_pieces", "onehot_max"):
        "one-hot matmul row limit; the port gathers with index_select",
    ("ray_tpu.render.surface.fetch_inst_cols", "names"):
        "one-hot matmul column list; the port reads every instance column",
    # ray_tpu.scene.light_tree._lnode_importance(oh) is private, so the
    # walk does not reach it: its one-hot operand is an index_select here
    ("create_renderer", "enabled_types"):
        "default ('gpu',), not ('tpu', 'gpu', 'cpu'): the port has no TPU "
        "backend and never falls back to the CPU unless asked",
    ("ray_tpu.models.unet.ConvBlock", "missing"):
        "a flax Conv + ReLU pair; PyTorch's Conv2d needs its input width, "
        "which flax infers, so UNetDenoiser holds the Conv2d layers itself",
}
# flax modules are dataclasses that end in flax's own parent / name fields
_FLAX_FIELDS = ("parent", "name")


def _shared_modules():
    """(ray_tpu module, port module) for every module path both have."""
    def walk(pkg):
        return {m.name[len(pkg.__name__):]: m.name for m in
                pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    ref, port = walk(ray_tpu), walk(ray_tpu_torch)
    return [(importlib.import_module(ref[k]), importlib.import_module(port[k]))
            for k in sorted(set(ref) & set(port))]


def _class_methods(label, ref, port, pairs):
    for m, v in vars(ref).items():
        if (m.startswith("_") and m != "__init__") or not callable(v):
            continue
        pm = {"jnp_params": "torch_params"}.get(m, m)
        pairs.append((f"{label}.{m}", getattr(ref, m), getattr(port, pm, None)))


def _public_pairs():
    """(label, ray_tpu object, port object or None) for every exported
    name, every public function or class of every shared module, and every
    public method of such a (non-enum) class."""
    pairs, seen = [], set()
    for name in ray_tpu.__all__:
        if name.startswith("__"):
            continue
        ref = getattr(ray_tpu, name)
        port = getattr(ray_tpu_torch, name, None)
        pairs.append((name, ref, port))
        seen.add(id(ref))
        if (inspect.isclass(ref) and not issubclass(ref, enum.Enum)
                and port is not None):
            _class_methods(name, ref, port, pairs)
    for ref_mod, port_mod in _shared_modules():
        for name, ref in vars(ref_mod).items():
            if (name.startswith("_") or not callable(ref)
                    or getattr(ref, "__module__", None) != ref_mod.__name__
                    or id(ref) in seen):
                continue
            label = f"{ref_mod.__name__}.{name}"
            port = getattr(port_mod, name, None)
            if (label, "missing") in EXEMPT:
                continue
            pairs.append((label, ref, port))
            if (inspect.isclass(ref) and not issubclass(ref, enum.Enum)
                    and port is not None):
                _class_methods(label, ref, port, pairs)
    return pairs


def _same_default(a, b) -> bool:
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return (type(a).__name__ == type(b).__name__
                and dataclasses.asdict(a) == dataclasses.asdict(b))
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        return int(a) == int(b)
    return type(a) is type(b) and a == b


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters.values())
    except (TypeError, ValueError):   # a builtin without a signature
        return None


def test_signatures_begin_with_ray_tpus():
    pairs = _public_pairs()
    assert len(pairs) > 250, len(pairs)
    missing = [label for label, _, port in pairs if port is None]
    assert not missing, f"the port lacks {missing}"
    for label, ref, port in pairs:
        ref_p, port_p = _params(ref), _params(port)
        if ref_p is None:
            continue
        if tuple(p.name for p in ref_p[-2:]) == _FLAX_FIELDS:
            ref_p = ref_p[:-2]   # a flax module class or its __init__
        ref_p = [p for p in ref_p if (label, p.name) not in EXEMPT]
        port_p = [p for p in port_p if (label, p.name) not in EXEMPT]
        names = [p.name for p in ref_p]
        assert [p.name for p in port_p[:len(names)]] == names, (
            label, names, [p.name for p in port_p])
        for r, t in zip(ref_p, port_p):
            assert r.kind == t.kind, (label, r.name, r.kind, t.kind)
            if (label, f"{r.name} default") not in EXEMPT:
                assert _same_default(r.default, t.default) or (
                    label, r.name) in EXEMPT, (label, r.name, r.default,
                                                t.default)
        extra = [p for p in port_p[len(names):]
                 if p.kind is not inspect.Parameter.KEYWORD_ONLY]
        assert not extra, (label, [p.name for p in extra])


def test_exemptions_are_still_differences():
    """Each exemption names a parameter or name that still differs."""
    pairs = {label: (ref, port) for label, ref, port in _public_pairs()}
    for (label, what), why in EXEMPT.items():
        assert why
        if what == "missing":
            mod, name = label.rsplit(".", 1)
            port_mod = importlib.import_module(
                "ray_tpu_torch" + mod[len("ray_tpu"):])
            assert not hasattr(port_mod, name), label
            continue
        ref, port = pairs[label]
        ref_p = {p.name: p for p in _params(ref)}
        port_p = {p.name: p for p in _params(port)}
        assert what in ref_p, (label, what)
        assert (what not in port_p or not _same_default(
            ref_p[what].default, port_p[what].default)), (label, what)


def test_repaired_wrappers_take_ray_tpus_keywords():
    """The tlas traces take ``nodes=`` and ``force_xla=``, the flatten
    traces ``force_xla=``, ``render_tile`` ``cache=None`` and
    ``scrambled_2d_rand`` ``table=False``; ``rays=`` (item 25) and
    ``table=True`` (item 2) raised naming their ROADMAP items until they
    were ported: now ``rays=`` renders a lightmap's texels with
    ``cam=None`` (tests/test_torch_lightmap.py holds it to ray_tpu's) and
    ``table=True`` draws from the PMJ02 table (tests/test_torch_rng.py).
    """
    from ray_tpu_torch.ops import rng, traverse
    from ray_tpu_torch.render.integrator import render_tile
    from ray_tpu_torch.render.lightmap import rasterize_uv_rays
    from ray_tpu_torch.utils.test_scenes import cornell_tlas

    sc, cam = cornell_tlas()
    scene = sc.finalize(device="cpu", instancing="tlas")
    R = 64
    g = torch.Generator().manual_seed(0)
    ro = torch.tensor([0.0, 1.0, 3.0]).expand(R, 3).contiguous()
    rd = torch.nn.functional.normalize(
        torch.rand((R, 3), generator=g) - torch.tensor([0.5, 0.5, 1.0]),
        dim=-1)
    t_min, t_max = torch.zeros(R), torch.full((R,), 1e30)
    active = torch.ones(R, dtype=torch.bool)
    kw = dict(max_leaf=scene.max_leaf, stack_size=scene.stack_size)
    a = traverse.trace_closest_tlas(
        nodes=scene.bvh_soa, tris=scene.tri_soa, inst=scene.inst, ro=ro,
        rd=rd, t_min=t_min, t_max=t_max, active=active, force_xla=False, **kw)
    b = traverse.trace_closest_tlas(scene.bvh_soa, scene.tri_soa, scene.inst,
                                    ro, rd, t_min, t_max, active, **kw)
    assert torch.equal(a.prim, b.prim) and bool((a.prim >= 0).any())
    occ = traverse.trace_occlusion_tlas(
        nodes=scene.bvh_soa, tris=scene.tri_soa, inst=scene.inst, ro=ro,
        rd=rd, t_min=t_min, t_max=t_max, active=active, force_xla=False, **kw)
    assert torch.equal(occ, a.prim >= 0)
    flat = cornell_scene()[0].finalize(device="cpu")
    c = traverse.trace_closest_soa(flat.bvh_soa, flat.tri_soa, ro, rd, t_min,
                                   t_max, active, force_xla=False)
    assert torch.equal(traverse.trace_occlusion_soa(
        flat.bvh_soa, flat.tri_soa, ro, rd, t_min, t_max, active,
        force_xla=False), c.prim >= 0)
    kw = dict(width=8, height=6, tile_w=8, tile_h=6,
              settings=PassSettings(max_total_depth=2),
              use_filter_table=False)
    out = render_tile(flat, cornell_scene()[1], None, 0, 0, 1, 0, cache=None,
                      **kw)
    assert tuple(out["color"].shape) == (48, 3) and "cache" not in out
    rays, mask, _ = rasterize_uv_rays(flat.vertices, flat.normals, flat.uvs,
                                      flat.tri_vidx, 8, 6, 0, 2, device="cpu")
    texels = render_tile(flat, None, None, 0, 0, 1, 0, pixel_mask=mask,
                         rays=rays, **kw)
    assert tuple(texels["color"].shape) == (48, 3)
    # each texel's ray hits its floor 1e-3 away (but a few on the quad's
    # edges, which tests/test_torch_lightmap.py discusses)
    depth = texels["depth_normal"][mask, 3]
    assert float(((depth - 1e-3).abs() < 1e-6).float().mean()) > 0.8
    dim, seed, sample = (torch.tensor(v) for v in (3, 7, 1))
    x, y = rng.scrambled_2d_rand(dim, seed, sample, table=False)
    assert 0.0 <= float(x) < 1.0 and 0.0 <= float(y) < 1.0
    tx, ty = rng.scrambled_2d_rand(dim, seed, sample, table=True)
    assert 0.0 <= float(tx) < 1.0 and 0.0 <= float(ty) < 1.0
    assert (float(tx), float(ty)) != (float(x), float(y))
    with pytest.raises(TypeError):
        rng.scrambled_2d_rand(dim=dim, seed=seed, sample=sample)


def test_finalize_takes_max_leaf_first():
    sc, _ = cornell_scene()
    scene = sc.finalize(4, device="cpu")
    assert scene.max_leaf == 4 and scene.device.type == "cpu"
    assert sc.finalize(device="cpu").max_leaf == 8


def test_fast_build_raises_naming_item_15():
    """Item 15 is ported: ``fast_build=True`` builds the HLBVH tree
    (tests/test_torch_hlbvh.py holds it to ray_tpu's)."""
    sc, _ = cornell_scene()
    fast = sc.finalize(fast_build=True, device="cpu")
    sah = sc.finalize(device="cpu")
    assert fast.num_tris == sah.num_tris == 24
    assert not torch.equal(fast.bvh_soa["packed"], sah.bvh_soa["packed"])


def test_set_physical_sky_raises_naming_item_23():
    """Item 23 is ported: the sky bakes into an environment map and the sun
    becomes a directional light (tests/test_torch_sky_scene.py holds both
    to ray_tpu's); ``device`` rides in ``sky_features``."""
    sc, _ = cornell_scene()
    params = sc.set_physical_sky(env_res=(16, 8), device="cpu")
    assert type(params).__name__ == "AtmosphereParams"
    scene = sc.finalize(device="cpu")
    assert scene.env_map >= 0 and (scene.env_tab_w, scene.env_tab_h) == (16, 8)
    kinds = [k[0] for k in scene.light_kinds]
    assert kinds[0] == 1 and kinds[-1] == 6  # the sun (DIR) and the map (ENV)


def _save_then_load(path, **load_kw):
    sc, _ = cornell_scene()
    scene = sc.finalize(device="cpu")
    ray_tpu_torch.save_scene(path, scene)
    return scene, ray_tpu_torch.load_scene(path, **load_kw)


@pytest.mark.parametrize("call", [
    lambda path: _save_then_load(path, device="cpu"),
    lambda path: _save_then_load(path, device=torch.device("cpu")),
])
def test_scene_io_raises_naming_item_14(call, tmp_path):
    """Item 14 is ported: the scene comes back equal, on the device named
    by the keyword-only ``device``."""
    scene, back = call(str(tmp_path / "scene.npz"))
    assert back.device.type == "cpu"
    assert back.light_kinds == scene.light_kinds
    for k, v in scene.materials.items():
        assert torch.equal(back.materials[k], v), k
    params = inspect.signature(ray_tpu_torch.load_scene).parameters
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY


def test_pass_settings_force_xla():
    s = PassSettings(force_xla=True)
    assert s.force_xla and not PassSettings().force_xla
    assert ([f.name for f in dataclasses.fields(PassSettings)]
            == [f.name for f in dataclasses.fields(JPassSettings)])
    # positional construction agrees with ray_tpu's field order
    values = [f.default for f in dataclasses.fields(JPassSettings)]
    values[[f.name for f in dataclasses.fields(JPassSettings)].index(
        "force_xla")] = True
    assert PassSettings(*values) == dataclasses.replace(PassSettings(),
                                                        force_xla=True)
