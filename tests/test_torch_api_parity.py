"""The port's public signatures against ray_tpu's, on the CPU.

* For every name that both packages export (their ``__init__``s' ``__all__``),
  every public function of ``ray_tpu.render.sky`` and ``ray_tpu.scene.hlbvh``
  (the modules ported as ``ray_tpu_torch.render.sky`` and
  ``ray_tpu_torch.scene.hlbvh``) and, for a class, every public method that
  ``ray_tpu``'s class defines (``AtmosphereParams.jnp_params`` is the port's
  ``torch_params``),
  the port's parameters begin with ``ray_tpu``'s names in ``ray_tpu``'s
  order (``inspect.signature``), so a positional call means the same in
  both; any parameter the port adds after them is keyword-only (such as
  ``Scene.finalize``'s ``device``).  The port lacks no such name: what it
  does not carry yet exists and raises ``NotImplementedError`` naming its
  ROADMAP item (checked below for each).
* ``Scene.finalize(4)`` builds with ``max_leaf=4``;
  ``finalize(fast_build=True)`` raised for item 15 and ``set_physical_sky()``
  for item 23 until they were ported: now the first builds the HLBVH tree
  and the second bakes the sky and adds the sun;
  ``PassSettings(force_xla=True)`` constructs, its fields in ray_tpu's order.
  ``save_scene`` / ``load_scene`` raised for item 14 until it was ported:
  now a scene round-trips through them, ``device`` keyword-only.
"""

import dataclasses
import enum
import inspect

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.render import sky as j_sky
from ray_tpu.scene import hlbvh as j_hlbvh
from ray_tpu_torch.render import sky as t_sky
from ray_tpu_torch.scene import hlbvh as t_hlbvh
from ray_tpu.render.integrator import PassSettings as JPassSettings
from ray_tpu_torch.render.integrator import PassSettings
from ray_tpu_torch.utils.test_scenes import cornell_scene

torch.set_num_threads(1)


def _public_pairs():
    """(label, ray_tpu object, port object or None) for every exported
    name and every public method of an exported (non-enum) class."""
    pairs = []
    for name in ray_tpu.__all__:
        if name.startswith("__"):
            continue
        ref = getattr(ray_tpu, name)
        port = getattr(ray_tpu_torch, name, None)
        pairs.append((name, ref, port))
        if (inspect.isclass(ref) and not issubclass(ref, enum.Enum)
                and port is not None):
            for m, v in vars(ref).items():
                if (m.startswith("_") and m != "__init__") or not callable(v):
                    continue
                pairs.append((f"{name}.{m}", getattr(ref, m),
                              getattr(port, m, None)))
    for ref_mod, port_mod in ((j_sky, t_sky), (j_hlbvh, t_hlbvh)):
        for name, ref in vars(ref_mod).items():
            if (name.startswith("__") or not callable(ref)
                    or getattr(ref, "__module__", None) != ref_mod.__name__):
                continue
            label = f"{ref_mod.__name__}.{name}"
            port = getattr(port_mod, name, None)
            pairs.append((label, ref, port))
            if inspect.isclass(ref):
                for m, v in vars(ref).items():
                    if m.startswith("_") or not callable(v):
                        continue
                    pm = {"jnp_params": "torch_params"}.get(m, m)
                    pairs.append((f"{label}.{m}", v, getattr(port, pm, None)))
    return pairs


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters.values())
    except (TypeError, ValueError):   # a builtin without a signature
        return None


def test_signatures_begin_with_ray_tpus():
    pairs = _public_pairs()
    assert len(pairs) > 40, len(pairs)
    missing = [label for label, _, port in pairs if port is None]
    assert not missing, f"the port lacks {missing}"
    for label, ref, port in pairs:
        ref_p, port_p = _params(ref), _params(port)
        if ref_p is None:
            continue
        names = [p.name for p in ref_p]
        assert [p.name for p in port_p[:len(names)]] == names, (
            label, names, [p.name for p in port_p])
        extra = [p for p in port_p[len(names):]
                 if p.kind is not inspect.Parameter.KEYWORD_ONLY]
        assert not extra, (label, [p.name for p in extra])


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
