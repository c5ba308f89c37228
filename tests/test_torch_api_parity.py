"""The port's public signatures against ray_tpu's, on the CPU.

* For every name that both packages export (their ``__init__``s' ``__all__``)
  and, for a class, every public method that ``ray_tpu``'s class defines,
  the port's parameters begin with ``ray_tpu``'s names in ``ray_tpu``'s
  order (``inspect.signature``), so a positional call means the same in
  both; any parameter the port adds after them is keyword-only (such as
  ``Scene.finalize``'s ``device``).  The port lacks no such name: what it
  does not carry yet exists and raises ``NotImplementedError`` naming its
  ROADMAP item (checked below for each).
* ``Scene.finalize(4)`` builds with ``max_leaf=4``;
  ``finalize(fast_build=True)`` raises for item 15; ``set_physical_sky()``
  for item 23;
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
    sc, _ = cornell_scene()
    with pytest.raises(NotImplementedError, match="item 15"):
        sc.finalize(fast_build=True, device="cpu")


def test_set_physical_sky_raises_naming_item_23():
    sc, _ = cornell_scene()
    with pytest.raises(NotImplementedError, match="item 23"):
        sc.set_physical_sky()


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
