"""The frozen scene generators give the same scenes as the port's
``test_scenes`` at their defaults (as of the port's first benchmark)."""

import numpy as np
import pytest

from rtbench import harness


def _describe(sc, cam):
    d = {"meshes": [(m.vertices, m.indices, m.normals, m.uvs, m.tri_mat)
                    for m in sc._meshes],
         "instances": [(m, None if x is None else np.asarray(x), v)
                       for m, x, v in sc._instances],
         "materials": [repr(m) for m in sc._materials],
         "lights": [repr(l) for l in sc._lights],
         "texels": list(sc._textures.texels),
         "texture_records": list(sc._textures.records),
         "env": (sc.env_col, sc.env_map, sc.env_rotation),
         "camera": repr(cam)}
    return d


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("name,port_fn,args", [
    ("flagship", "cornell_scene", ("emissive_quad",)),
    ("colonnade", "colonnade_scene", ()),
])
def test_frozen_generator_matches_the_port(name, port_fn, args):
    from ray_tpu_torch.utils import test_scenes

    gen = harness.load_module(harness.HERE / "configs" / f"{name}.py", name)
    got = _describe(*gen.scene(harness.scene_api("ray_tpu_torch")))
    want = _describe(*getattr(test_scenes, port_fn)(*args))
    _equal(got, want)
    # the reference's own API builds the same inputs
    ref = _describe(*gen.scene(harness.scene_api("rtbench.ref")))
    _equal(ref["meshes"], want["meshes"])
    _equal(ref["instances"], want["instances"])
    _equal(ref["materials"], want["materials"])
    _equal(ref["texels"], want["texels"])
    _equal(ref["env"], want["env"])


def _refused(what):
    from rtbench.ref.scene.lights import LightDesc, LightType
    from rtbench.ref.scene.materials import MaterialDesc, ShadingNode
    from rtbench.ref.scene.scene import Scene

    sc = Scene()
    if what == "glossy":
        sc.add_material(MaterialDesc(type=ShadingNode.GLOSSY))
    elif what == "alpha":
        sc.add_material(MaterialDesc(type=ShadingNode.PRINCIPLED, alpha=0.5))
    elif what == "rect_light":
        sc.add_light(LightDesc(type=LightType.RECT))
    elif what == "visibility":
        sc.add_instance(0, visibility=1)
    elif what == "env_map":
        sc.set_environment((1, 1, 1), map_id=0)
    elif what == "compressed":
        sc.add_texture(np.ones((4, 4, 3), np.float32), compress="bc1")


@pytest.mark.parametrize("what", ["glossy", "alpha", "rect_light",
                                  "visibility", "env_map", "compressed"])
def test_reference_refuses_what_it_does_not_follow(what):
    with pytest.raises(ValueError, match="reference"):
        _refused(what)
