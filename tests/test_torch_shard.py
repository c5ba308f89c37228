"""ray_tpu_torch.parallel on 4 gloo ranks, against the port's render_tile
and ray_tpu's.

One module fixture starts 4 CPU processes that join a gloo group through a
``file://`` store under ``tmp_path`` (a fixed TCP port would collide
between test workers), run every case of ``_rank_main`` on the 32x32
flagship of ``tests/test_parallel.py`` at depth 3, and save what they
found; the tests read it.  The ranks import no JAX: ``ray_tpu`` is
compared in this process, from rank 0's frames.

* ``render_sharded`` bit-equal to the port's ``render_tile`` on every
  rank, ``render_sharded_balanced`` bit-equal to ``render_sharded``
  (``color``, ``base_color``, ``depth_normal``, ``rays_traced``);
* remat gradients of ``mean(color**2)`` w.r.t. ``base_color`` through
  ``render_sharded`` equal to the single-device ones within rtol 2e-4 /
  atol 1e-6 on every rank (``tests/test_parallel.py``'s bound: the
  all-reduce sums four partial gradients), and non-zero;
* one ``train_step`` and ``dryrun_multichip(4)`` give every rank the same
  finite loss, the same non-zero ``base_color`` gradient and the same new
  parameters;
* a height that does not divide over the ranks raises AssertionError, as
  in ``ray_tpu``;
* the sharded frame against ``ray_tpu``'s ``render_tile`` within
  ``tests/test_torch_render.py``'s tile bounds.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.render.integrator import PassSettings

torch.set_num_threads(1)

RANKS = 4
WIDTH = HEIGHT = 32
KEYS = ("color", "base_color", "depth_normal")
SETTINGS = dict(max_total_depth=3, min_total_depth=3)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _rank_main(rank, store, out_dir):
    """One rank: every case, its findings saved to ``out_dir/<rank>.pt``."""
    import contextlib
    import io

    import torch.distributed as dist

    from ray_tpu_torch.parallel.shard import (
        make_tile_mesh, render_sharded, render_sharded_balanced)
    from ray_tpu_torch.parallel.train import (
        dryrun_multichip, params_of, train_step)
    from ray_tpu_torch.render.integrator import render_tile
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=RANKS)
    try:
        mesh = make_tile_mesh(device="cpu")
        sc, cam = cornell_scene("emissive_quad")
        scene = sc.finalize(device="cpu")
        settings = PassSettings(**SETTINGS)
        kw = dict(mesh=mesh, width=WIDTH, height=HEIGHT, settings=settings)
        found = {}
        with torch.no_grad():
            single = render_tile(scene, cam, None, 0, 0, 1, 0, width=WIDTH,
                                 height=HEIGHT, tile_w=WIDTH, tile_h=HEIGHT,
                                 settings=settings, use_filter_table=False)
            sharded = render_sharded(scene, cam, None, 1, 0, **kw)
            balanced = render_sharded_balanced(scene, cam, None, 1, 0, **kw)
        sharded = {k: v.full_tensor() if k in KEYS else v
                   for k, v in sharded.items()}
        balanced = {k: v.full_tensor() if k in KEYS else v
                    for k, v in balanced.items()}
        for k in (*KEYS, "rays_traced"):
            found[f"sharded {k}"] = torch.equal(_bits(sharded[k]),
                                                _bits(single[k]))
            found[f"balanced {k}"] = torch.equal(_bits(balanced[k]),
                                                 _bits(sharded[k]))
        found["frame"] = {k: v.numpy() for k, v in sharded.items()}

        remat = dataclasses.replace(settings, remat=True)
        bc = scene.materials["base_color"]

        def grad_of(render):
            leaf = bc.detach().clone().requires_grad_(True)
            sc_ = dataclasses.replace(
                scene, materials={**scene.materials, "base_color": leaf})
            loss = (render(sc_)["color"] ** 2).mean()
            return torch.autograd.grad(loss, leaf)[0]

        found["grad sharded"] = grad_of(lambda s: render_sharded(
            s, cam, None, 1, 0, mesh=mesh, width=WIDTH, height=HEIGHT,
            settings=remat)).numpy()
        found["grad single"] = grad_of(lambda s: render_tile(
            s, cam, None, 0, 0, 1, 0, width=WIDTH, height=HEIGHT,
            tile_w=WIDTH, tile_h=HEIGHT, settings=remat,
            use_filter_table=False)).numpy()

        target = torch.zeros((HEIGHT * WIDTH, 3))
        loss, grads, new = train_step(scene, cam, params_of(scene), target,
                                      mesh=mesh, width=WIDTH, height=HEIGHT,
                                      settings=remat)
        found["train grad base_color"] = \
            grads["materials"]["base_color"].numpy()
        found["train loss"] = float(loss)
        found["train params"] = {
            "env_col": new["env_col"].numpy(),
            **{k: v.numpy() for k, v in new["materials"].items()}}
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            dryrun_multichip(RANKS, device="cpu")
        found["dryrun"] = printed.getvalue()
        try:
            render_sharded(scene, cam, None, 1, 0, mesh=mesh, width=WIDTH,
                           height=30, settings=settings)
            found["indivisible"] = None
        except AssertionError as e:
            found["indivisible"] = str(e)
        torch.save(found, pathlib.Path(out_dir) / f"{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the 4 ranks found."""
    tmp = tmp_path_factory.mktemp("shard")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from test_torch_shard import _rank_main; "
            "_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])")
    here = str(pathlib.Path(__file__).resolve().parent)
    procs = [subprocess.Popen([sys.executable, "-c", code, here, str(r),
                               str(tmp / "store"), str(tmp)])
             for r in range(RANKS)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * RANKS
    return [torch.load(tmp / f"{r}.pt", weights_only=False)
            for r in range(RANKS)]


@pytest.mark.parametrize("route", ["sharded", "balanced"])
@pytest.mark.parametrize("key", [*KEYS, "rays_traced"])
def test_sharded_frames_bit_equal(ranks, route, key):
    """``render_sharded`` against ``render_tile``, the balanced route
    against ``render_sharded``: the same bits on every rank."""
    assert all(r[f"{route} {key}"] for r in ranks), [
        r[f"{route} {key}"] for r in ranks]


def test_sharded_gradients_allreduce(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["grad sharded"], r["grad single"],
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_array_equal(r["grad sharded"],
                                      ranks[0]["grad sharded"])
    assert np.abs(ranks[0]["grad sharded"]).max() > 0.0


def test_train_step_same_on_every_rank(ranks):
    loss = ranks[0]["train loss"]
    assert np.isfinite(loss) and loss > 0.0
    g = ranks[0]["train grad base_color"]
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0
    for r in ranks:
        assert r["train loss"] == loss
        np.testing.assert_array_equal(r["train grad base_color"], g)
        for k, v in ranks[0]["train params"].items():
            np.testing.assert_array_equal(r["train params"][k], v, err_msg=k)
    assert ranks[0]["dryrun"].startswith("dryrun_multichip(4): ok, loss=")
    assert all(r["dryrun"] == "" for r in ranks[1:])


def test_indivisible_height_raises(ranks):
    for r in ranks:
        assert r["indivisible"] == "height 30 must divide over 4 devices"


def test_make_tile_mesh_needs_a_process_group():
    from ray_tpu_torch.parallel.shard import make_tile_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_tile_mesh(device="cpu")


def test_sharded_frame_matches_ray_tpu(ranks):
    """Rank 0's sharded frame against ``ray_tpu``'s ``render_tile`` of the
    whole frame, within the port's tile bounds."""
    import jax.numpy as jnp

    from ray_tpu.render.integrator import PassSettings as JPass
    from ray_tpu.render.integrator import render_tile as j_render
    from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
    from test_torch_render import _check

    sc, cam = j_cornell("emissive_quad")
    ref = j_render(sc.finalize(), cam, None, jnp.int32(0), jnp.int32(0),
                   jnp.uint32(1), jnp.uint32(0), width=WIDTH, height=HEIGHT,
                   tile_w=WIDTH, tile_h=HEIGHT, settings=JPass(**SETTINGS),
                   use_filter_table=False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert ref["color"].mean() > 0.0
    _check(ranks[0]["frame"], ref)
