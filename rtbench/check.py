"""What the loops' checks share: the reference's scene and settings, and
the numbers compared.

The reference is :mod:`rtbench.ref`, a frozen copy of the port's plain
PyTorch path that imports nothing of the port.  It compiles the scene
again from the configuration's generator (its own BVHs, light tree,
material and texture tables) and runs after the window, once the
program's state is freed.  Each loop of ``loops/`` holds its own
reference run and its own comparison; each number compared has its limit
in ``limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.harness import scene_api

# Adam as the train loop's step takes it (torch.optim.Adam's defaults)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# leaves under this share of the median nonzero leaf's gradient norm move
# under Adam by round-off alone
LEAF_FLOOR = 1e-3


def ref_scene(run):
    """(scene, camera) of the configuration, compiled by the reference."""
    gen = run.cell.scene_module()
    sc, cam = gen.scene(scene_api("rtbench.ref"))
    scene = sc.finalize(**run.cell.config["finalize"], device=run.device)
    return scene, cam


def ref_settings(run, control: bool):
    """The configuration's pass settings for the reference; ``control``
    stores the path state in bfloat16 between bounces."""
    from rtbench.ref.render.integrator import PassSettings

    return PassSettings(**run.cell.config["pass_settings"],
                        state_bf16=control)


def filter_table(cam):
    """(table, use_table) of the camera's pixel filter."""
    from rtbench.ref.scene.camera import PixelFilter, build_filter_table

    return (build_filter_table(cam.filter, cam.filter_width),
            cam.filter != PixelFilter.BOX)


def limited(run, name: str, value) -> dict:
    """One number compared, beside its limit."""
    return {"value": value, "limit": run.cell.limits[name]}


def pixel_gaps(got, ref):
    """Per row: the largest column's |got - ref| over |ref| plus a
    hundredth of the mean |ref| of all rows."""
    floor = 0.01 * float(ref.abs().mean())
    return ((got - ref).abs() / (ref.abs() + floor)).amax(dim=-1)


def counted_leaves(ref_g1: dict) -> list:
    """Leaves whose reference gradient is at least LEAF_FLOOR of the
    median nonzero leaf's."""
    norms = {k: float(v.norm()) for k, v in ref_g1.items()}
    nonzero = [n for n in norms.values() if n > 0.0]
    if not nonzero:
        return []
    floor = LEAF_FLOOR * float(np.median(nonzero))
    return sorted(k for k, n in norms.items() if n >= floor and n > 0.0)


def worst_leaf_gap(got: dict, ref: dict, leaves: list) -> float:
    """max over leaves of | |got| - |ref| | / max(|ref|, median |ref|)."""
    if not leaves:
        return 0.0
    rn = {k: float(ref[k].norm()) for k in leaves}
    med = float(np.median(list(rn.values())))
    return max(abs(float(got[k].norm()) - rn[k]) / max(rn[k], med, 1e-30)
               for k in leaves)


def accumulate(samples: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The renderer's running mean over samples stacked iteration by
    iteration, ``n_rows`` rows each (``_accumulate``'s arithmetic)."""
    acc = torch.zeros((n_rows, samples.shape[-1]), dtype=torch.float32,
                      device=samples.device)
    for i in range(samples.shape[0] // n_rows):
        acc = acc + (samples[i * n_rows:(i + 1) * n_rows] - acc) / float(i + 1)
    return acc
