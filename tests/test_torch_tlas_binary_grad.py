"""The bench loss's gradients through the binary two-level walk against
``jax.grad`` on the CPU.

``cornell_tlas`` (the flagship finalized with ``instancing="tlas"``: every
trace takes ``_traverse_tlas`` in ray_tpu and ``trace_tlas_bin_plain`` in
the port, the light quad's TRI lights are instanced) on
tests/test_torch_grad.py's 16x16 flagship tile, depth 3, each float
material column and ``env_col`` held to that file's gates (rtol 1e-3,
atol 1e-3 of the column's largest entry).  A file of its own: ray_tpu's
gradient compile takes most of a minute's budget.
"""

import numpy as np

from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_grad import _assert_matches_jax, _jax_grads, _port_grads


def test_cornell_tlas_gradients_match_jax():
    """The bench loss on a 16x16 tile at the light quad's lower edge
    (tests/test_torch_grad.py's flagship tile), tlas mode."""
    x0, y0 = 952, 116
    (jsc, jcam), (tsc, tcam) = j_cornell(), ts.cornell_tlas()
    j_loss, j_g = _jax_grads(jsc.finalize(instancing="tlas"), jcam, x0, y0)
    t_loss, t_g = _port_grads(tsc.finalize(device="cpu", instancing="tlas"),
                              tcam, x0, y0)
    assert j_loss > 0.0
    _assert_matches_jax(t_loss, t_g, j_loss, j_g)
    for k in ("base_color", "strength", "env_col"):
        assert np.abs(j_g[k]).max() > 0.0, k
