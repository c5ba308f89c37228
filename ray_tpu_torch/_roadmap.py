"""One error type for every ``ray_tpu`` feature the port does not carry yet.

The port never computes an unported feature approximately or skips it
silently: it raises, and the message names the ROADMAP.md entry that will
port it.
"""

from __future__ import annotations


def not_ported(what: str, where: str) -> NotImplementedError:
    """``NotImplementedError`` naming the feature and its ROADMAP entry."""
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet: ROADMAP {where}"
    )
