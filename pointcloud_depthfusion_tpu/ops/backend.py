"""The one place that picks an operation's implementation per platform.

The supported platforms are ``gpu`` (NVIDIA) and ``cpu`` (tests). Each
entry was chosen by measurement on the card (PERF.md, "Kernel decisions
(H100)"). Any other platform raises: nothing falls back quietly to
another implementation.
"""

from __future__ import annotations

import jax

_CHOICES = {
    # Depth→color alignment (ops/align.py): the class-binned splat is ~5%
    # faster end to end on the H100 at 1280x720; scatter is the CPU path
    # the oracle tests were written against.
    "gpu": {"align": "binned"},
    "cpu": {"align": "scatter"},
}


def choose(op: str, platform: str | None = None) -> str:
    """Implementation name of ``op`` on ``platform`` (default: JAX's
    default backend)."""
    platform = platform or jax.default_backend()
    if platform not in _CHOICES:
        raise RuntimeError(
            f"no implementation of {op!r} for platform {platform!r} "
            f"(supported: {', '.join(sorted(_CHOICES))})"
        )
    return _CHOICES[platform][op]
