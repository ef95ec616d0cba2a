"""Angle helpers (the one the denovo3d prep chain needs).

Counterpart of ``helicon_tpu/angular.py``.
"""

from __future__ import annotations

import math

__all__ = ["set_to_periodic_range"]


def set_to_periodic_range(v: float, min: float = -180, max: float = 180) -> float:
    """Wrap a scalar into [min, max] (no-op when already inside)."""
    if min <= v <= max:
        return v
    tmp = math.fmod(v - min, max - min)
    return tmp + (min if tmp >= 0 else max)
