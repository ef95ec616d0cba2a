"""Angle helpers: the scalar wraps the denovo3d prep chain and
``twist2pitch`` need.

Counterpart of ``helicon_tpu/angular.py:36`` (``set_angle_range``) and
``:51`` (``set_to_periodic_range``).
"""

from __future__ import annotations

import math
import typing

import numpy as np

__all__ = ["set_angle_range", "set_to_periodic_range"]


def set_angle_range(angle, range: typing.Sequence[float] = (-180, 180)):
    """Wrap angle(s) into [low, high] using fmod semantics."""
    v0, v1 = range[0], range[-1]
    delta = v1 - v0
    if isinstance(angle, np.ndarray):
        ret = np.empty_like(angle, dtype=float)
        pos = angle > v0
        ret[pos] = np.fmod(angle[pos] - v0, delta) + v0
        ret[~pos] = v1 - np.fmod(v0 - angle[~pos], delta)
        return ret
    if angle > v0:
        return math.fmod(angle - v0, delta) + v0
    return v1 - math.fmod(v0 - angle, delta)


def set_to_periodic_range(v: float, min: float = -180, max: float = 180) -> float:
    """Wrap a scalar into [min, max] (no-op when already inside)."""
    if min <= v <= max:
        return v
    tmp = math.fmod(v - min, max - min)
    return tmp + (min if tmp >= 0 else max)
