"""Angle wrapping, Euler-convention conversions and quaternion averaging.

Counterpart of ``helicon_tpu/angular.py`` :30-124 (host numpy and
scipy's ``Rotation``, copied): ``angular_difference``, the wraps
``set_angle_range`` and ``set_to_periodic_range`` (the denovo3d prep
chain and ``twist2pitch`` use them), the RELION / EMAN Euler and
quaternion conversions, the quaternion averages and ``angular_distance``.
"""

from __future__ import annotations

import math
import typing

import numpy as np

__all__ = [
    "angular_difference",
    "set_angle_range",
    "set_to_periodic_range",
    "euler_relion2eman",
    "euler_eman2relion",
    "eman_euler2quaternion",
    "relion_euler2quaternion",
    "quaternion2euler",
    "average_quaternions",
    "average_relion_eulers",
    "angular_distance",
]


def angular_difference(angle1, angle2, period: float = 360):
    """Minimal wrapped difference in [-period/2, period/2)."""
    diff = np.asarray(angle1) - np.asarray(angle2)
    return (diff + period / 2) % period - period / 2


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


def euler_relion2eman(rot, tilt, psi):
    """RELION (rot, tilt, psi) -> EMAN (az, alt, phi)."""
    return rot + 90.0, tilt, psi - 90.0


def euler_eman2relion(az, alt, phi):
    """EMAN (az, alt, phi) -> RELION (rot, tilt, psi)."""
    return az - 90.0, alt, phi + 90.0


def _zyz_to_quaternion(rot, tilt, psi) -> np.ndarray:
    """Intrinsic-ZYZ Euler (degrees) -> scalar-first quaternions (N, 4)."""
    from scipy.spatial.transform import Rotation as R

    r = R.from_euler("ZYZ", np.vstack((rot, tilt, psi)).T, degrees=True)
    q = np.atleast_2d(r.as_quat())  # scalar-last
    return np.hstack((q[:, 3:4], q[:, :3]))


def eman_euler2quaternion(az, alt, phi) -> np.ndarray:
    """EMAN Eulers -> scalar-first quaternions (via RELION convention)."""
    return _zyz_to_quaternion(np.asarray(az) - 90.0, alt, np.asarray(phi) + 90.0)


def relion_euler2quaternion(rot, tilt, psi) -> np.ndarray:
    """RELION Eulers -> scalar-first quaternions."""
    return _zyz_to_quaternion(rot, tilt, psi)


def quaternion2euler(q, euler_convention: str = "relion"):
    """Scalar-first quaternion(s) -> (rot, tilt, psi) wrapped to (-180, 180]."""
    from scipy.spatial.transform import Rotation as R

    q = np.atleast_2d(np.asarray(q))
    r = R.from_quat(np.hstack((q[:, 1:4], q[:, 0:1])))
    euler = r.as_euler("ZYZ", degrees=True)
    rot = set_angle_range(euler[:, 0], range=(-180, 180))
    tilt = set_angle_range(euler[:, 1], range=(-180, 180))
    psi = set_angle_range(euler[:, 2], range=(-180, 180))
    if euler_convention == "relion":
        return rot, tilt, psi
    if euler_convention == "eman":
        return euler_relion2eman(rot, tilt, psi)
    raise ValueError(f"Unknown euler_convention: {euler_convention}")


def average_quaternions(Q: np.ndarray, w=None) -> np.ndarray:
    """Markley eigenvector average of quaternions (sign-ambiguity safe)."""
    Q = np.asarray(Q, np.float64)
    weights = np.ones(Q.shape[0]) if w is None else np.asarray(w, np.float64)
    A = (Q.T * weights) @ Q / weights.sum()
    eigvals, eigvecs = np.linalg.eigh(A)
    return np.real(eigvecs[:, -1]).ravel()


def average_relion_eulers(rot, tilt, psi, weights=None, return_quaternion: bool = False):
    """Average RELION Euler triplets via quaternion averaging."""
    assert len(rot) == len(tilt) == len(psi)
    Q = relion_euler2quaternion(rot, tilt, psi)
    qm = average_quaternions(Q, w=weights)
    if return_quaternion:
        return qm
    return quaternion2euler(qm, euler_convention="relion")


def angular_distance(rotation_1, rotation_2) -> float:
    """Geodesic distance (degrees) between two scipy Rotations."""
    return float(np.rad2deg((rotation_1.inv() * rotation_2).magnitude()))
