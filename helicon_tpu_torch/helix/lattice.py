"""Helical lattice <-> helical parameters.

Counterpart of ``helicon_tpu/helix/lattice.py`` (host numpy, copied):
``helical_lattice_points`` :29, ``lattice_vectors_from_parameters`` :65
and ``parameters_from_lattice_vectors`` :83. A helix unrolled onto its
cylinder is a 2D lattice on the (circumference, z) plane: a (twist,
rise, csym) helix of radius r places subunit (h, c) at x = r * 2 pi *
((h * twist / 360 + c / csym) mod 1) and z = h * rise; conversely two
independent lattice vectors commensurate with the circumference give
(twist, rise, csym).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "helical_lattice_points",
    "lattice_vectors_from_parameters",
    "parameters_from_lattice_vectors",
]


def helical_lattice_points(
    twist: float,
    rise: float,
    radius: float,
    csym: int = 1,
    length: float | None = None,
    n_units: int | None = None,
):
    """(n, 2) unrolled-lattice points (x_circumference, z) in Angstrom.

    One point per (h, c) subunit with |z| <= length/2. With n_units=N
    (and no explicit length) the rungs span h in [-N, N] — i.e.
    (2N + 1) * csym points centered on the origin; default N = 10.
    """
    if length is None:
        length = (n_units if n_units else 10) * abs(rise) * 2
    if length > 0 and abs(rise) < length * 1e-6:
        from ..utils.exceptions import HeliconValueError

        raise HeliconValueError(
            f"rise={rise} is degenerate for length={length}: the rung "
            "count length/rise would explode (all subunits sit at z=0)"
        )
    hmax = max(1, int(math.ceil(length / 2.0 / max(abs(rise), 1e-6))))
    circ = 2.0 * math.pi * radius
    pts = []
    for h in range(-hmax, hmax + 1):
        z = h * rise
        if abs(z) > length / 2.0:
            continue
        for c in range(csym):
            frac = (h * twist / 360.0 + c / csym) % 1.0
            pts.append((frac * circ, z))
    return np.asarray(pts, np.float64).reshape(-1, 2)


def lattice_vectors_from_parameters(
    twist: float, rise: float, radius: float, csym: int = 1
):
    """Two natural unrolled-plane lattice vectors of the helix:

    v1 = one helical step  (circ * twist/360 mod circ, rise)
    v2 = one csym step     (circ / csym, 0)
    Returned as a (2, 2) array [[v1x, v1z], [v2x, v2z]] (Angstrom).
    """
    circ = 2.0 * math.pi * radius
    v1x = (twist / 360.0 % 1.0) * circ
    # report the shorter equivalent (x is periodic with the circumference
    # divided by csym)
    period = circ / csym
    v1x = (v1x + period / 2.0) % period - period / 2.0
    return np.array([[v1x, rise], [period, 0.0]], np.float64)


def parameters_from_lattice_vectors(v1, v2, radius: float):
    """(twist, rise, csym) from two unrolled-plane lattice vectors.

    v2 must be the in-plane (z = 0) vector: circ / v2x subunits per turn
    gives csym; v1 = (dx, rise) gives rise directly and
    twist = 360 * dx / circ (mod 360/csym convention folded to
    (-180, 180]).
    """
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    circ = 2.0 * math.pi * radius
    if abs(v2[1]) > 1e-6:
        raise ValueError("v2 must lie on the equator (z = 0)")
    csym_f = circ / abs(v2[0])
    csym = max(1, int(round(csym_f)))
    if abs(csym_f - csym) > 0.05:
        raise ValueError(
            f"v2 is not commensurate with the circumference "
            f"(circ / v2x = {csym_f:.3f})"
        )
    rise = float(v1[1])
    if abs(rise) < 1e-9:
        raise ValueError("v1 must have a nonzero rise (z component)")
    twist = 360.0 * v1[0] / circ
    twist = (twist + 180.0) % 360.0 - 180.0
    return float(twist), rise, csym
