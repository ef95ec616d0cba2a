"""Synthetic helical projection images (ground truth for tests and checks).

Counterpart of ``helicon_tpu/helix/simulate.py``: ``random_polymer`` (:40),
``helical_unit_positions`` (:137) and ``simulate_helical_projection``
(:214) with ``_gaussian_balls_projection`` (:203). The subunit positions
are host numpy, a copy of the reference's; the sum of Gaussian balls runs
in torch on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "helical_unit_positions",
    "random_polymer",
    "simulate_helical_projection",
]


def _rot_z(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rot_y(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_x(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def random_polymer(
    n_atoms: int = 100,
    rmin: float = 0,
    rmax: float = 100,
    csym: int = 1,
    planarity: float = 0.9,
    rng=None,
):
    """Self-avoiding random walk inside a cylindrical shell with csym copies.

    Mirrors reference random_polymer (utils.py:194-333): CA-CA step 3.8 A,
    min separation 0.8*3.8 A, out-of-plane step spread shrunk by planarity.
    Returns (N*csym, 3) coordinates; N may be < n_atoms if the walk jams.
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    ca_dist = 3.8
    min_dist = ca_dist * 0.8

    def symmetrize(p):
        if csym <= 1:
            return p[None, :]
        return np.stack([_rot_z(si * 360.0 / csym) @ p for si in range(csym)])

    def positions_ok(new_points, existing_points):
        if len(new_points) > 1:
            d = np.linalg.norm(
                new_points[:, None, :] - new_points[None, :, :], axis=-1
            )
            d[np.diag_indices_from(d)] = 1e10
            if np.any(d < min_dist):
                return False
        d = np.linalg.norm(
            new_points[:, None, :] - existing_points[None, :, :], axis=-1
        )
        if new_points.shape == existing_points.shape and np.allclose(
            new_points, existing_points
        ):
            d[np.diag_indices_from(d)] = 1e10
        return not np.any(d < min_dist)

    def next_point(existing):
        n_trials = 1
        while True:
            angle_out_plane_max = 90.0 * (1.0 - planarity)
            sigma_z = abs(rng.normal(0, max(angle_out_plane_max / 3, 1e-9)))
            sigma_xy = 180.0 / 3
            if len(existing) < 2:
                d0 = existing[-1] * 0
            else:
                d0 = existing[-1] - existing[-2]
                d0 = d0 / np.linalg.norm(d0) / n_trials
                r = np.linalg.norm(existing[-1])
                d0 = d0 * (rmax - r) / rmax
            d = rng.normal(0, (sigma_xy, sigma_xy, max(sigma_z, 1e-9)))
            d /= np.linalg.norm(d)
            d = (d0 + d) / np.linalg.norm(d0 + d)
            p = existing[-1] + ca_dist * d
            r = np.linalg.norm(p)
            if rmin <= r <= rmax or n_trials > 10:
                break
            n_trials += 1
        return symmetrize(p)

    max_trials = 10
    n_good = 0
    xyz = np.zeros((csym * n_atoms, 3))
    for _ in range(max_trials):
        xyz[:] = 0.0
        started = False
        for _ in range(max_trials):
            r = np.sqrt(rng.uniform(rmin**2, rmax**2))
            ang = rng.uniform(-np.pi, np.pi)
            xyz[0] = (r * np.sin(ang), r * np.cos(ang), 0.0)
            xyz[0:csym] = symmetrize(xyz[0])
            if positions_ok(xyz[0:csym], xyz[0:csym]):
                started = True
                n_good = 1
                break
        if not started:
            break
        for i in range(1, n_atoms):
            placed = False
            for _ in range(max_trials):
                existing = xyz[: i * csym]
                p = next_point(existing)
                if positions_ok(p, existing):
                    xyz[i * csym : (i + 1) * csym] = p
                    placed = True
                    n_good = i + 1
                    break
            if not placed:
                break
        if n_good == n_atoms:
            break
    return xyz[: n_good * csym]


def helical_unit_positions(
    n: int,
    twist: float,
    rise: float,
    csym: int,
    diameter: float,
    height: float,
    polymer: int = 0,
    planarity: float = 1.0,
    tilt: float = 0,
    rot: float = 0,
    psi: float = 0,
    dy: float = 0,
    rng=None,
):
    """2D (y, z) centers of all symmetry-expanded subunits.

    Mirrors the inner helper of simulate_helical_projection
    (utils.py:107-176): asymmetric-unit balls replicated over
    (helical repeat x csym), optional tilt/psi rotation and dy shift,
    projected along the viewing axis.
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    assert n >= 1
    if polymer:
        centers_0 = random_polymer(
            n_atoms=n, rmin=0, rmax=diameter / 2, csym=csym, planarity=planarity, rng=rng
        )
        centers_0 = centers_0 @ _rot_y(90).T
        centers_0 = centers_0[:, [2, 1, 0]]
        n = len(centers_0)
    else:
        centers_0 = np.zeros((n, 3), dtype=np.float32)
        if n > 1:
            r = np.sqrt(rng.uniform(0, diameter**2 / 4, n))
            angle = rng.uniform(-np.pi, np.pi, n) + np.deg2rad(rot)
            centers_0[:, 0] = r * np.cos(angle)
            centers_0[:, 1] = r * np.sin(angle)
            centers_0[:, 2] = rng.uniform(-rise / 2, rise / 2, n)
        else:
            angle = np.deg2rad(rot)
            centers_0[0] = (
                np.cos(angle) * diameter / 2,
                np.sin(angle) * diameter / 2,
                0.0,
            )
    imax = int(np.ceil(height / rise))
    copies = []
    for i in range(-imax, imax + 1):
        for si in range(csym):
            angle = twist * i + si * 360.0 / csym
            c = centers_0 @ _rot_z(angle).T
            c = c + np.array([0.0, 0.0, i * rise])
            copies.append(c)
    centers = np.concatenate(copies, axis=0)
    if tilt or psi:
        # reference utils.py:167: R.from_euler("yx", (tilt, -psi)) —
        # lowercase = EXTRINSIC: rotate about y by tilt FIRST, then
        # about x by -psi, i.e. Rx(-psi) @ Ry(tilt)
        centers = centers @ (_rot_x(-psi) @ _rot_y(tilt)).T
    if dy:
        centers[:, 1] += dy
    return centers[:, [1, 2]]  # project along z -> (y, z)


def _gaussian_balls_projection(centers_yx, sigma2, Y, X, chunk: int = 256):
    """Sum of Gaussian balls at centers (n, 2) over the grid (Y, X)."""
    out = torch.zeros_like(Y)
    for s in range(0, centers_yx.shape[0], chunk):
        c = centers_yx[s : s + chunk]
        y = Y[None] - c[:, 0, None, None]
        x = X[None] - c[:, 1, None, None]
        out = out + torch.exp(-(x * x + y * y) / sigma2).sum(dim=0)
    return out


def simulate_helical_projection(
    n: int,
    twist: float,
    rise: float,
    csym: int,
    helical_diameter: float,
    ball_radius: float,
    polymer: int,
    planarity: float,
    ny: int,
    nx: int,
    apix: float,
    tilt: float = 0,
    rot: float = 0,
    psi: float = 0,
    dy: float = 0,
    rng=None,
    device="cuda",
):
    """Simulate a 2D projection (ny, nx) float32 numpy of a helix of
    Gaussian balls; the balls are summed on ``device`` (the card unless
    the caller asks for "cpu")."""
    assert helical_diameter + ball_radius < ny * apix * 0.99
    centers = helical_unit_positions(
        n,
        twist,
        rise,
        csym,
        helical_diameter,
        height=nx * apix,
        polymer=polymer,
        planarity=planarity,
        tilt=tilt,
        rot=rot,
        psi=psi,
        dy=dy,
        rng=rng,
    )
    dev = torch.device(device)
    sigma2 = np.float32(ball_radius * ball_radius / np.log(2))
    Y, X = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=dev) - ny // 2,
        torch.arange(nx, dtype=torch.float32, device=dev) - nx // 2,
        indexing="ij",
    )
    c = torch.as_tensor(np.asarray(centers, np.float32), device=dev)
    return _gaussian_balls_projection(c, float(sigma2), Y * apix, X * apix).cpu().numpy()
