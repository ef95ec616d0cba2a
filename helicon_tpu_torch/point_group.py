"""Rotational point-group symmetry (C/D/T/O/I) operations and distances.

Counterpart of ``helicon_tpu/point_group.py`` (host numpy on scipy's
``Rotation``, copied): ``PointGroup(symbol)`` :19 with its matrices
generated by group closure, the icosahedral orientation conventions
(I1/I2/I3/I4 and the suffix forms), symmetry applied to points and
rotations, and the symmetry-aware point and rotation distances.
"""

from __future__ import annotations

import re

import numpy as np
from scipy.spatial.transform import Rotation

__all__ = ["PointGroup"]


class PointGroup:
    """Rotational point group from a Schoenflies symbol."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.matrices = self._generate_matrices(symbol)

    @staticmethod
    def _get_icosahedral_orientation_rotation(symbol: str) -> Rotation:
        """Rotation from the I1 (2z2x5y) convention to the target one
        (point_group.py:30-86)."""
        phi = (1 + np.sqrt(5)) / 2
        symbol_upper = symbol.upper()
        if symbol_upper == "I1":
            suffix = "_2z2x5y"
        elif symbol_upper == "I2":
            suffix = "_2z2x5x"
        elif symbol_upper == "I3":
            suffix = "_5z2y"
        elif symbol_upper in ("I4", "I"):
            suffix = "_5z2x"
        else:
            match = re.match(r"I(\d*)((?:_[0-9a-zA-Z]+)?)", symbol, re.IGNORECASE)
            if not match:
                raise ValueError(f"Invalid icosahedral symbol: {symbol}")
            suffix = match.group(2).lower() if match.group(2) else ""
        if suffix == "_2z2x5y":
            return Rotation.identity()
        if suffix == "_2z2x5x":
            return Rotation.from_rotvec([0, 0, np.pi / 2])
        if suffix == "_5z2x":
            return Rotation.from_rotvec([np.arctan(1 / phi), 0, 0])
        if suffix == "_5z2y":
            return Rotation.from_rotvec([0, -np.arctan(phi), 0])
        if suffix == "_3z2x":
            return Rotation.from_rotvec([np.arctan(phi**2), 0, 0])
        if suffix == "_3z2y":
            return Rotation.from_rotvec([0, 0, np.pi / 2]) * Rotation.from_rotvec(
                [np.arctan(phi**2), 0, 0]
            )
        raise ValueError(f"Unsupported icosahedral convention: {symbol}")

    @staticmethod
    def get_icosahedral_conversion_rotation(from_symbol: str, to_symbol: str):
        r1 = PointGroup._get_icosahedral_orientation_rotation(from_symbol)
        r2 = PointGroup._get_icosahedral_orientation_rotation(to_symbol)
        return r2 * r1.inv()

    def _generate_matrices(self, symbol: str) -> np.ndarray:
        """Generators + iterative closure (point_group.py:106-213)."""
        match = re.match(r"([A-Za-z]+)(\d*)((?:_[a-zA-Z0-9]*)?)", symbol)
        if not match:
            raise ValueError(f"Invalid Schoenflies symbol: {symbol}")
        main_type_raw, n_str, _ = match.groups()
        main_type = main_type_raw.upper()[:1]
        n = int(n_str) if n_str else 1

        ops = [np.eye(3)]
        if main_type == "C":
            if n > 1:
                ops.append(Rotation.from_rotvec([0, 0, 2 * np.pi / n]).as_matrix())
            limit = n
        elif main_type == "D":
            ops.append(Rotation.from_rotvec([0, 0, 2 * np.pi / n]).as_matrix())
            ops.append(Rotation.from_rotvec([np.pi, 0, 0]).as_matrix())
            limit = 2 * n
        elif main_type == "T":
            c3 = Rotation.from_rotvec(
                np.array([1, 1, 1]) / np.sqrt(3) * (2 * np.pi / 3)
            ).as_matrix()
            c2z = Rotation.from_rotvec([0, 0, np.pi]).as_matrix()
            ops.extend([c3, c2z])
            limit = 12
        elif main_type == "O":
            c4z = Rotation.from_rotvec([0, 0, np.pi / 2]).as_matrix()
            c3 = Rotation.from_rotvec(
                np.array([1, 1, 1]) / np.sqrt(3) * (2 * np.pi / 3)
            ).as_matrix()
            ops.extend([c4z, c3])
            limit = 24
        elif main_type == "I":
            phi = (1 + np.sqrt(5)) / 2
            c2z = Rotation.from_rotvec([0, 0, np.pi])
            c2x = Rotation.from_rotvec([np.pi, 0, 0])
            axis_5y = np.array([0, 1, phi]) / np.sqrt(1 + phi**2)
            c5y = Rotation.from_rotvec(axis_5y * 2 * np.pi / 5)
            rot = self._get_icosahedral_orientation_rotation(symbol)
            for gen in (c2z, c2x, c5y):
                ops.append((rot * gen * rot.inv()).as_matrix())
            limit = 60
        else:
            raise ValueError(f"Unsupported rotational group: {main_type}")

        generators = [m for m in ops if not np.allclose(m, np.eye(3), atol=1e-7)]
        while len(ops) < limit:
            before = len(ops)
            new_ops = []
            for m1 in ops:
                for m2 in generators:
                    for prod in (m1 @ m2, m2 @ m1):
                        if not any(
                            np.allclose(prod, ex, atol=1e-7) for ex in ops
                        ) and not any(
                            np.allclose(prod, ex, atol=1e-7) for ex in new_ops
                        ):
                            new_ops.append(prod)
                            if len(ops) + len(new_ops) >= limit:
                                break
                    if len(ops) + len(new_ops) >= limit:
                        break
                if len(ops) + len(new_ops) >= limit:
                    break
            ops.extend(new_ops)
            if len(ops) == before:
                break
        return np.array(ops)

    def apply_symmetry_to_points(self, points):
        points = np.asanyarray(points)
        if points.ndim == 1:
            return np.einsum("gij,j->gi", self.matrices, points)
        return np.einsum("gij,nj->gni", self.matrices, points)

    def distance_of_points(self, points1, points2, metric: str = "mse"):
        """Minimum distance over symmetry-equivalent configurations
        (point_group.py:232-284)."""
        points1 = np.asanyarray(points1)
        points2 = np.asanyarray(points2)
        tp1 = self.apply_symmetry_to_points(points1)
        if points2.ndim == 1:
            dists = np.sum((tp1 - points2[None, :]) ** 2, axis=-1)
        else:
            sq = np.sum((tp1 - points2[None, :, :]) ** 2, axis=-1)
            if metric == "mse":
                dists = np.mean(sq, axis=1)
            elif metric == "rmse":
                dists = np.sqrt(np.mean(sq, axis=1))
            elif metric == "max":
                dists = np.max(np.abs(tp1 - points2[None, :, :]), axis=(1, 2))
            else:
                raise ValueError(f"Unknown metric: {metric}")
        return float(np.min(dists))

    def get_rotations(self) -> Rotation:
        return Rotation.from_matrix(self.matrices)

    def apply_symmetry_to_rotations(self, rotations: Rotation) -> Rotation:
        return Rotation.concatenate([s * rotations for s in self.get_rotations()])

    def distance_of_rotations(self, rots1, rots2, metric: str = "geodesic"):
        """Min geodesic/chordal distance over symmetry ops
        (point_group.py:319-379)."""
        if not isinstance(rots1, Rotation):
            rots1 = Rotation.from_matrix(np.asarray(rots1))
        if not isinstance(rots2, Rotation):
            rots2 = Rotation.from_matrix(np.asarray(rots2))
        n = 1 if rots1.single else len(rots1)
        transformed = self.apply_symmetry_to_rotations(rots1)
        G = len(self.matrices)
        m2 = rots2.as_matrix().reshape(n, 3, 3)
        m1 = transformed.as_matrix().reshape(G, n, 3, 3)
        if metric == "geodesic":
            rel = np.einsum("gnij,nkj->gnik", m1, m2)  # m1 @ m2^T
            tr = np.trace(rel, axis1=-2, axis2=-1)
            ang = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1.0, 1.0)))
            dists = np.mean(ang, axis=1)
        elif metric == "chordal":
            dists = np.mean(
                np.linalg.norm(m1 - m2[None], axis=(-2, -1)), axis=1
            )
        else:
            raise ValueError(f"Unknown metric: {metric}")
        return float(np.min(dists))

    def __len__(self):
        return len(self.matrices)
