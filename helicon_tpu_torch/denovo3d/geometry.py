"""Host-side reconstruction geometry: sizes, masks, symmetry copy/pair lists.

A numpy copy of ``helicon_tpu/denovo3d/geometry.py`` (which is numpy-only
already): the PyTorch port cannot import ``helicon_tpu``, whose package
import pulls in JAX. ``tests/test_torch_geometry.py`` pins every function
here to the original, bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np

__all__ = [
    "ReconstructionGeometry",
    "back_project_2d_coords_to_3d_coords",
    "estimate_copy_pair_counts",
    "estimate_n_pair_ops",
    "halton_permutation",
    "select_copies",
    "select_pair_ops",
    "select_pairs",
    "sorted_hsym_csym_pairs",
]


@functools.lru_cache(maxsize=4096)
def halton_permutation(n: int) -> np.ndarray:
    """Index sequence drawn from an unscrambled 1D Halton (van der Corput,
    base 2) sequence, matching scipy.stats.qmc.Halton.integers as used by
    the reference (solver_linear_regression.py:1570-1575).

    May repeat/omit indices — the reference has the same property.
    Deterministic in n, so memoized (scipy Halton init dominates the
    per-candidate table cost otherwise). Do not mutate the result.
    """
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    try:
        from scipy.stats import qmc

        h = qmc.Halton(d=1, scramble=False)
        return h.integers(l_bounds=0, u_bounds=n, n=n).ravel().astype(np.int64)
    except Exception:
        # van der Corput base 2 fallback
        out = np.zeros(n, dtype=np.int64)
        for i in range(n):
            f, r, x = 1.0, 0.0, i + 1
            while x > 0:
                f /= 2.0
                r += f * (x % 2)
                x //= 2
            out[i] = min(int(r * n), n - 1)
        return out


@dataclasses.dataclass(frozen=True)
class ReconstructionGeometry:
    """Static geometry of one reconstruction problem (all sizes in pixels).

    d2/l2: 2D region diameter (rows j, ray depth k) and length (columns i).
    d3/l3: 3D volume diameter and length (volume shape = (l3, d3, d3)).
    """

    d2: int
    l2: int
    d3: int
    l3: int
    rmin: float
    rmax: float
    scale2d_to_3d: float
    csym: int = 1

    @property
    def volume_shape(self):
        return (self.l3, self.d3, self.d3)

    def cylindrical_mask(self) -> np.ndarray:
        """Reference get_cylindrical_mask semantics (analysis.py:731-774)."""
        from ..core.analysis import get_cylindrical_mask

        return np.asarray(
            get_cylindrical_mask(
                nz=self.l3, ny=self.d3, nx=self.d3, rmin=self.rmin, rmax=self.rmax
            )
        )

    def cell_valid_mask(self) -> np.ndarray:
        """mask[z:z+2, y:y+2, x:x+2].all() per cell — the trilinear
        all-8-corners-in-mask validity test as one static volume."""
        m = self.cylindrical_mask()
        c = (
            m[:-1, :-1, :-1]
            & m[1:, :-1, :-1]
            & m[:-1, 1:, :-1]
            & m[:-1, :-1, 1:]
            & m[1:, 1:, :-1]
            & m[1:, :-1, 1:]
            & m[:-1, 1:, 1:]
            & m[1:, 1:, 1:]
        )
        out = np.zeros_like(m)
        out[:-1, :-1, :-1] = c
        return out

    def hsym_max_data(self, rise_pixel: float) -> int:
        """Reference: max(1, int(ceil(l3 + l2) / 2 / rise_pixel))
        (solver:1561) — the int() of the float ratio."""
        return max(1, int((self.l3 + self.l2) / 2 / rise_pixel))

    def hsym_max_pairs(self, rise_pixel: float) -> int:
        """Reference sorted_hsym_csym_pairs: max(1, ceil(l3/(2*rise)))
        (solver:955)."""
        return pair_hmax(self.l3, rise_pixel)


def select_copies(
    geom: ReconstructionGeometry,
    rise_pixel: float,
    n_copies: int,
    csym: int | None = None,
):
    """Per-candidate (hsym, csym) projection copies, reference ordering.

    Order: sort by (|h|, c) then Halton-permute (solver:1561-1575); pad
    (with valid=False) or truncate to the static n_copies.
    Returns (h[i32 n_copies], c[i32 n_copies], valid[bool n_copies]).
    """
    csym = geom.csym if csym is None else csym
    hmax = geom.hsym_max_data(rise_pixel)
    hcs = list(itertools.product(range(-hmax, hmax + 1), range(csym)))
    hcs.sort(key=lambda x: (abs(x[0]), x[1]))
    idx = halton_permutation(len(hcs))
    hcs = [hcs[int(i)] for i in idx]
    h = np.zeros(n_copies, np.int32)
    c = np.zeros(n_copies, np.int32)
    v = np.zeros(n_copies, bool)
    m = min(n_copies, len(hcs))
    if m:
        arr = np.asarray(hcs[:m], np.int32)
        h[:m], c[:m] = arr[:, 0], arr[:, 1]
        v[:m] = True
    return h, c, v


@functools.lru_cache(maxsize=256)
def _pair_combinatorics(hmax: int, csym: int):
    """Twist-independent part of the pair table: the (h, c) op pairs in
    combinations order plus the precomputed |h| sort keys (shared by
    every candidate with the same rise-derived hmax)."""
    hs = np.arange(-hmax, hmax + 1)
    H, C = np.meshgrid(hs, np.arange(csym), indexing="ij")
    H, C = H.ravel(), C.ravel()  # itertools.product order
    i1, i2 = np.triu_indices(len(H), k=1)  # combinations order
    h1, c1, h2, c2 = H[i1], C[i1], H[i2], C[i2]
    return h1, c1, h2, c2, np.abs(h2), np.abs(h1), np.abs(h1 - h2), np.abs(h1 + h2)


def pair_hmax(nz: int, rise_pixel: float) -> int:
    """The pair table's hmax: max(1, ceil(nz/(2*rise))) (solver:955).
    THE single definition — hsym_max_pairs, _pair_table, and the
    grid's same-hmax row dedup (grid._group_tables) all call it."""
    return max(1, int(np.ceil(nz / (2 * rise_pixel))))


def _pair_table(twist: float, rise_pixel: float, csym: int, nz: int) -> np.ndarray:
    """Vectorized sorted_hsym_csym_pairs (solver:933-1000): all op pairs
    as rows [h1, c1, h2, c2], sorted by (angle, |h1+h2|, |h1-h2|, |h1|,
    |h2|) (stable, ties keep combinations order) then Halton-permuted.
    The returned array is read-only. Rise and nz enter only through
    hmax (the angles are twist-only), so memoization lives on
    (twist, hmax, csym): every rise in a twist-group hits one entry."""
    return _pair_table_hm(twist, pair_hmax(nz, rise_pixel), csym)


@functools.lru_cache(maxsize=512)
def _pair_table_hm(twist: float, hmax: int, csym: int) -> np.ndarray:
    h1, c1, h2, c2, ah2, ah1, ahd, ahs = _pair_combinatorics(hmax, csym)
    a1 = twist * h1 + c1 * 360.0 / csym
    a2 = twist * h2 + c2 * 360.0 / csym
    angle = np.round(np.abs((a2 - a1 + 180.0) % 360.0 - 180.0), 2)
    order = np.lexsort((ah2, ah1, ahd, ahs, angle))
    idx = halton_permutation(len(order))
    sel = order[idx]
    out = np.stack([h1[sel], c1[sel], h2[sel], c2[sel]], axis=1).astype(np.int32)
    out.flags.writeable = False
    return out


def sorted_hsym_csym_pairs(twist: float, rise_pixel: float, csym: int, nz: int):
    """Angle-sorted + Halton-permuted pairs of symmetry operations.

    Same return format as the reference (solver:933-1000): a list of
    (angle, |h1+h2|, |h1-h2|, |h1|, |h2|, ((h1, c1), (h2, c2))) tuples.
    """
    out = []
    for r in _pair_table(twist, rise_pixel, csym, nz):
        h1, c1, h2, c2 = (int(v) for v in r)
        a1 = twist * h1 + c1 * 360.0 / csym
        a2 = twist * h2 + c2 * 360.0 / csym
        angle = round(abs((a2 - a1 + 180.0) % 360.0 - 180.0), 2)
        out.append(
            (angle, abs(h1 + h2), abs(h1 - h2), abs(h1), abs(h2), ((h1, c1), (h2, c2)))
        )
    return out


def select_pairs(
    geom: ReconstructionGeometry,
    twist: float,
    rise_pixel: float,
    n_pairs: int,
    csym: int | None = None,
):
    """Per-candidate symmetry-constraint pairs, padded to static n_pairs.

    Returns (hc[i32 (n_pairs, 4)] rows [h1, c1, h2, c2], valid[bool]).
    """
    csym = geom.csym if csym is None else csym
    t = _pair_table(twist, rise_pixel, csym, geom.l3)
    hc = np.zeros((n_pairs, 4), np.int32)
    v = np.zeros(n_pairs, bool)
    m = min(n_pairs, len(t))
    hc[:m] = t[:m]
    v[:m] = True
    return hc, v


def select_pair_ops(
    geom: ReconstructionGeometry,
    twist: float,
    rise_pixel: float,
    n_pairs: int,
    n_ops: int,
    csym: int | None = None,
):
    """Pair selection factored through the distinct symmetry ops:
    pairs reference an op table so the device code samples each op once
    per matvec instead of once per pair side.

    Returns (ops_hc [n_ops, 2] i32, ops_valid [n_ops] bool,
             pair_idx [n_pairs, 2] i32 indices into the op table,
             pairs_valid [n_pairs] bool).
    """
    csym = geom.csym if csym is None else csym
    t = _pair_table(twist, rise_pixel, csym, geom.l3)[:n_pairs]
    ops_hc = np.zeros((n_ops, 2), np.int32)
    ops_valid = np.zeros(n_ops, bool)
    pair_idx = np.zeros((n_pairs, 2), np.int32)
    pairs_valid = np.zeros(n_pairs, bool)
    index = {}
    for i, row in enumerate(t):
        ids = []
        ok = True
        for hc in ((row[0], row[1]), (row[2], row[3])):
            if hc not in index:
                if len(index) >= n_ops:
                    ok = False
                    break
                index[hc] = len(index)
                ops_hc[index[hc]] = hc
                ops_valid[index[hc]] = True
            ids.append(index[hc])
        if not ok:
            break
        pair_idx[i] = ids
        pairs_valid[i] = True
    return ops_hc, ops_valid, pair_idx, pairs_valid


def estimate_copy_pair_counts(
    geom: ReconstructionGeometry,
    rise_pixel_min: float,
    sym_oversample: int,
    max_equations: int = 2**26,
    rise_pixel_max: float | None = None,
):
    """Static (n_copies, n_pairs) sized for the worst candidate in a grid.

    Mirrors the reference's equation budget: both matrix builders keep
    consuming Halton-ordered ops until the ACTUAL accumulated row count
    reaches min(max_equations, max(n_2d_pixels, n_3d_voxels) *
    sym_oversample) (solver:131-172, 1286). Static shapes cannot adapt
    per candidate, so the counts here are sized from the EXPECTED valid
    rows per copy/pair — the z-overlap of a +-h-shifted sample shrinks
    by |h| * rise / l3 — at the grid's largest rise (worst case), not
    from the best-case one-row-per-voxel assumption (which under-built
    the system by 2x for large-rise candidates)."""
    rise_max = float(rise_pixel_max) if rise_pixel_max else float(rise_pixel_min)
    n2d = geom.d2 * geom.l2
    n3d = int(geom.cylindrical_mask().sum())
    l3 = max(1, geom.l3)
    target = min(max_equations, int(max(n2d, n3d) * max(1, sym_oversample)))

    # copies arrive in |h|-ascending order: accumulate expected rows
    hmax = geom.hsym_max_data(rise_pixel_min)
    total_copies = (2 * hmax + 1) * geom.csym
    acc = 0.0
    n_copies = 0
    for k in range(2 * hmax + 1):
        h = (k + 1) // 2 * (1 if k % 2 else -1) if k else 0
        fill = max(0.05, 1.0 - abs(h) * rise_max / l3)
        n_copies += geom.csym
        acc += geom.csym * n2d * fill
        if acc >= target:
            break
    n_copies = min(max(2, n_copies + 1), total_copies)

    # pairs: mean z-overlap over the op-pair span distribution
    hmax_p = geom.hsym_max_pairs(rise_pixel_min)
    n_ops = (2 * hmax_p + 1) * geom.csym
    h1, _, h2, _, *_ = _pair_combinatorics(hmax_p, geom.csym)
    span = np.maximum.reduce([h1, h2, np.zeros_like(h1)]) - np.minimum.reduce(
        [h1, h2, np.zeros_like(h1)]
    )
    mean_fill = float(
        np.mean(np.maximum(0.05, 1.0 - span * rise_max / l3))
    )
    n_pairs = int(np.ceil(target / max(1, n3d) / mean_fill)) + 1
    n_pairs = min(n_pairs, n_ops * (n_ops - 1) // 2)
    return max(1, n_copies), max(1, n_pairs)


def estimate_n_pair_ops(geom: ReconstructionGeometry, rise_pixel_min: float) -> int:
    """Static op-table size for select_pair_ops over a candidate grid."""
    hmax_p = geom.hsym_max_pairs(rise_pixel_min)
    return (2 * hmax_p + 1) * geom.csym


def back_project_2d_coords_to_3d_coords(
    image,
    scale2d_to_3d: float,
    reconstruct_diameter_2d_pixel: int = -1,
    reconstruct_length_2d_pixel: int = -1,
):
    """Back-project 2D image coordinates into the 3D frame.

    Host-side numpy twin of the reference
    (solver_linear_regression.py:1657-1746): centered (k, j, i) grids,
    R_y(90 deg) inverse (x, y, z) -> (-z, y, x), scale, axis swap so the
    helical axis is the first array axis. Returns ((X, Y, Z), pixel_vals)
    with arrays of shape (l2, d2, d2) and pixel_vals (d2, l2).
    """
    image = np.asarray(image)
    ny, nx = image.shape
    d2 = int(np.rint(reconstruct_diameter_2d_pixel)) if reconstruct_diameter_2d_pixel > 0 else ny
    l2 = int(np.rint(reconstruct_length_2d_pixel)) if reconstruct_length_2d_pixel > 0 else nx
    k = np.arange(d2, dtype=np.int32) - d2 // 2
    j = np.arange(d2, dtype=np.int32) - d2 // 2
    i = np.arange(l2, dtype=np.int32) - l2 // 2
    pixel_vals = image[np.ix_(j + ny // 2, i + nx // 2)]
    Z, Y, X = np.meshgrid(
        k.astype(np.float32), j.astype(np.float32), i.astype(np.float32),
        indexing="ij",
    )
    # R_y(90).inv maps (x, y, z) -> (-z, y, x)
    X2, Y2, Z2 = -Z, Y, X
    if scale2d_to_3d != 1.0:
        X2, Y2, Z2 = (a * scale2d_to_3d for a in (X2, Y2, Z2))
    X2 = np.swapaxes(X2, 0, 2)
    Y2 = np.swapaxes(Y2, 0, 2)
    Z2 = np.swapaxes(Z2, 0, 2)
    return (X2, Y2, Z2), pixel_vals


def compute_sym_dedup_mask(
    geom: ReconstructionGeometry,
    twist: float,
    rise_pixel: float,
    pairs_hc: np.ndarray,
    pairs_valid: np.ndarray,
):
    """Per-voxel keep mask reproducing the reference's nn symmetry-row
    dedup (solver:1164-1216): a voxel-pair constraint (i, j) is kept only
    at its first occurrence across the Halton-ordered pair list; later
    duplicates (including the mirrored (j, i)) are dropped.

    Returns keep (n_pairs, l3, d3, d3) bool. Only meaningful for
    interpolation="nn" (the reference's linear kernel does not dedup).
    """
    l3, d3 = geom.l3, geom.d3
    mask = geom.cylindrical_mask()
    nz_idx = np.zeros(mask.shape, np.int64) - 1
    nz = np.nonzero(mask)
    n_x = len(nz[0])
    nz_idx[nz] = np.arange(n_x)
    Z0 = nz[0].astype(np.float64) - l3 // 2
    Y0 = nz[1].astype(np.float64) - d3 // 2
    X0 = nz[2].astype(np.float64) - d3 // 2

    def op_index(h, c):
        th = np.deg2rad(twist * h + 360.0 * c / geom.csym)
        cs, sn = np.cos(th), np.sin(th)
        X = X0 * cs - Y0 * sn + d3 // 2
        Y = X0 * sn + Y0 * cs + d3 // 2
        Z = Z0 + h * rise_pixel + l3 // 2
        zi = np.round(Z).astype(np.int64)
        yi = np.round(Y).astype(np.int64)
        xi = np.round(X).astype(np.int64)
        inb = (
            (zi >= 0) & (zi < l3) & (yi >= 0) & (yi < d3) & (xi >= 0) & (xi < d3)
        )
        idx = np.full(n_x, -1, np.int64)
        ib = np.where(inb)[0]
        cand = nz_idx[zi[ib], yi[ib], xi[ib]]
        idx[ib] = cand  # -1 where outside the mask
        return idx

    n_pairs = len(pairs_hc)
    cache = {}
    i1 = np.full((n_pairs, n_x), -1, np.int64)
    i2 = np.full((n_pairs, n_x), -1, np.int64)
    for p in range(n_pairs):
        if not pairs_valid[p]:
            continue
        key1 = (int(pairs_hc[p, 0]), int(pairs_hc[p, 1]))
        key2 = (int(pairs_hc[p, 2]), int(pairs_hc[p, 3]))
        for k in (key1, key2):
            if k not in cache:
                cache[k] = op_index(*k)
        i1[p] = cache[key1]
        i2[p] = cache[key2]
    valid = (i1 >= 0) & (i2 >= 0)
    pid = np.minimum(i1, i2) * n_x + np.maximum(i1, i2)
    # first occurrence in (pair-major, voxel) order across the whole
    # candidate: one global unique — which duplicate survives is
    # irrelevant (the rows are identical constraints), only that exactly
    # one does.
    flat_pos = np.where(valid.reshape(-1))[0]
    _, first = np.unique(pid.reshape(-1)[flat_pos], return_index=True)
    keep_flat = np.zeros(n_pairs * n_x, bool)
    keep_flat[flat_pos[first]] = True
    keep = np.zeros((n_pairs, l3, d3, d3), bool)
    keep[:, nz[0], nz[1], nz[2]] = keep_flat.reshape(n_pairs, n_x)
    return keep
