"""Geometry of one search, frozen: sizes, masks, candidate grids and the
symmetry copy, pair and op tables.

A copy of what the port computes on the host before a search (its
``denovo3d/geometry.py``, the size bookkeeping of ``denovo3d/pipeline.py``
and the table builders of ``denovo3d/grid.py``), kept here so that the
reference works every table out again and a later change of the program
cannot move the yardstick. numpy only.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np


def set_to_periodic_range(v: float, lo: float = -180, hi: float = 180) -> float:
    if lo <= v <= hi:
        return v
    tmp = math.fmod(v - lo, hi - lo)
    return tmp + (lo if tmp >= 0 else hi)


def build_candidate_grid(twist_min, twist_max, twist_step, rise_min, rise_max, rise_step,
                         handedness="both", tube_length=math.inf):
    """(twists, rises) float32 of a grid, with the degenerate candidates
    dropped and a single twist given the hand asked for."""
    if handedness.startswith("left") and twist_max == twist_min:
        twists = [-abs(twist_max)]
    elif handedness.startswith("right") and twist_max == twist_min:
        twists = [abs(twist_max)]
    elif twist_min < twist_max:
        twists = np.arange(twist_min, twist_max + twist_step / 2, twist_step)
    else:
        twists = [twist_min]
    if rise_min < rise_max:
        rises = np.arange(rise_min, rise_max + rise_step / 2, rise_step)
    else:
        rises = [rise_min]
    out_t, out_r = [], []
    for t in twists:
        t = round(set_to_periodic_range(float(t)), 6)
        for r in rises:
            if abs(t) < 0.01 or abs(r) < 0.01 or abs(r) >= tube_length / 2:
                continue
            out_t.append(t)
            out_r.append(float(r))
    return np.asarray(out_t, np.float32), np.asarray(out_r, np.float32)


@functools.lru_cache(maxsize=4096)
def halton_permutation(n: int) -> np.ndarray:
    """Indices from an unscrambled base-2 Halton sequence (may repeat)."""
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    from scipy.stats import qmc

    h = qmc.Halton(d=1, scramble=False)
    return h.integers(l_bounds=0, u_bounds=n, n=n).ravel().astype(np.int64)


def cylindrical_mask(nz, ny, nx, rmin=0, rmax=-1) -> np.ndarray:
    k = np.arange(nz, dtype=np.int32) - nz // 2
    j = np.arange(ny, dtype=np.int32) - ny // 2
    i = np.arange(nx, dtype=np.int32) - nx // 2
    _, Y, X = np.meshgrid(k, j, i, indexing="ij")
    if rmax < 0:
        rmax = ny // 2 - 1
    mask = X * X + Y * Y < rmax * rmax
    if 0 < rmin < rmax:
        mask &= X * X + Y * Y >= rmin * rmin
    return mask


def pair_hmax(nz: int, rise_pixel: float) -> int:
    return max(1, int(np.ceil(nz / (2 * rise_pixel))))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Sizes in pixels: the 2D region (d2 rows, l2 columns) and the volume
    (l3, d3, d3)."""

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

    def mask(self) -> np.ndarray:
        return cylindrical_mask(self.l3, self.d3, self.d3, self.rmin, self.rmax)

    def cell_valid_mask(self) -> np.ndarray:
        """A cell is valid where all eight of its corners are in the mask."""
        m = self.mask()
        c = m[:-1, :-1, :-1].copy()
        for dz, dy, dx in itertools.product((0, 1), repeat=3):
            c &= m[dz:dz + m.shape[0] - 1, dy:dy + m.shape[1] - 1, dx:dx + m.shape[2] - 1]
        out = np.zeros_like(m)
        out[:-1, :-1, :-1] = c
        return out

    def hsym_max_data(self, rise_pixel: float) -> int:
        return max(1, int((self.l3 + self.l2) / 2 / rise_pixel))

    def hsym_max_pairs(self, rise_pixel: float) -> int:
        return pair_hmax(self.l3, rise_pixel)


def task_sizes(data_shape, apix, rise, rise_range, tilt_range, tube_length, tube_diameter,
               tube_diameter_inner, reconstruct_length, target_apix2d, target_apix3d):
    """The search's physical sizes (the tube diameter is given)."""
    ny, nx = data_shape
    if tube_length < 0:
        if tube_diameter > ny * apix / 2:
            tube_length = int(nx * apix)
        else:
            tube_length = round(np.sqrt((nx * apix) ** 2 / 4 - tube_diameter ** 2 / 4) * 2)
    diameter = tube_diameter if 0 < tube_diameter < ny * apix else ny * apix
    inner = tube_diameter_inner if 0 < tube_diameter_inner < diameter else 0
    if reconstruct_length < rise:
        reconstruct_length = max(
            min(3 * np.max(rise_range), tube_length),
            round(np.tan(np.deg2rad(np.max(np.abs(tilt_range)))) * tube_diameter * 3))
    if target_apix2d < apix:
        target_apix2d = apix
    return dict(tube_length=tube_length, reconstruct_diameter=diameter,
                reconstruct_diameter_inner=inner, reconstruct_length=reconstruct_length,
                target_apix2d=target_apix2d, target_apix3d=target_apix3d)


def pixel_sizes(g, data_shape, rise):
    ny, nx = data_shape
    a2, a3 = g["target_apix2d"], g["target_apix3d"]
    if a3 < 0:
        vol = (g["reconstruct_length"] * (g["reconstruct_diameter"] ** 2
                                          - g["reconstruct_diameter_inner"] ** 2) / 4 * np.pi)
        a3 = max(a2, round(np.power(vol / (nx * ny), 1 / 3) + 0.5))
    elif a3 == 0:
        a3 = a2
    d3 = int(round(g["reconstruct_diameter"] / a3))
    d3 += d3 % 2
    d3_inner = int(round(g["reconstruct_diameter_inner"] / a3))
    d2 = int(round(g["reconstruct_diameter"] / a2))
    d2 += d2 % 2
    l2a = g["tube_length"] if 0 < g["tube_length"] < nx * a2 else nx * a2
    l2 = int(l2a / a2)
    l2 += l2 % 2
    if g["reconstruct_length"] > 0:
        l3 = max(int(np.ceil(rise / a3)), int(np.ceil(g["reconstruct_length"] / a3)))
    else:
        l3 = int(l2 * a2 / a3 + 0.5)
    l3 += l3 % 2
    return dict(d2=d2, l2=l2, d3=d3, l3=l3, d3_inner=d3_inner, target_apix2d=a2,
                target_apix3d=a3)


def auto_sym_oversample(l3, d3, d3_inner):
    ratio = 2 ** 20 / max(1, l3 * (d3 ** 2 - d3_inner ** 2))
    if ratio < 10:
        return max(1, int(round(ratio)))
    if ratio < 100:
        return max(1, int(round(ratio / 10)) * 10)
    return max(1, int(round(ratio / 100)) * 100)


def select_copies(geom: Geometry, rise_pixel: float, n_copies: int):
    """(h, c, valid) of the candidate's projection copies: sorted by
    (|h|, c), Halton-permuted, padded or cut to n_copies."""
    hmax = geom.hsym_max_data(rise_pixel)
    hcs = list(itertools.product(range(-hmax, hmax + 1), range(geom.csym)))
    hcs.sort(key=lambda x: (abs(x[0]), x[1]))
    hcs = [hcs[int(i)] for i in halton_permutation(len(hcs))]
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
    hs = np.arange(-hmax, hmax + 1)
    H, C = np.meshgrid(hs, np.arange(csym), indexing="ij")
    H, C = H.ravel(), C.ravel()
    i1, i2 = np.triu_indices(len(H), k=1)
    h1, c1, h2, c2 = H[i1], C[i1], H[i2], C[i2]
    return h1, c1, h2, c2, np.abs(h2), np.abs(h1), np.abs(h1 - h2), np.abs(h1 + h2)


@functools.lru_cache(maxsize=512)
def _pair_table_hm(twist: float, hmax: int, csym: int) -> np.ndarray:
    h1, c1, h2, c2, ah2, ah1, ahd, ahs = _pair_combinatorics(hmax, csym)
    a1 = twist * h1 + c1 * 360.0 / csym
    a2 = twist * h2 + c2 * 360.0 / csym
    angle = np.round(np.abs((a2 - a1 + 180.0) % 360.0 - 180.0), 2)
    order = np.lexsort((ah2, ah1, ahd, ahs, angle))
    sel = order[halton_permutation(len(order))]
    out = np.stack([h1[sel], c1[sel], h2[sel], c2[sel]], axis=1).astype(np.int32)
    out.flags.writeable = False
    return out


def pair_table(twist: float, rise_pixel: float, csym: int, nz: int) -> np.ndarray:
    """Rows [h1, c1, h2, c2] of the op pairs, sorted by angle and
    Halton-permuted."""
    return _pair_table_hm(twist, pair_hmax(nz, rise_pixel), csym)


def select_pair_ops(geom: Geometry, twist, rise_pixel, n_pairs, n_ops):
    """The pairs through a table of distinct ops: (ops_hc (n_ops, 2),
    ops_valid, pair_idx (n_pairs, 2), pairs_valid)."""
    t = pair_table(twist, rise_pixel, geom.csym, geom.l3)[:n_pairs]
    ops_hc = np.zeros((n_ops, 2), np.int32)
    ops_valid = np.zeros(n_ops, bool)
    pair_idx = np.zeros((n_pairs, 2), np.int32)
    pairs_valid = np.zeros(n_pairs, bool)
    index = {}
    for i, row in enumerate(t):
        ids, ok = [], True
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


def copy_pair_counts(geom: Geometry, rise_min, sym_oversample, rise_max,
                     max_equations=2 ** 26):
    """(n_copies, n_pairs) sized for the grid's worst candidate from the
    equation budget."""
    n2d = geom.d2 * geom.l2
    n3d = int(geom.mask().sum())
    l3 = max(1, geom.l3)
    target = min(max_equations, int(max(n2d, n3d) * max(1, sym_oversample)))
    hmax = geom.hsym_max_data(rise_min)
    total = (2 * hmax + 1) * geom.csym
    acc, n_copies = 0.0, 0
    for k in range(2 * hmax + 1):
        h = (k + 1) // 2 * (1 if k % 2 else -1) if k else 0
        n_copies += geom.csym
        acc += geom.csym * n2d * max(0.05, 1.0 - abs(h) * rise_max / l3)
        if acc >= target:
            break
    n_copies = min(max(2, n_copies + 1), total)
    hmax_p = geom.hsym_max_pairs(rise_min)
    n_ops = (2 * hmax_p + 1) * geom.csym
    h1, _, h2, _, *_ = _pair_combinatorics(hmax_p, geom.csym)
    zero = np.zeros_like(h1)
    span = np.maximum.reduce([h1, h2, zero]) - np.minimum.reduce([h1, h2, zero])
    mean_fill = float(np.mean(np.maximum(0.05, 1.0 - span * rise_max / l3)))
    n_pairs = int(np.ceil(target / max(1, n3d) / mean_fill)) + 1
    n_pairs = min(n_pairs, n_ops * (n_ops - 1) // 2)
    return max(1, n_copies), max(1, n_pairs)


def n_pair_ops(geom: Geometry, rise_min) -> int:
    return (2 * geom.hsym_max_pairs(rise_min) + 1) * geom.csym


def candidate_tables(geom, twist, rise, n_copies, n_pairs, n_ops):
    """One candidate's copies (h, c, valid), its pairs as [h1, c1, h2, c2]
    rows with their validity, and its op table (ops_hc, ops_valid,
    pair_idx)."""
    ch, cc, cv = select_copies(geom, float(rise), n_copies)
    ops_hc, ops_v, pair_idx, pv = select_pair_ops(geom, float(twist), float(rise), n_pairs,
                                                   n_ops)
    phc = np.concatenate([ops_hc[pair_idx[:, 0]], ops_hc[pair_idx[:, 1]]], axis=1)
    return dict(ch=ch, cc=cc, cv=cv, phc=phc, pv=pv, ops_hc=ops_hc, ops_v=ops_v,
                pair_idx=pair_idx)


def group_tables(geom, twist, rises_pixel, n_copies, n_pairs, n_ops):
    """One twist group's canonical copy table (ch_u, cc_u (C_u,)), each
    candidate's multiplicity m (R, C_u) over it, and its pair table as op
    indices (pair_idx (R, n_pairs, 2), pairs_valid). C_u is the width of
    the group's own union of copies: the search's wider table only adds
    copies of multiplicity 0, which add nothing."""
    R = len(rises_pixel)
    csym = geom.csym
    sels = [select_copies(geom, float(r), n_copies) for r in rises_pixel]
    union = set()
    for ch, cc, cv in sels:
        union.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    keys = sorted(union, key=lambda x: (abs(x[0]), x[0], x[1]))
    C_u = len(keys)
    col = {k: i for i, k in enumerate(keys)}
    ch_u = np.zeros(C_u, np.int32)
    cc_u = np.zeros(C_u, np.int32)
    for (h, c), i in col.items():
        ch_u[i], cc_u[i] = h, c
    m = np.zeros((R, C_u), np.float32)
    for ri, (ch, cc, cv) in enumerate(sels):
        for h, c in zip(ch[cv].tolist(), cc[cv].tolist()):
            m[ri, col[(h, c)]] += 1.0
    hmax_p = (n_ops // csym - 1) // 2
    pidx = np.zeros((R, n_pairs, 2), np.int32)
    pval = np.zeros((R, n_pairs), bool)
    for ri, r in enumerate(rises_pixel):
        t = pair_table(float(twist), float(r), csym, geom.l3)[:n_pairs]
        if len(t):
            pidx[ri, :len(t), 0] = (t[:, 0] + hmax_p) * csym + t[:, 1]
            pidx[ri, :len(t), 1] = (t[:, 2] + hmax_p) * csym + t[:, 3]
            pval[ri, :len(t)] = True
    if len(keys) and (pidx.min() < 0 or pidx.max() >= n_ops):
        raise ValueError("op table too small")
    return ch_u, cc_u, m, pidx, pval


def positive(positive_constraint, rises_pixel, twist, l3) -> np.ndarray:
    """Per candidate: the box [0, max b] (True) or none."""
    if positive_constraint > 0:
        return np.ones(len(rises_pixel), bool)
    if positive_constraint < 0:
        pitch = np.round(np.asarray(rises_pixel, np.float32) * np.float32(360.0)
                         / np.abs(np.float32(twist)))
        return pitch > 2 * l3
    return np.zeros(len(rises_pixel), bool)


def sym_dedup_mask(geom: Geometry, twist, rise_pixel, pairs_hc, pairs_valid):
    """(n_pairs, l3, d3, d3) bool: each voxel-pair constraint kept at its
    first occurrence in the pair list (nearest-neighbour only)."""
    l3, d3 = geom.l3, geom.d3
    mask = geom.mask()
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
        zi = np.round(Z0 + h * rise_pixel + l3 // 2).astype(np.int64)
        yi = np.round(X0 * sn + Y0 * cs + d3 // 2).astype(np.int64)
        xi = np.round(X0 * cs - Y0 * sn + d3 // 2).astype(np.int64)
        inb = (zi >= 0) & (zi < l3) & (yi >= 0) & (yi < d3) & (xi >= 0) & (xi < d3)
        idx = np.full(n_x, -1, np.int64)
        ib = np.where(inb)[0]
        idx[ib] = nz_idx[zi[ib], yi[ib], xi[ib]]
        return idx

    n_pairs = len(pairs_hc)
    cache = {}
    i1 = np.full((n_pairs, n_x), -1, np.int64)
    i2 = np.full((n_pairs, n_x), -1, np.int64)
    for p in range(n_pairs):
        if not pairs_valid[p]:
            continue
        k1 = (int(pairs_hc[p, 0]), int(pairs_hc[p, 1]))
        k2 = (int(pairs_hc[p, 2]), int(pairs_hc[p, 3]))
        for k in (k1, k2):
            if k not in cache:
                cache[k] = op_index(*k)
        i1[p], i2[p] = cache[k1], cache[k2]
    valid = (i1 >= 0) & (i2 >= 0)
    pid = np.minimum(i1, i2) * n_x + np.maximum(i1, i2)
    flat_pos = np.where(valid.reshape(-1))[0]
    _, first = np.unique(pid.reshape(-1)[flat_pos], return_index=True)
    keep_flat = np.zeros(n_pairs * n_x, bool)
    keep_flat[flat_pos[first]] = True
    keep = np.zeros((n_pairs, l3, d3, d3), bool)
    keep[:, nz[0], nz[1], nz[2]] = keep_flat.reshape(n_pairs, n_x)
    return keep
