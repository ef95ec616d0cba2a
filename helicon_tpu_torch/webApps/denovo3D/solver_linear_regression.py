"""Facade matching the reference's
``webApps/denovo3D/solver_linear_regression.py``.

The solver lives in ``helicon_tpu_torch.denovo3d``; this module keeps the
reference's import paths and its explicit-system surface:

- ``build_A_data_matrix`` / ``build_A_helical_sym_matrix`` build the
  explicit scipy CSR systems on the host (numpy): an oracle of the
  matrix-free operators, not the path the search runs. They are copies of
  ``helicon_tpu/webApps/denovo3D/solver_linear_regression.py:108`` and
  ``:262``.
- ``refine_tilt_psi_dy`` is the image-level refinement signature on the
  port's Gauss-Newton refiner (``denovo3d.refine``), on the card unless
  the caller asks for the CPU.
- ``sorted_hsym_csym_pairs`` keeps the reference's parameter names
  (twist, rise, csym, nz).
"""

from __future__ import annotations

import numpy as np

from ...denovo3d.geometry import (  # noqa: F401
    select_copies,
    select_pairs,
)
from ...denovo3d.geometry import sorted_hsym_csym_pairs as _sorted_pairs_impl
from ...denovo3d.solver import lsq_reconstruct  # noqa: F401

__all__ = [
    "back_project_2d_coords_to_3d_coords",
    "build_A_data_matrix",
    "build_A_helical_sym_matrix",
    "lsq_reconstruct",
    "refine_tilt_psi_dy",
    "select_copies",
    "select_pairs",
    "sorted_hsym_csym_pairs",
]


def sorted_hsym_csym_pairs(twist, rise, csym, nz):
    """sorted_hsym_csym_pairs with the reference's parameter names:
    ``rise`` is the rise in pixels."""
    return _sorted_pairs_impl(twist, rise, csym, nz)


def back_project_2d_coords_to_3d_coords(
    image,
    scale2d_to_3d,
    reconstruct_diameter_2d_pixel=-1,
    reconstruct_length_2d_pixel=-1,
):
    """The reference's back projection: a numeric R_y(90 deg) rotation,
    whose cos(90) ~ 6e-17 leaves ~1e-15 noise on the integer coordinate
    grid. The library's exact axis swap
    (denovo3d.geometry.back_project_2d_coords_to_3d_coords) is cleaner,
    but int() / round() downstream would then flip at half-integer
    boundaries, so this surface keeps the noisy path bit for bit. Returns ((X, Y, Z) with the helical axis
    first, pixel values of the extracted region)."""
    from scipy.spatial.transform import Rotation as R

    image = np.asarray(image)
    img_ny, img_nx = image.shape
    d2 = (
        int(np.rint(reconstruct_diameter_2d_pixel))
        if reconstruct_diameter_2d_pixel > 0
        else img_ny
    )
    l2 = (
        int(np.rint(reconstruct_length_2d_pixel))
        if reconstruct_length_2d_pixel > 0
        else img_nx
    )
    kk = np.arange(d2, dtype=np.int32) - d2 // 2
    jj_ = np.arange(d2, dtype=np.int32) - d2 // 2
    ii_ = np.arange(l2, dtype=np.int32) - l2 // 2
    pixel_vals = image[np.ix_(jj_ + img_ny // 2, ii_ + img_nx // 2)]
    Zg, Yg, Xg = np.meshgrid(
        kk.astype(np.float32), jj_.astype(np.float32), ii_.astype(np.float32),
        indexing="ij",
    )
    cg = R.from_euler("y", 90, degrees=True).apply(
        np.vstack((Xg.ravel(), Yg.ravel(), Zg.ravel())).T, inverse=True
    )
    if scale2d_to_3d != 1.0:
        cg *= scale2d_to_3d
    X0 = np.swapaxes(cg[:, 0].reshape((d2, d2, l2)), 0, 2)
    Y0 = np.swapaxes(cg[:, 1].reshape((d2, d2, l2)), 0, 2)
    Z0 = np.swapaxes(cg[:, 2].reshape((d2, d2, l2)), 0, 2)
    return (X0, Y0, Z0), pixel_vals


def _cyl_mask_and_index(nz, ny, nx, rmin, rmax):
    from ...core.analysis import get_cylindrical_mask

    mask = np.asarray(
        get_cylindrical_mask(nz=nz, ny=ny, nx=nx, rmin=rmin, rmax=rmax), bool
    )
    n_x = int(np.count_nonzero(mask))
    idx = np.full(mask.shape, -1, np.int64)
    idx[np.nonzero(mask)] = np.arange(n_x)
    return mask, idx, n_x


def build_A_data_matrix(
    image,
    scale2d_to_3d,
    twist_degree,
    rise_pixel,
    csym,
    tilt_degree,
    psi_degree,
    dy_pixel,
    reconstruct_diameter_2d_pixel,
    reconstruct_length_2d_pixel,
    reconstruct_diameter_3d_pixel,
    reconstruct_diameter_3d_inner_pixel,
    reconstruct_length_3d_pixel,
    min_projection_lines,
    interpolation,
    verbose=0,
    cpu=1,
):
    """Explicit sparse data system A x = b.

    Rows are projection lines: for each Halton-ordered symmetry copy and
    2D pixel (line), interpolation weights are summed along the ray.
    Unknowns are the cylindrical-mask voxels. Returns
    (A csr_matrix, b float32, b_pid int32). ``cpu`` is accepted and
    unused.
    """
    from scipy.sparse import csr_matrix, vstack
    from scipy.spatial.transform import Rotation as R

    (X0, Y0, Z0), pixel_vals = back_project_2d_coords_to_3d_coords(
        image=image,
        scale2d_to_3d=scale2d_to_3d,
        reconstruct_diameter_2d_pixel=reconstruct_diameter_2d_pixel,
        reconstruct_length_2d_pixel=reconstruct_length_2d_pixel,
    )
    nz, ny, nx = X0.shape  # helical axis first, like the reference
    l3 = int(reconstruct_length_3d_pixel) if reconstruct_length_3d_pixel > 0 else nz
    rmin = reconstruct_diameter_3d_inner_pixel / 2
    rmax = reconstruct_diameter_3d_pixel // 2 - 1
    mask, midx, n_x = _cyl_mask_and_index(l3, ny, nx, rmin, rmax)
    linear = str(interpolation).startswith("linear")

    coords0 = np.vstack((X0.ravel(), Y0.ravel(), Z0.ravel())).T.astype(np.float64)
    coords0[:, 1] -= dy_pixel
    coords0 = R.from_euler(
        "yx", (tilt_degree, psi_degree), degrees=True
    ).apply(coords0, inverse=True)

    # Halton-ordered copies, identical construction to the reference
    hsym_max = max(1, int(np.ceil(l3 + nz) / 2 / rise_pixel))
    import itertools

    from ...denovo3d.geometry import halton_permutation

    hcs = list(itertools.product(range(-hsym_max, hsym_max + 1), range(csym)))
    hcs.sort(key=lambda x: (abs(x[0]), x[1]))
    hcs = [hcs[int(i)] for i in halton_permutation(len(hcs))]

    line_id = np.repeat(np.arange(nz * ny), nx)  # (k, j) line per sample
    b_line = pixel_vals.T.reshape(-1).astype(np.float32)  # pixel_vals[j, k]
    pid_line = np.arange(nz * ny, dtype=np.int32)  # k * ny + j

    blocks, bs, pids, n_b = [], [], [], 0
    for hi, ci in hcs:
        ang = twist_degree * hi + 360.0 * ci / csym
        c = R.from_euler("z", ang, degrees=True).apply(coords0, inverse=True)
        X = c[:, 0] + nx // 2
        Y = c[:, 1] + ny // 2
        Z = (c[:, 2] - hi * rise_pixel) + l3 // 2

        if linear:
            # the reference truncates toward zero (int(Z)), not floor:
            # samples in (-1, 0) land on voxel 0 with a negative fraction
            # and pass the bounds check. Kept bug for bug.
            zi = np.trunc(Z).astype(np.int64)
            yi = np.trunc(Y).astype(np.int64)
            xi = np.trunc(X).astype(np.int64)
            inb = (
                (zi >= 0) & (zi <= l3 - 2)
                & (yi >= 0) & (yi <= ny - 2)
                & (xi >= 0) & (xi <= nx - 2)
            )
            zc, yc, xc = (np.clip(zi, 0, l3 - 2), np.clip(yi, 0, ny - 2),
                          np.clip(xi, 0, nx - 2))
            ok = inb.copy()
            for dz in (0, 1):
                for dy_ in (0, 1):
                    for dx in (0, 1):
                        ok &= mask[zc + dz, yc + dy_, xc + dx]
            zf, yf, xf = Z - zi, Y - yi, X - xi
            rows_l, cols_l, vals_l = [], [], []
            for dz in (0, 1):
                for dy_ in (0, 1):
                    for dx in (0, 1):
                        w = (
                            (zf if dz else 1 - zf)
                            * (yf if dy_ else 1 - yf)
                            * (xf if dx else 1 - xf)
                        )
                        rows_l.append(line_id[ok])
                        cols_l.append(midx[zc + dz, yc + dy_, xc + dx][ok])
                        vals_l.append(w[ok].astype(np.float32))
            rows = np.concatenate(rows_l)
            cols = np.concatenate(cols_l)
            vals = np.concatenate(vals_l)
            ok_any = ok
        else:
            zi = np.round(Z).astype(np.int64)
            yi = np.round(Y).astype(np.int64)
            xi = np.round(X).astype(np.int64)
            inb = (
                (zi >= 0) & (zi <= l3 - 1)
                & (yi >= 0) & (yi <= ny - 1)
                & (xi >= 0) & (xi <= nx - 1)
            )
            zc, yc, xc = (np.clip(zi, 0, l3 - 1), np.clip(yi, 0, ny - 1),
                          np.clip(xi, 0, nx - 1))
            ok_any = inb & mask[zc, yc, xc]
            rows = line_id[ok_any]
            cols = midx[zc, yc, xc][ok_any]
            vals = np.ones(len(rows), np.float32)

        has_data = np.zeros(nz * ny, bool)
        has_data[np.unique(line_id[ok_any])] = True
        if has_data.any():
            # compress kept lines to consecutive row numbers (k-major)
            row_of_line = np.cumsum(has_data) - 1
            A_blk = csr_matrix(
                (vals, (row_of_line[rows], cols)),
                shape=(int(has_data.sum()), n_x),
                dtype=np.float32,
            )
            blocks.append(A_blk)
            bs.append(b_line[has_data])
            pids.append(pid_line[has_data])
            n_b += int(has_data.sum())
        # the line target is checked after every copy, zero-row ones
        # included, as the reference does
        if min_projection_lines > 0 and n_b > min_projection_lines:
            break

    A = vstack(blocks) if blocks else csr_matrix((0, n_x), dtype=np.float32)
    b = (
        np.concatenate(bs).astype(np.float32)
        if bs
        else np.zeros(0, np.float32)
    )
    b_pid = np.concatenate(pids) if pids else np.zeros(0, np.int32)
    return A, b, b_pid


def build_A_helical_sym_matrix(
    nz: int,
    ny: int,
    nx: int,
    twist_degree: float,
    rise_pixel: float,
    csym: int,
    rmin: float,
    rmax: float,
    min_sym_pairs: int,
    interpolation: str,
    verbose: int = 0,
):
    """Explicit sparse symmetry-pair system: each row constrains
    density(op_i(v)) == density(op_j(v)) for a masked voxel v and an
    angle-sorted, Halton-permuted (op_i, op_j) pair. The nn kernel
    dedups voxel pairs on first occurrence (both orientations), like
    the reference. Returns (A csr or None, b zeros or None).
    """
    from scipy.sparse import csr_matrix, vstack
    from scipy.spatial.transform import Rotation as R

    pairs = sorted_hsym_csym_pairs(twist_degree, rise_pixel, csym, nz)
    mask, midx, n_x = _cyl_mask_and_index(nz, ny, nx, rmin, rmax)
    zz, yy, xx = np.nonzero(mask)
    xyz = np.vstack(
        (
            xx.astype(np.float64) - nx // 2,
            yy.astype(np.float64) - ny // 2,
            zz.astype(np.float64) - nz // 2,
        )
    ).T
    linear = str(interpolation).startswith("linear")

    def op_samples(h, c):
        ang = twist_degree * h + 360.0 * c / csym
        t = R.from_euler("z", ang, degrees=True).apply(xyz, inverse=False)
        return (
            t[:, 0] + nx // 2,
            t[:, 1] + ny // 2,
            t[:, 2] + nz // 2 + rise_pixel * h,
        )

    def nn_index(X, Y, Z):
        zi = np.round(Z).astype(np.int64)
        yi = np.round(Y).astype(np.int64)
        xi = np.round(X).astype(np.int64)
        inb = (
            (zi >= 0) & (zi <= nz - 1)
            & (yi >= 0) & (yi <= ny - 1)
            & (xi >= 0) & (xi <= nx - 1)
        )
        zc = np.clip(zi, 0, nz - 1)
        yc = np.clip(yi, 0, ny - 1)
        xc = np.clip(xi, 0, nx - 1)
        idx = midx[zc, yc, xc]
        return np.where(inb & mask[zc, yc, xc] & (idx >= 0), idx, -1)

    def lin_taps(X, Y, Z):
        zi = np.floor(Z).astype(np.int64)
        yi = np.floor(Y).astype(np.int64)
        xi = np.floor(X).astype(np.int64)
        inb = (
            (zi >= 0) & (zi <= nz - 2)
            & (yi >= 0) & (yi <= ny - 2)
            & (xi >= 0) & (xi <= nx - 2)
        )
        zc = np.clip(zi, 0, nz - 2)
        yc = np.clip(yi, 0, ny - 2)
        xc = np.clip(xi, 0, nx - 2)
        ok = inb.copy()
        cols8, w8 = [], []
        zf, yf, xf = Z - zi, Y - yi, X - xi
        for dz in (0, 1):
            for dy_ in (0, 1):
                for dx in (0, 1):
                    ok &= mask[zc + dz, yc + dy_, xc + dx]
        for dz in (0, 1):
            for dy_ in (0, 1):
                for dx in (0, 1):
                    cols8.append(midx[zc + dz, yc + dy_, xc + dx])
                    if (dz, dy_, dx) == (1, 1, 0):
                        # the reference's own 110-tap expression, kept
                        # bug for bug
                        w8.append(xf * yf * (1 - xf))
                    else:
                        w8.append(
                            (zf if dz else 1 - zf)
                            * (yf if dy_ else 1 - yf)
                            * (xf if dx else 1 - xf)
                        )
        # rounded-voxel index the reference's pair dedup uses; where ok,
        # the rounded
        # corner is one of the 8 mask-checked taps, so midx is valid.
        rz = np.clip(np.round(Z).astype(np.int64), 0, nz - 1)
        ry = np.clip(np.round(Y).astype(np.int64), 0, ny - 1)
        rx = np.clip(np.round(X).astype(np.int64), 0, nx - 1)
        rnd = midx[rz, ry, rx]
        return ok, cols8, w8, (zc, yc, xc), rnd

    def dedup_first(key, seen_keys):
        """First-occurrence indices of ``key`` values not yet in
        ``seen_keys`` (vectorized form of the reference's per-sample
        ``pair_ids`` set).
        Storing both orientations in the reference set makes ordered
        membership equal unordered membership, so callers pass the
        canonical min(i*n+j, j*n+i) key. Returns (fresh unique keys,
        selection indices in original sample order)."""
        uniq, first = np.unique(key, return_index=True)
        if seen_keys.size:
            fresh = ~np.isin(uniq, seen_keys)
            uniq, first = uniq[fresh], first[fresh]
        return uniq, np.sort(first)

    blocks = []
    row_count = 0
    seen_keys = np.zeros(0, np.int64)

    def build_block(p):
        nonlocal seen_keys
        (hi, ci), (hj, cj) = p[-1]
        Xi, Yi, Zi = op_samples(hi, ci)
        Xj, Yj, Zj = op_samples(hj, cj)
        if linear:
            oki, cols_i, w_i, flo_i, rnd_i = lin_taps(Xi, Yi, Zi)
            okj, cols_j, w_j, flo_j, rnd_j = lin_taps(Xj, Yj, Zj)
            ok = oki & okj
            # the reference's separation filter: both sample points must
            # be >= 3 voxels apart on every axis
            ok &= (
                (np.abs(flo_i[0] - flo_j[0]) >= 3)
                & (np.abs(flo_i[1] - flo_j[1]) >= 3)
                & (np.abs(flo_i[2] - flo_j[2]) >= 3)
            )
            idxs = np.nonzero(ok)[0]
            if idxs.size == 0:
                return None
            # rounded-voxel pair dedup across both orientations, global
            # over the pair sequence
            ir = rnd_i[idxs].astype(np.int64)
            jr = rnd_j[idxs].astype(np.int64)
            key = np.minimum(ir * n_x + jr, jr * n_x + ir)
            uniq, first = dedup_first(key, seen_keys)
            if first.size == 0:
                return None
            seen_keys = np.concatenate([seen_keys, uniq])
            sel = idxs[first]
            n_rows = int(sel.size)
            rows = np.arange(n_rows)
            r16, c16, d16 = [], [], []
            for cols, w, sign in ((cols_i, w_i, 1.0), (cols_j, w_j, -1.0)):
                for c8, w8 in zip(cols, w):
                    r16.append(rows)
                    c16.append(c8[sel])
                    d16.append(sign * w8[sel].astype(np.float32))
            A_blk = csr_matrix(
                (
                    np.concatenate(d16),
                    (np.concatenate(r16), np.concatenate(c16)),
                ),
                shape=(n_rows, n_x),
                dtype=np.float32,
            )
        else:
            ii = nn_index(Xi, Yi, Zi)
            jj = nn_index(Xj, Yj, Zj)
            ok = (ii >= 0) & (jj >= 0)
            if not ok.any():
                return None
            ii, jj = ii[ok].astype(np.int64), jj[ok].astype(np.int64)
            # first-occurrence dedup across BOTH orientations, global
            # over the pair sequence (reference nn kernel pair_ids set)
            key = np.minimum(ii * n_x + jj, jj * n_x + ii)
            uniq, sel = dedup_first(key, seen_keys)
            if sel.size == 0:
                return None
            seen_keys = np.concatenate([seen_keys, uniq])
            ii, jj = ii[sel], jj[sel]
            n_rows = len(ii)
            rows = np.arange(n_rows)
            A_blk = csr_matrix(
                (
                    np.concatenate(
                        [np.ones(n_rows, np.float32), -np.ones(n_rows, np.float32)]
                    ),
                    (np.concatenate([rows, rows]), np.concatenate([ii, jj])),
                ),
                shape=(n_rows, n_x),
                dtype=np.float32,
            )
        return A_blk

    for p in pairs:
        A_blk = build_block(p)
        if A_blk is not None:
            blocks.append(A_blk)
            row_count += A_blk.shape[0]
        # stop once the accumulated rows reach the target, checked after
        # every pair, zero-row ones included, as the reference does
        if row_count >= min_sym_pairs:
            break

    if not blocks:
        return None, None
    A = vstack(blocks)
    return A, np.zeros(A.shape[0], np.float32)


def refine_tilt_psi_dy(
    projection_image,
    scale2d_to_3d,
    twist_degree,
    rise_pixel,
    csym,
    reconstruct_diameter_2d_pixel,
    reconstruct_length_2d_pixel,
    reconstruct_diameter_3d_pixel,
    reconstruct_diameter_3d_inner_pixel,
    reconstruct_length_3d_pixel,
    sym_oversample,
    interpolation,
    x_init,
    tilt_0=0.0,
    psi_0=0.0,
    dy_0=0.0,
    delta_tilt=0.5,
    delta_psi=1.0,
    delta_dy=0.2,
    max_iter=5,
    tol_tilt=0.05,
    tol_psi=0.1,
    tol_dy=0.05,
    bounds_tilt=(-30.0, 30.0),
    bounds_psi=(-45.0, 45.0),
    bounds_dy=(-5.0, 5.0),
    positive_constraint=-1,
    algorithm=None,
    verbose=0,
    cpu=1,
    device="cuda",
):
    """The reference's image-level pose refinement on the port's
    Gauss-Newton refiner (``denovo3d.refine``), on ``device`` (the card
    unless the caller asks for "cpu"): the geometry, tables and region as
    lsq_reconstruct derives them (a region that does not fit raises
    HeliconError), (tilt, psi, dy) refined within the
    bounds, then the volume re-solved at the refined pose (B2 when it is
    tilt = psi = 0, the gather projector otherwise). The deltas, the
    tolerances, x_init, verbose and cpu are accepted and unused. Returns
    (tilt, psi, dy, x, score) with x the masked voxels of the volume
    (rec3d[mask], float32 numpy)."""
    from ...denovo3d.solver import _one_candidate, _refine_and_solve

    c = _one_candidate(
        projection_image, scale2d_to_3d, twist_degree, rise_pixel, csym,
        reconstruct_diameter_2d_pixel, reconstruct_length_2d_pixel,
        reconstruct_diameter_3d_pixel, reconstruct_length_3d_pixel,
        reconstruct_diameter_3d_inner_pixel, sym_oversample, algorithm, device,
        interpolation=interpolation, positive_constraint=int(positive_constraint))
    bounds = dict(tilt=tuple(bounds_tilt), psi=tuple(bounds_psi), dy=tuple(bounds_dy),
                  max_iter=int(max_iter))
    # the reference's re-solve keeps nn's duplicate symmetry rows
    out, pose = _refine_and_solve(c, tilt_0, psi_0, dy_0, bounds, sym_dedup=False,
                                  device=device)
    rec3d = out["rec3d"].cpu().numpy()
    return (pose["tilt"], pose["psi"], pose["dy"], rec3d[c.geom.cylindrical_mask()],
            float(out["score"]))
