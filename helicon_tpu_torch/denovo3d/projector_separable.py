"""Separable projection/symmetry operators (tilt = psi = 0).

Counterpart of ``helicon_tpu/denovo3d/projector_separable.py``. With no
out-of-plane tilt or in-plane psi, one symmetry copy of the projection
operator factorizes into two small dense products:

    P_t(x)[i, j] = (Mz_t @ X @ Wsum_t^T)[i, j],  X = x as (l3, d3*d3)

with Mz_t (l2, l3) the z-interpolation matrix and Wsum_t (d2, d3*d3) the
in-plane matrix summed over the ray. The symmetry ops factorize the same
way: a z-shift (l3, l3) times an in-plane rotation (d3^2, d3^2).

The port covers nearest-neighbour and linear interpolation (1-tap round,
or 2-tap floor/ceil along z and 4-tap bilinear in-plane, valid where the
base cell is in the cell-valid mask). The symmetry operator takes the
reference's two forms: dense op matrices wherever ``pair_ops`` is given
(B2 solves on them; the reference also caps them at 32 MB, a TPU memory
rule the port does not keep) or, without pair_ops, the per-pair gathers
of ``projector.sym_operator``; both give the same rows. The reference's
vjp closures ``PT`` and ``ST`` are written here as explicit transposes
of ``P`` and ``S``. ``build_problems_separable`` builds k candidates of
one table shape together (the per-candidate path's launches).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_problem_separable", "build_problems_separable", "make_copy_wsum",
           "plane_shift_tables", "cos_sin"]


def cos_sin(theta: torch.Tensor):
    """float32 cos and sin of the angles theta, the one place the port's
    projectors evaluate them. XLA's and PyTorch's float32 cos / sin differ
    by one unit in the last place on some angles (neither rounds
    correctly); where a sample then sits half-way between two voxels the
    two packages round it apart (ROADMAP C11)."""
    return torch.cos(theta), torch.sin(theta)


def _mm(eq: str, *ops) -> torch.Tensor:
    """einsum with float32 accumulation (inputs of the compute dtype are
    widened exactly, as ``preferred_element_type=float32``)."""
    return torch.einsum(eq, *(o.float() for o in ops))


def _z_interp_matrix(z_pos: torch.Tensor, l3: int, linear: bool) -> torch.Tensor:
    """(..., n_z_out, l3) interpolation matrix for positions z_pos.

    linear: 2-tap floor/ceil weights, valid when the floor lies in
    [0, l3-2]; nn: 1-tap round, valid when the rounded index lies in
    [0, l3-1]."""
    cols = torch.arange(l3, device=z_pos.device)
    if linear:
        zf = torch.floor(z_pos)
        zi = zf.to(torch.int64)[..., None]
        wz = (z_pos - zf)[..., None]
        ok = (zi >= 0) & (zi <= l3 - 2)
        m = (cols == zi) * (1.0 - wz) + (cols == zi + 1) * wz
        return m * ok
    zi = torch.round(z_pos).to(torch.int64)[..., None]
    ok = (zi >= 0) & (zi <= l3 - 1)
    return ((cols == zi) & ok).to(torch.float32)


def plane_shift_tables(plane_ok_2d: np.ndarray) -> dict:
    """Statically shifted copies of the in-plane validity cross-section
    (the reference's base-cell lookup of its linear receiving-cell Wsum;
    the port's scatter form reads the base cell directly)."""
    d3 = plane_ok_2d.shape[0]
    tbl = {}
    for oy in (0, 1):
        for ox in (0, 1):
            sh = np.zeros((d3, d3), np.float32)
            sh[oy:, ox:] = plane_ok_2d[: d3 - oy, : d3 - ox]
            tbl[(oy, ox)] = sh.reshape(-1)
    return tbl


def make_copy_wsum(
    d2: int,
    d3: int,
    s: float,
    dy_pixel,
    linear: bool,
    plane_ok_flat: torch.Tensor,
):
    """Wsum builder. Returns ``wsum_of_theta(th)``: for angles th (C,),
    the (C, d2, d3*d3) in-plane deposit matrices summed over the ray
    parameter, without the copy-validity factor.

    Each ray sample k of row j sits at C_j + k * D (|D| = s). nn: it
    deposits 1 in the nearest cell if that cell is in the mask. linear: it
    deposits the bilinear weights max(0, 1 - |X - gx|) max(0, 1 - |Y - gy|)
    in the four cells of its base cell (floor X, floor Y) if the base cell
    is valid. The reference evaluates the same sums per receiving cell over
    a window of k around the cell's projection (TPU scatters serialize);
    both visit the same samples with the same coordinates and weights.
    """
    dev = plane_ok_flat.device
    plane_ok = plane_ok_flat > 0.5
    jc_rows = torch.arange(d2, dtype=torch.float32, device=dev) - d2 // 2
    k_ray = torch.arange(-(d2 // 2), d2 - d2 // 2, dtype=torch.float32, device=dev)

    def wsum_of_theta(th: torch.Tensor) -> torch.Tensor:
        cs, sn = cos_sin(th)
        cs, sn = cs[:, None, None], sn[:, None, None]
        dx, dy_ = -s * cs, s * sn
        y0j = (s * jc_rows - dy_pixel)[None, :, None]  # (1, d2, 1)
        cx = y0j * sn + d3 // 2  # (C, d2, 1) X at k = 0
        cy = y0j * cs + d3 // 2
        X = cx + k_ray * dx  # (C, d2, d2) sample positions
        Y = cy + k_ray * dy_
        shape = (th.shape[0], d2, d3 * d3)
        if not linear:
            xi = torch.round(X).to(torch.int64)
            yi = torch.round(Y).to(torch.int64)
            inb = (xi >= 0) & (xi <= d3 - 1) & (yi >= 0) & (yi <= d3 - 1)
            idx = yi.clamp(0, d3 - 1) * d3 + xi.clamp(0, d3 - 1)
            ok = inb & plane_ok[idx]
            Wsum = torch.zeros(shape, dtype=torch.float32, device=dev)
            return Wsum.scatter_add_(2, idx, ok.to(torch.float32))
        xi = torch.floor(X).to(torch.int64)
        yi = torch.floor(Y).to(torch.int64)
        inb = (xi >= 0) & (xi <= d3 - 2) & (yi >= 0) & (yi <= d3 - 2)
        xi, yi = xi.clamp(0, d3 - 2), yi.clamp(0, d3 - 2)
        ok = (inb & plane_ok[yi * d3 + xi]).to(torch.float32)
        # the float32 weights summed in float64, where the few per cell add
        # exactly: the sum does not depend on the order of the device's
        # atomic adds, so the build (and a bf16 rounding of it) repeats
        W64 = torch.zeros(shape, dtype=torch.float64, device=dev)
        for oy in (0, 1):
            wy = torch.clamp_min(1.0 - torch.abs(Y - (yi + oy)), 0.0)
            for ox in (0, 1):
                wx = torch.clamp_min(1.0 - torch.abs(X - (xi + ox)), 0.0)
                W64.scatter_add_(2, (yi + oy) * d3 + xi + ox, (wx * wy * ok).double())
        return W64.float()

    return wsum_of_theta


def _xy_interp_matrix(X, Y, d3: int, plane_ok_flat: torch.Tensor, linear: bool):
    """(..., n_pts, d3*d3) in-plane interpolation matrix at (X, Y), and the
    per-point validity (..., n_pts). plane_ok_flat is the cross-section of
    the mask (nn) or of the cell-valid mask (linear: the base cell's test)."""
    cols = torch.arange(d3 * d3, device=X.device)
    if linear:
        xf, yf = torch.floor(X), torch.floor(Y)
        wx, wy = (X - xf)[..., None], (Y - yf)[..., None]
        xi, yi = xf.to(torch.int64), yf.to(torch.int64)
        inb = (xi >= 0) & (xi <= d3 - 2) & (yi >= 0) & (yi <= d3 - 2)
        base = (yi.clamp(0, d3 - 2) * d3 + xi.clamp(0, d3 - 2))[..., None]
        ok = inb.to(torch.float32) * plane_ok_flat[base[..., 0]]
        m = (
            (cols == base) * (1 - wy) * (1 - wx)
            + (cols == base + 1) * (1 - wy) * wx
            + (cols == base + d3) * wy * (1 - wx)
            + (cols == base + d3 + 1) * wy * wx
        )
        return m * ok[..., None], ok > 0
    xi = torch.round(X).to(torch.int64)
    yi = torch.round(Y).to(torch.int64)
    inb = (xi >= 0) & (xi <= d3 - 1) & (yi >= 0) & (yi <= d3 - 1)
    idx = yi.clamp(0, d3 - 1) * d3 + xi.clamp(0, d3 - 1)
    ok = inb & (plane_ok_flat[idx] > 0.5)
    return ((cols == idx[..., None]) & ok[..., None]).to(torch.float32), ok


def _op_angles(twist_degree, h, c, csym: int) -> torch.Tensor:
    """Rotation angle (radians) of symmetry op / copy (h, c)."""
    return torch.deg2rad(twist_degree * h.float() + 360.0 * c.float() / csym)


def op_xy_matrices(twist_degree, ops_h, ops_c, csym, d3, plane_ok_flat, linear):
    """In-plane matrices (..., O, d3^2, d3^2) of the symmetry ops (ops_h,
    ops_c (..., O)) and their per-cell validity (..., O, d3^2)."""
    th = _op_angles(twist_degree, ops_h, ops_c, csym)
    cs, sn = cos_sin(th)
    cs, sn = cs[..., None], sn[..., None]
    ax = torch.arange(d3, dtype=torch.float32, device=th.device) - d3 // 2
    pX0 = ax.repeat(d3)[None]
    pY0 = ax.repeat_interleave(d3)[None]
    Xp = (pX0 * cs - pY0 * sn) + d3 // 2
    Yp = (pX0 * sn + pY0 * cs) + d3 // 2
    return _xy_interp_matrix(Xp, Yp, d3, plane_ok_flat, linear)


def _linear_plane_ok(cellok, l3: int) -> np.ndarray:
    """(d3, d3) in-plane validity cross-section a linear sample's base cell
    is tested against: the cell-valid mask over the planes a base cell can
    take (nn reads the mask's cross-section; both are z-independent inside
    the volume)."""
    return np.asarray(cellok, bool)[: max(1, l3 - 1)].any(axis=0)


def _as(x, device, dtype=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


# float32 bytes of the build's per-copy and per-op matrices (W2, Mxy) that
# build_problems_separable holds at once: past it, it builds them a few
# candidates at a time straight into the operand
BUILD_CHUNK_BYTES = 4 << 30


def _lead(a):
    """A table with a leading candidate axis of one."""
    return a[None] if isinstance(a, torch.Tensor) else np.asarray(a)[None]


def build_problem_separable(
    geom,
    image_region,
    twist_degree,
    rise_pixel,
    copies_h,
    copies_c,
    copies_valid,
    pairs_hc,
    pairs_valid,
    dy_pixel=0.0,
    interpolation: str = "nn",
    mask=None,
    cellok=None,
    compute_dtype=None,
    pair_ops=None,
    sym_keep=None,
    device="cuda",
):
    """Assemble (P, PT, PTP, S, ST, b, row_valid, mask[, factors]) for
    one candidate on ``device``: build_problems_separable for one.

    pair_ops: optional (ops_hc [O, 2], ops_valid [O], pair_idx [P, 2])
    from geometry.select_pair_ops. With it the symmetry operator is dense
    (the distinct ops' matrices, and ``factors``: the tensors the closures
    close over, the inputs of ``candidate_solve``); without it, the
    per-pair gathers of ``projector.sym_operator`` on pairs_hc. sym_keep:
    optional (P, l3, d3, d3) bool from geometry.compute_sym_dedup_mask.
    """
    ops = build_problems_separable(
        geom, image_region, _lead(twist_degree), _lead(rise_pixel), *map(_lead, (
            copies_h, copies_c, copies_valid, pairs_hc, pairs_valid)),
        dy_pixel, interpolation, mask, cellok, compute_dtype,
        pair_ops=None if pair_ops is None else tuple(map(_lead, pair_ops)),
        sym_keep=None if sym_keep is None else _lead(sym_keep), device=device,
    )

    def one(f):
        return lambda t: f(t[None])[0]

    out = {n: one(ops[n]) for n in ("P", "PT", "PTP", "S", "ST")}
    out.update(b=ops["b"], row_valid=ops["row_valid"][0], mask=ops["mask"])
    if "factors" in ops:
        out["factors"] = {n: t if n in SHARED_FACTORS else t[0]
                          for n, t in ops["factors"].items()}
    return out


# the factors every candidate of a batch shares
SHARED_FACTORS = ("mask", "plane_ok")


def build_problems_separable(
    geom,
    image_region,
    twists,
    rises_pixel,
    copies_h,
    copies_c,
    copies_valid,
    pairs_hc,
    pairs_valid,
    dy_pixel=0.0,
    interpolation: str = "nn",
    mask=None,
    cellok=None,
    compute_dtype=None,
    pair_ops=None,
    sym_keep=None,
    device="cuda",
):
    """The separable operators of k candidates of one table shape, built
    together on ``device``. Every table carries a leading candidate axis:
    twists, rises_pixel (k,), copies (k, C), pairs_hc (k, P, 4),
    pairs_valid (k, P), pair_ops ((k, O, 2), (k, O), (k, P, 2)), sym_keep
    (k, P, l3, d3, d3).

    The closures map batches: P(x (k, l3, d3, d3)) -> (k, C, l2, d2), PT
    the reverse, PTP, S(x) -> (k, P, l3, d3, d3), ST the reverse;
    row_valid is (k, C, l2, d2); b (l2, d2) and mask (l3, d3, d3) are
    shared. With pair_ops the symmetry operator is dense and ``factors``
    holds the batch's tensors with a leading k (but SHARED_FACTORS), the
    reference's factors; ``a_top`` is B2's operand [W2; Mxy] (k, C*d2 +
    O*d3^2, d3^2) in the compute dtype, of which the factors' Wsum and
    Mxy_ops are views; its float32 build runs BUILD_CHUNK_BYTES at a
    time. Without pair_ops, S and ST are
    the per-pair gathers of ``projector.sym_operator``, a candidate at a
    time.
    """
    linear = interpolation.startswith("linear")
    d2, l2, d3, l3 = geom.d2, geom.l2, geom.d3, geom.l3
    d3sq = d3 * d3
    s = geom.scale2d_to_3d
    cdt = compute_dtype or torch.float32
    dev = torch.device(device)

    mask_np = np.asarray(mask, bool)
    plane_ok = _linear_plane_ok(cellok, l3) if linear else mask_np.any(axis=0)
    plane_ok_flat = _as(plane_ok.reshape(-1), dev, torch.float32)
    mask_f = _as(mask_np, dev, torch.float32)
    twist = _as(twists, dev, torch.float32)  # (k,)
    rise = _as(rises_pixel, dev, torch.float32)
    ch = _as(copies_h, dev)  # (k, C)
    cc = _as(copies_c, dev)
    cv = _as(copies_valid, dev, torch.bool)
    k, C = ch.shape

    # --- per-copy factors: Mz (k, C, l2, l3), the z-Gram, row validity
    theta = _op_angles(twist[:, None], ch, cc, geom.csym)  # (k, C)
    dz = ch.float() * rise[:, None]
    cvf = cv.float()
    ic = torch.arange(l2, dtype=torch.float32, device=dev) - l2 // 2
    Mz = (_z_interp_matrix(s * ic - dz[..., None] + l3 // 2, l3, linear)
          * cvf[..., None, None])
    Mz_c = Mz.to(cdt)
    Gz = _mm("kcim,kcin->kcmn", Mz_c, Mz_c).to(cdt)  # (k, C, l3, l3) z-Gram

    dense = pair_ops is not None
    if dense:
        ops_hc, ops_valid, pair_idx = (_as(a, dev) for a in pair_ops)
        O = ops_hc.shape[1]
    else:
        O = 0
    # W2 = Wsum (C*d2 rows) and, dense, the op matrices Mxy (O*d3^2 rows),
    # built in the compute dtype a chunk of candidates at a time
    a_top = torch.empty((k, C * d2 + O * d3sq, d3sq), dtype=cdt, device=dev)
    Wsum_c = a_top[:, : C * d2].view(k, C, d2, d3sq)
    Mxy_c = a_top[:, C * d2 :].view(k, O, d3sq, d3sq)
    xy_any = torch.empty((k, C, d2), dtype=torch.bool, device=dev)
    xy_ok_ops = torch.empty((k, O, d3sq), dtype=torch.bool, device=dev)
    wsum_of_theta = make_copy_wsum(d2, d3, s, dy_pixel, linear, plane_ok_flat)
    step = max(1, BUILD_CHUNK_BYTES // (16 * max(C * d2, O * d3sq) * d3sq))
    for a in range(0, k, step):
        sl = slice(a, min(a + step, k))
        W = wsum_of_theta(theta[sl].reshape(-1)).reshape(-1, C, d2, d3sq)
        W *= cvf[sl, :, None, None]
        xy_any[sl] = (W.sum(dim=3) > 0) & cv[sl, :, None]
        Wsum_c[sl] = W
        del W
        if dense:
            M, xy_ok_ops[sl] = op_xy_matrices(
                twist[sl, None], ops_hc[sl, :, 0], ops_hc[sl, :, 1], geom.csym, d3,
                plane_ok_flat, linear)
            Mxy_c[sl] = M
            del M
    z_ok = Mz.sum(dim=3) > 0  # (k, C, l2)
    row_valid = z_ok[..., None] & xy_any[:, :, None, :] & cv[:, :, None, None]

    def X2(x_vol):
        return x_vol.reshape(-1, l3, d3sq).to(cdt)

    def PTP(x_vol):
        """P^T P x in one pass through the z-Gram."""
        t = _mm("kcjd,kmd->kcjm", Wsum_c, X2(x_vol)).to(cdt)
        u = _mm("kcjm,kcmn->kcjn", t, Gz).to(cdt)
        return _mm("kcjm,kcjd->kmd", u, Wsum_c).reshape(-1, l3, d3, d3)

    def P(x_vol):
        tmp = _mm("kcjd,kmd->kcjm", Wsum_c, X2(x_vol)).to(cdt)
        return _mm("kcim,kcjm->kcij", Mz_c, tmp)  # (k, C, l2, d2)

    def PT(r):
        tmp = _mm("kcim,kcij->kcjm", Mz_c, r).to(cdt)
        return _mm("kcjd,kcjm->kmd", Wsum_c, tmp).reshape(-1, l3, d3, d3)

    ops = dict(
        P=P,
        PT=PT,
        PTP=PTP,
        b=_as(image_region, dev, torch.float32).T,
        row_valid=row_valid,
        mask=mask_f > 0.5,
    )
    if not dense:
        from .projector import sym_operator

        cellok_flat = _as(np.asarray(cellok, np.float32).reshape(-1), dev)
        sym = [sym_operator(geom, twist[i], rise[i], pairs_hc[i], pairs_valid[i], interpolation,
                            mask_f.reshape(-1), cellok_flat,
                            sym_keep=None if sym_keep is None else sym_keep[i])
               for i in range(k)]
        ops["S"], ops["ST"] = (
            (lambda t, j=j: torch.stack([f[j](ti) for f, ti in zip(sym, t)])) for j in (0, 1))
        return ops

    # --- symmetry pairs through the distinct ops -----------------------
    ops_valid = ops_valid.to(torch.bool)
    z_pos0 = torch.arange(l3, dtype=torch.float32, device=dev)
    Mz_ops = _z_interp_matrix(z_pos0 + ops_hc[..., :1].float() * rise[:, None, None], l3,
                              linear)  # (k, O, l3, l3)
    z_ok_ops = Mz_ops.sum(dim=3) > 0
    Mz_ops = Mz_ops.to(cdt)
    op_ok = (z_ok_ops[..., None] & xy_ok_ops[:, :, None, :]).reshape(k, O, l3, d3, d3)
    op_ok = op_ok & ops_valid[..., None, None, None]
    kk = torch.arange(k, device=dev)[:, None]
    p0, p1 = pair_idx[..., 0].long(), pair_idx[..., 1].long()  # (k, P)
    pair_ok = (
        op_ok[kk, p0] & op_ok[kk, p1] & (mask_f > 0.5)
        & _as(pairs_valid, dev, torch.bool)[..., None, None, None]
    )
    if sym_keep is not None:
        pair_ok = pair_ok & _as(sym_keep, dev, torch.bool)
    pair_ok_f = pair_ok.to(torch.float32)  # (k, P, l3, d3, d3)
    flat0, flat1 = ((kk * O + p).reshape(-1) for p in (p0, p1))

    def S(x_vol):
        tmp = _mm("kopd,kmd->kopm", Mxy_c, X2(x_vol)).to(cdt)
        vals = _mm("komn,kopn->komp", Mz_ops, tmp).reshape(-1, O, l3, d3, d3)
        return (vals[kk, p0] - vals[kk, p1]) * pair_ok_f

    def ST(r):
        rv = (r * pair_ok_f).reshape(-1, l3, d3sq)
        ct = torch.zeros((k * O, l3, d3sq), dtype=torch.float32, device=dev)
        ct.index_add_(0, flat0, rv)
        ct.index_add_(0, flat1, -rv)
        tmp = _mm("komn,komp->kopn", Mz_ops, ct.reshape(k, O, l3, d3sq)).to(cdt)
        return _mm("kopd,kopn->knd", Mxy_c, tmp).reshape(-1, l3, d3, d3)

    ops.update(
        S=S,
        ST=ST,
        a_top=a_top,  # (k, C*d2 + O*d3^2, d3^2) compute dtype: [W2; Mxy]
        factors=dict(
            Wsum=Wsum_c,  # (k, C, d2, d3^2) compute dtype, a view of a_top
            Gz=Gz,  # (k, C, l3, l3) z-Gram per copy, compute dtype
            Mz=Mz,  # (k, C, l2, l3) float32 z-interpolation per copy
            Mz_ops=Mz_ops,  # (k, O, l3, l3) compute dtype
            Mxy_ops=Mxy_c,  # (k, O, d3^2, d3^2) compute dtype, a view of a_top
            pair_idx=pair_idx,  # (k, P, 2)
            pair_ok=pair_ok_f,  # (k, P, l3, d3, d3) float32
            mask=mask_f,  # (l3, d3, d3) float32
            plane_ok=plane_ok_flat,  # (d3^2,) float32 in-plane cell mask
        ),
    )
    return ops
