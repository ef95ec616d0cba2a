"""The separable operators of a search (tilt = psi = 0), frozen.

A copy of the port's plain builds (``denovo3d/projector_separable.py`` and
``denovo3d/projector_grouped.py``): each symmetry copy of the projection
is a z-interpolation matrix Mz (l2, l3) times an in-plane matrix Wsum
(d2, d3^2) summed over the ray; each symmetry op a z-shift (l3, l3) times
an in-plane rotation Mxy (d3^2, d3^2). A twist group shares the stacked
operand A_top = [Wsum; Mxy] over a canonical copy table, each candidate
weighting its copies by their multiplicity m. Everything is float32.
"""

from __future__ import annotations

import numpy as np
import torch


def z_interp(z_pos: torch.Tensor, l3: int, linear: bool) -> torch.Tensor:
    """(..., n, l3): 2-tap floor/ceil weights (linear) or the rounded
    index (nn), zero where the sample leaves the volume."""
    cols = torch.arange(l3, device=z_pos.device)
    if linear:
        zf = torch.floor(z_pos)
        zi = zf.to(torch.int64)[..., None]
        wz = (z_pos - zf)[..., None]
        ok = (zi >= 0) & (zi <= l3 - 2)
        return ((cols == zi) * (1.0 - wz) + (cols == zi + 1) * wz) * ok
    zi = torch.round(z_pos).to(torch.int64)[..., None]
    ok = (zi >= 0) & (zi <= l3 - 1)
    return ((cols == zi) & ok).to(torch.float32)


def angles(twist, h, c, csym: int) -> torch.Tensor:
    return torch.deg2rad(twist * h.float() + 360.0 * c.float() / csym)


def wsum(theta, d2, d3, s, linear, plane_ok_flat) -> torch.Tensor:
    """(C, d2, d3^2): each ray's samples deposited in the in-plane cells
    (the nearest valid cell, or the bilinear weights of a valid base
    cell), summed over the ray."""
    dev = plane_ok_flat.device
    plane_ok = plane_ok_flat > 0.5
    jc = torch.arange(d2, dtype=torch.float32, device=dev) - d2 // 2
    k_ray = torch.arange(-(d2 // 2), d2 - d2 // 2, dtype=torch.float32, device=dev)
    cs, sn = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    y0 = (s * jc)[None, :, None]
    X = y0 * sn + d3 // 2 + k_ray * (-s * cs)
    Y = y0 * cs + d3 // 2 + k_ray * (s * sn)
    shape = (theta.shape[0], d2, d3 * d3)
    if not linear:
        xi, yi = torch.round(X).to(torch.int64), torch.round(Y).to(torch.int64)
        inb = (xi >= 0) & (xi <= d3 - 1) & (yi >= 0) & (yi <= d3 - 1)
        idx = yi.clamp(0, d3 - 1) * d3 + xi.clamp(0, d3 - 1)
        ok = inb & plane_ok[idx]
        return torch.zeros(shape, device=dev).scatter_add_(2, idx, ok.to(torch.float32))
    xi, yi = torch.floor(X).to(torch.int64), torch.floor(Y).to(torch.int64)
    inb = (xi >= 0) & (xi <= d3 - 2) & (yi >= 0) & (yi <= d3 - 2)
    xi, yi = xi.clamp(0, d3 - 2), yi.clamp(0, d3 - 2)
    ok = (inb & plane_ok[yi * d3 + xi]).to(torch.float32)
    W = torch.zeros(shape, dtype=torch.float64, device=dev)
    for oy in (0, 1):
        wy = torch.clamp_min(1.0 - torch.abs(Y - (yi + oy)), 0.0)
        for ox in (0, 1):
            wx = torch.clamp_min(1.0 - torch.abs(X - (xi + ox)), 0.0)
            W.scatter_add_(2, (yi + oy) * d3 + xi + ox, (wx * wy * ok).double())
    return W.float()


def op_xy(twist, ops_h, ops_c, csym, d3, plane_ok_flat, linear):
    """(O, d3^2, d3^2) in-plane matrices of the symmetry ops and their
    per-cell validity (O, d3^2)."""
    th = angles(twist, ops_h, ops_c, csym)
    cs, sn = torch.cos(th)[..., None], torch.sin(th)[..., None]
    ax = torch.arange(d3, dtype=torch.float32, device=th.device) - d3 // 2
    pX, pY = ax.repeat(d3)[None], ax.repeat_interleave(d3)[None]
    X = (pX * cs - pY * sn) + d3 // 2
    Y = (pX * sn + pY * cs) + d3 // 2
    cols = torch.arange(d3 * d3, device=X.device)
    if linear:
        xf, yf = torch.floor(X), torch.floor(Y)
        wx, wy = (X - xf)[..., None], (Y - yf)[..., None]
        xi, yi = xf.to(torch.int64), yf.to(torch.int64)
        inb = (xi >= 0) & (xi <= d3 - 2) & (yi >= 0) & (yi <= d3 - 2)
        base = (yi.clamp(0, d3 - 2) * d3 + xi.clamp(0, d3 - 2))[..., None]
        ok = inb.to(torch.float32) * plane_ok_flat[base[..., 0]]
        m = ((cols == base) * (1 - wy) * (1 - wx) + (cols == base + 1) * (1 - wy) * wx
             + (cols == base + d3) * wy * (1 - wx) + (cols == base + d3 + 1) * wy * wx)
        return m * ok[..., None], ok > 0
    xi, yi = torch.round(X).to(torch.int64), torch.round(Y).to(torch.int64)
    inb = (xi >= 0) & (xi <= d3 - 1) & (yi >= 0) & (yi <= d3 - 1)
    idx = yi.clamp(0, d3 - 1) * d3 + xi.clamp(0, d3 - 1)
    ok = inb & (plane_ok_flat[idx] > 0.5)
    return ((cols == idx[..., None]) & ok[..., None]).to(torch.float32), ok


def plane_ok(geom, linear, device) -> torch.Tensor:
    """The in-plane cross-section a sample's cell is tested against: the
    mask's (nn) or the cell-valid mask's over the base planes (linear)."""
    if linear:
        p = np.asarray(geom.cell_valid_mask(), bool)[:max(1, geom.l3 - 1)].any(axis=0)
    else:
        p = geom.mask().any(axis=0)
    return torch.as_tensor(p.reshape(-1), dtype=torch.float32, device=device)


def group_operators(geom, twist, ch_u, cc_u, m, pidx, pval, rises_pixel, n_ops, linear, b,
                    device, operand=None):
    """One twist group's solve inputs: A_top (rows, d3^2), and per
    candidate Gz (R, C_u, l3, l3), Mz_ops (R, O, l3, l3), a_f and deg (R,
    O, l3, d3^2), Cn (R, O, O), rhs (R, l3, d3^2), b_norm, ub_raw (R,),
    with the mask (l3, d3^2). b is the image region (l2, d2) on device.
    operand, where given, rounds A_top as stored; the rhs is taken through
    the stored operand, as the program takes it."""
    d2, l2, d3, l3, csym = geom.d2, geom.l2, geom.d3, geom.l3, geom.csym
    d3sq = d3 * d3
    hmax_p = (n_ops // csym - 1) // 2
    ops_h = torch.as_tensor(np.repeat(np.arange(-hmax_p, hmax_p + 1), csym), device=device)
    ops_c = torch.as_tensor(np.tile(np.arange(csym), 2 * hmax_p + 1), device=device)
    pok = plane_ok(geom, linear, device)
    tw = torch.tensor(float(twist), device=device)
    ch = torch.as_tensor(ch_u, device=device)
    W = wsum(angles(tw, ch, torch.as_tensor(cc_u, device=device), csym), d2, d3,
             geom.scale2d_to_3d, linear, pok)  # (C_u, d2, d3^2)
    xy_any = W.sum(dim=2) > 0
    Mxy, xy_ok = op_xy(tw, ops_h, ops_c, csym, d3, pok, linear)
    A_top = torch.cat([W.reshape(-1, d3sq), Mxy.reshape(-1, d3sq)])
    if operand is not None:
        A_top = operand(A_top)

    rise = torch.as_tensor(np.asarray(rises_pixel, np.float32), device=device)
    sqrt_m = torch.sqrt(torch.as_tensor(m, device=device))
    ic = torch.arange(l2, dtype=torch.float32, device=device) - l2 // 2
    dz = ch.float()[None] * rise[:, None]
    Mz = z_interp(geom.scale2d_to_3d * ic - dz[..., None] + l3 // 2, l3, linear)
    rowv = ((Mz.sum(dim=3) > 0)[..., None] & xy_any[None, :, None, :]
            & (sqrt_m > 0)[..., None, None]).to(torch.float32)  # (R, C_u, l2, d2)
    Mz_w = Mz * sqrt_m[..., None, None]
    Gz = torch.einsum("rcim,rcin->rcmn", Mz_w, Mz_w)
    z0 = torch.arange(l3, dtype=torch.float32, device=device)
    Mz_ops = z_interp(z0 + ops_h.float()[None, :, None] * rise[:, None, None], l3, linear)
    a_f = ((Mz_ops.sum(dim=3) > 0)[..., None] & xy_ok[None, :, None, :]).to(torch.float32)
    pi = torch.as_tensor(pidx, device=device).long()
    pv = torch.as_tensor(pval, device=device).float()
    oi = torch.nn.functional.one_hot(pi[..., 0], n_ops).float()
    oj = torch.nn.functional.one_hot(pi[..., 1], n_ops).float()
    Cn = torch.einsum("rpo,rpq->roq", oi, pv[..., None] * oj)
    Cn = Cn + Cn.transpose(1, 2)
    deg = torch.einsum("roq,rqmd->romd", Cn, a_f)
    mask = torch.as_tensor(geom.mask(), dtype=torch.float32, device=device).reshape(l3, d3sq)
    b_eff = b * rowv * sqrt_m[..., None, None]
    tmp = torch.einsum("rcim,rcij->rcjm", Mz_w, b_eff)
    rhs = torch.einsum("cjd,rcjm->rmd", A_top[:W.shape[0] * d2].reshape(W.shape), tmp) * mask
    return dict(A_top=A_top, Gz=Gz, Mz_ops=Mz_ops, a_f=a_f, Cn=Cn, deg=deg, mask=mask,
                rhs=rhs, b_norm=torch.sqrt((b_eff * b_eff).sum(dim=(1, 2, 3))),
                ub_raw=(b * rowv).amax(dim=(1, 2, 3)), d2=d2)


def candidate_operators(geom, twist, rise_pixel, tabs, keep, linear, b, device):
    """One candidate's dense separable inputs: the operand [W2; Mxy]
    (rows, d3^2), the z-Gram per copy (C, l3, l3), the pair fold b1 (P*l3,
    O*l3), the pair validity pok (P*l3, d3^2), the mask, rhs (l3, d3^2),
    ub (max of the valid rows of b). keep: the nn dedup mask or None."""
    d2, l2, d3, l3, csym = geom.d2, geom.l2, geom.d3, geom.l3, geom.csym
    d3sq = d3 * d3
    pok_plane = plane_ok(geom, linear, device)
    tw = torch.tensor(float(twist), device=device)
    rise = float(rise_pixel)
    ch = torch.as_tensor(tabs["ch"], device=device)
    cvf = torch.as_tensor(tabs["cv"], device=device).float()
    ic = torch.arange(l2, dtype=torch.float32, device=device) - l2 // 2
    Mz = z_interp(geom.scale2d_to_3d * ic[None] - (ch.float() * rise)[:, None] + l3 // 2,
                  l3, linear) * cvf[:, None, None]  # (C, l2, l3)
    Gz = torch.einsum("cim,cin->cmn", Mz, Mz)
    W = wsum(angles(tw, ch, torch.as_tensor(tabs["cc"], device=device), csym), d2, d3,
             geom.scale2d_to_3d, linear, pok_plane) * cvf[:, None, None]
    xy_any = (W.sum(dim=2) > 0) & (cvf > 0)[:, None]
    ops_hc = torch.as_tensor(tabs["ops_hc"], device=device)
    Mxy, xy_ok = op_xy(tw, ops_hc[:, 0], ops_hc[:, 1], csym, d3, pok_plane, linear)
    O = ops_hc.shape[0]
    z0 = torch.arange(l3, dtype=torch.float32, device=device)
    Mz_ops = z_interp(z0[None] + ops_hc[:, :1].float() * rise, l3, linear)  # (O, l3, l3)
    op_ok = ((Mz_ops.sum(dim=2) > 0)[..., None] & xy_ok[:, None, :]
             & torch.as_tensor(tabs["ops_v"], device=device)[:, None, None])
    pidx = torch.as_tensor(tabs["pair_idx"], device=device).long()
    p0, p1 = pidx[:, 0], pidx[:, 1]
    mask = torch.as_tensor(geom.mask(), dtype=torch.float32, device=device).reshape(l3, d3sq)
    pair_ok = (op_ok[p0] & op_ok[p1] & (mask > 0.5)
               & torch.as_tensor(tabs["pv"], device=device)[:, None, None])
    if keep is not None:
        pair_ok = pair_ok & torch.as_tensor(keep, device=device).reshape(len(p0), l3, d3sq)
    de = (torch.nn.functional.one_hot(p0, O).float()
          - torch.nn.functional.one_hot(p1, O).float())  # (P, O)
    b1 = torch.einsum("po,omn->pmon", de, Mz_ops).reshape(len(p0) * l3, O * l3)
    rowv = ((Mz.sum(dim=2) > 0)[:, :, None] & xy_any[:, None, :]).to(torch.float32)
    b_eff = b[None] * rowv  # (C, l2, d2)
    tmp = torch.einsum("cim,cij->cjm", Mz, b_eff)
    rhs = torch.einsum("cjd,cjm->md", W, tmp) * mask
    return dict(A=torch.cat([W.reshape(-1, d3sq), Mxy.reshape(-1, d3sq)]), Gz=Gz, b1=b1,
                pok=pair_ok.float().reshape(-1, d3sq), mask=mask, rhs=rhs,
                ub=b_eff.amax(), nd=W.shape[0] * d2, C=W.shape[0], d2=d2)
