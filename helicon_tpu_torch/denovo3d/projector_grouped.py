"""Twist-grouped separable operators: one Wsum/Mxy set per twist.

Counterpart of ``helicon_tpu/denovo3d/projector_grouped.py``. Every large
operator tensor of the separable formulation depends on the in-plane
rotation angles only (twist * h + 360 c / csym), while the rise enters
through the small z-interpolation matrices. A group of R same-twist
candidates therefore shares one stacked operand A_top = [Wsum; Mxy]
(rows x d3^2), and each candidate carries only small tensors.

Candidates select different Halton copy lists, so copies live in a
canonical (h, c) table with per-candidate multiplicities m; scaling a
candidate's z-factor and data rows by sqrt(m) reproduces duplicated rows
exactly (A'^T A' = A^T M A, A'^T b' = A^T M b).

The reference vmaps one candidate; here the group axis R is a batch axis
of every per-candidate tensor. Only A_top takes the compute dtype (bf16 on
the card: its nn entries are small integer counts and 0/1, exact in bf16);
the per-candidate tensors and the rhs stay float32 (linear weights are
not exact in bf16: ROADMAP C7). The reference's XLA
path also rounds the sqrt(m)-weighted z-factors and the rhs's
intermediates to the compute dtype; on the amyloid golden that rounding
alone moves the bf16 top-1 from 4.75 to 4.9 A. The fused normal operator ``NTN`` is the
plain matvec of ``group_solve`` on this group's kernel inputs, so the
invariant NTN == PTP + ST(S(.)) checks the kernel's plain version too.
"""

from __future__ import annotations

import torch

from .projector_separable import (
    _as,
    _mm,
    _linear_plane_ok,
    _op_angles,
    _z_interp_matrix,
    make_copy_wsum,
    op_xy_matrices,
)

__all__ = [
    "build_group_shared",
    "build_candidate_problem_grouped",
    "build_candidate_tensors_grouped",
    "reproject_grouped",
]


def build_group_shared(
    geom,
    twist_degree,
    copies_h_u,
    copies_c_u,
    ops_h_u,
    ops_c_u,
    dy_pixel=0.0,
    interpolation: str = "nn",
    mask=None,
    cellok=None,
    compute_dtype=None,
    device="cuda",
):
    """The twist-only tensors shared by every candidate of a group, on
    ``device``.

    copies_h_u/copies_c_u (C_u,): the group's canonical copy table;
    ops_h_u/ops_c_u (O,): the canonical symmetry-op enumeration.
    ``Wsum`` and ``Mxy_ops`` are views into ``A_top`` (one copy in
    memory, in the compute dtype). mask (numpy or a tensor already on
    ``device``) and cellok (numpy) are the geometry's cylindrical and
    cell-valid masks.
    """
    linear = interpolation.startswith("linear")
    d2, d3 = geom.d2, geom.d3
    d3sq = d3 * d3
    cdt = compute_dtype or torch.float32
    dev = torch.device(device)
    mask_t = _as(mask, dev, torch.bool)
    if linear:
        plane_ok_flat = _as(_linear_plane_ok(cellok, geom.l3).reshape(-1), dev, torch.float32)
    else:
        plane_ok_flat = mask_t.any(dim=0).reshape(-1).to(torch.float32)
    twist = _as(twist_degree, dev, torch.float32)
    ch_u = _as(copies_h_u, dev)
    oh_u = _as(ops_h_u, dev)

    theta_u = _op_angles(twist, ch_u, _as(copies_c_u, dev), geom.csym)
    Wsum_u = make_copy_wsum(
        d2, d3, geom.scale2d_to_3d, dy_pixel, linear, plane_ok_flat
    )(theta_u)  # (C_u, d2, d3^2) f32
    # row j of copy k is valid iff its Wsum row deposits weight
    xy_any_u = Wsum_u.sum(dim=2) > 0
    Mxy_u, xy_ok_u = op_xy_matrices(
        twist, oh_u, _as(ops_c_u, dev), geom.csym, d3, plane_ok_flat, linear
    )
    C_u, O = Wsum_u.shape[0], Mxy_u.shape[0]
    A_top = torch.empty((C_u * d2 + O * d3sq, d3sq), dtype=cdt, device=dev)
    A_top[: C_u * d2] = Wsum_u.reshape(-1, d3sq)
    A_top[C_u * d2 :] = Mxy_u.reshape(-1, d3sq)
    return dict(
        Wsum=A_top[: C_u * d2].view(C_u, d2, d3sq),
        A_top=A_top,
        xy_any=xy_any_u,
        Mxy_ops=A_top[C_u * d2 :].view(O, d3sq, d3sq),
        xy_ok_ops=xy_ok_u,  # (O, d3^2) bool
        mask_f=mask_t.to(torch.float32),
        linear=linear,
        cdt=cdt,
        copies_h_u=ch_u,
        ops_h_u=oh_u,
    )


def _data_factors(shared, geom, rise_pixels, sqrt_m):
    """The data rows' per-candidate factors of a group (leading axis R):
    the sqrt(m)-weighted z-factor Mz_w (R, C_u, l2, l3) and the binary row
    validity rowv_bin (R, C_u, l2, d2). shared needs Wsum, copies_h_u,
    xy_any and linear."""
    l2, l3 = geom.l2, geom.l3
    dev = shared["Wsum"].device
    rise = _as(rise_pixels, dev, torch.float32)  # (R,)
    sqrt_m = _as(sqrt_m, dev, torch.float32)  # (R, C_u)
    h_u = shared["copies_h_u"].float()
    ic = torch.arange(l2, dtype=torch.float32, device=dev) - l2 // 2
    dz_u = h_u[None] * rise[:, None]  # (R, C_u)
    Mz_raw = _z_interp_matrix(
        geom.scale2d_to_3d * ic - dz_u[..., None] + l3 // 2, l3, shared["linear"]
    )  # (R, C_u, l2, l3)
    z_ok = Mz_raw.sum(dim=3) > 0  # (R, C_u, l2)
    sel = sqrt_m > 0
    rowv_bin = (
        z_ok[..., None] & shared["xy_any"][None, :, None, :] & sel[..., None, None]
    ).to(torch.float32)  # (R, C_u, l2, d2)
    return dict(Mz_w=Mz_raw * sqrt_m[..., None, None], rowv_bin=rowv_bin, sqrt_m=sqrt_m,
                rise=rise)


def _candidate_factors(shared, geom, rise_pixels, sqrt_m, pair_idx, pairs_valid):
    """Batched per-candidate factors of a group (leading axis R)."""
    l3 = geom.l3
    linear = shared["linear"]
    dev = shared["A_top"].device
    pair_idx = _as(pair_idx, dev).long()  # (R, P, 2)
    pv = _as(pairs_valid, dev, torch.bool)  # (R, P)
    ops_h = shared["ops_h_u"].float()
    O = ops_h.shape[0]
    df = _data_factors(shared, geom, rise_pixels, sqrt_m)
    Mz_w, rowv_bin, sqrt_m, rise = df["Mz_w"], df["rowv_bin"], df["sqrt_m"], df["rise"]
    # z-Gram per copy carries the multiplicity weight m = sqrt_m^2
    Gz = torch.einsum("rcim,rcin->rcmn", Mz_w, Mz_w)  # (R, C_u, l3, l3)

    z_pos0 = torch.arange(l3, dtype=torch.float32, device=dev)
    Mz_ops = _z_interp_matrix(
        z_pos0 + ops_h[None, :, None] * rise[:, None, None], l3, linear
    )  # (R, O, l3, l3)
    z_ok_ops = Mz_ops.sum(dim=3) > 0  # (R, O, l3)
    a_f = (z_ok_ops[..., None] & shared["xy_ok_ops"][None, :, None, :]).to(
        torch.float32
    )  # (R, O, l3, d3^2)
    # symmetric pair-count matrix: Cn[o, o'] = valid pairs joining o, o'
    oi = torch.nn.functional.one_hot(pair_idx[..., 0], O).float()
    oj = torch.nn.functional.one_hot(pair_idx[..., 1], O).float()
    Cn = torch.einsum("rpo,rpq->roq", oi, pv.float()[..., None] * oj)
    Cn = Cn + Cn.transpose(1, 2)
    deg = torch.einsum("roq,rqmd->romd", Cn, a_f)
    return dict(
        Mz_w=Mz_w, Gz=Gz, Mz_ops=Mz_ops, z_ok_ops=z_ok_ops, a_f=a_f, Cn=Cn,
        deg=deg, rowv_bin=rowv_bin, sqrt_m=sqrt_m, pair_idx=pair_idx, pv=pv,
    )


def _projections(shared, f, l3, d3):
    """Batched sqrt(m)-weighted P and its transpose over x (R, l3, d3, d3)."""
    Wsum = shared["Wsum"]

    def P(x):
        tmp = _mm("cjd,rmd->rcjm", Wsum, x.reshape(x.shape[0], l3, d3 * d3))
        return _mm("rcim,rcjm->rcij", f["Mz_w"], tmp)  # (R, C_u, l2, d2)

    def PT(r):
        tmp = _mm("rcim,rcij->rcjm", f["Mz_w"], r)  # (R, C_u, d2, l3)
        return _mm("cjd,rcjm->rmd", Wsum, tmp).reshape(-1, l3, d3, d3)

    return P, PT


def build_candidate_problem_grouped(
    shared, geom, image_region, rise_pixels, sqrt_m, pair_idx, pairs_valid
):
    """Per-group closures over the shared tensors, batched over the R
    candidates: rise_pixels (R,), sqrt_m (R, C_u), pair_idx (R, P, 2),
    pairs_valid (R, P). Every closure maps (R, l3, d3, d3) volumes.

    Returns (ops, rowv_bin): P (and so PT/PTP/NTN and the rhs) carries the
    sqrt(m) row weighting; callers mask predictions with the binary
    rowv_bin and weight b with ops["row_valid"] = rowv_bin * sqrt_m.
    """
    from .group_solve import group_inputs, matvec_reference

    l3, d3 = geom.l3, geom.d3
    d3sq = d3 * d3
    f = _candidate_factors(shared, geom, rise_pixels, sqrt_m, pair_idx, pairs_valid)
    P, PT = _projections(shared, f, l3, d3)
    Wsum, Mxy = shared["Wsum"], shared["Mxy_ops"]
    R = f["Gz"].shape[0]

    def PTP(x):
        t = _mm("cjd,rmd->rcjm", Wsum, x.reshape(R, l3, d3sq))
        u = torch.einsum("rcjm,rcmn->rcjn", t, f["Gz"])
        return _mm("rcjm,cjd->rmd", u, Wsum).reshape(R, l3, d3, d3)

    mask_b = shared["mask_f"].reshape(l3, d3sq) > 0.5
    op_ok = f["z_ok_ops"][..., None] & shared["xy_ok_ops"][None, :, None, :]
    p0, p1 = f["pair_idx"][..., 0], f["pair_idx"][..., 1]
    ridx = torch.arange(R, device=p0.device)[:, None]
    pair_ok = (
        op_ok[ridx, p0] & op_ok[ridx, p1] & mask_b & f["pv"][..., None, None]
    ).to(torch.float32)  # (R, P, l3, d3^2)

    def S(x):
        tmp = _mm("opd,rmd->ropm", Mxy, x.reshape(R, l3, d3sq))
        vals = torch.einsum("romn,ropn->romp", f["Mz_ops"], tmp)  # (R, O, l3, d3^2)
        out = (vals[ridx, p0] - vals[ridx, p1]) * pair_ok
        return out.reshape(R, -1, l3, d3, d3)

    def ST(r):
        rv = r.reshape(pair_ok.shape) * pair_ok
        O = Mxy.shape[0]
        ct = torch.zeros((R, O, l3, d3sq), dtype=torch.float32, device=rv.device)
        ct.scatter_add_(1, p0[..., None, None].expand_as(rv), rv)
        ct.scatter_add_(1, p1[..., None, None].expand_as(rv), -rv)
        tmp = torch.einsum("romn,romp->ropn", f["Mz_ops"], ct)
        return _mm("opd,ropn->rnd", Mxy, tmp).reshape(R, l3, d3, d3)

    inp = group_inputs(shared, f)

    def NTN(x):
        X = x.reshape(1, R, l3, d3sq).float()
        return matvec_reference(inp, X, masked=False).reshape(R, l3, d3, d3)

    b = _as(image_region, shared["A_top"].device, torch.float32).T
    ops = dict(
        P=P, PT=PT, PTP=PTP, NTN=NTN, S=S, ST=ST, b=b,
        row_valid=f["rowv_bin"] * f["sqrt_m"][..., None, None],
        mask=shared["mask_f"] > 0.5,
    )
    return ops, f["rowv_bin"]


def build_candidate_tensors_grouped(
    shared, geom, image_region, rise_pixels, sqrt_m, pair_idx, pairs_valid, pid_mask=None
):
    """The per-candidate tensors of the grouped solve, batched over R:
    the fused matvec's factors plus the rhs, the box bound and |b|. The
    rhs goes through the same weighted P^T as the closures.

    pid_mask (l2, d2) 0/1 (optional): a data-row pixel-id split (the fsc
    half-set weighting). The z-Gram then depends on the in-copy column j,
        Gz[r, c, m, n, j] = sum_i w[i, j] Mz_w[r, c, i, m] Mz_w[r, c, i, n],
    and the rhs and |b| are taken on the masked rows; the box bound stays
    the full rows' (the halves reuse the full ub)."""
    l3, d3 = geom.l3, geom.d3
    dev = shared["A_top"].device
    f = _candidate_factors(shared, geom, rise_pixels, sqrt_m, pair_idx, pairs_valid)
    _, PT = _projections(shared, f, l3, d3)
    b = _as(image_region, dev, torch.float32).T  # (l2, d2)
    b_eff = b * (f["rowv_bin"] * f["sqrt_m"][..., None, None])  # (R, C_u, l2, d2)
    gz = f["Gz"]
    if pid_mask is not None:
        w = _as(pid_mask, dev, torch.float32).reshape(geom.l2, geom.d2)
        b_eff = b_eff * w
        gz = torch.einsum("rcim,rcin,ij->rcmnj", f["Mz_w"], f["Mz_w"], w)
    rhs = (PT(b_eff) * shared["mask_f"]).reshape(-1, l3, d3 * d3)
    return dict(
        Gz=gz,
        Mz_ops=f["Mz_ops"],
        a_f=f["a_f"],
        Cn=f["Cn"],
        deg=f["deg"],
        rhs=rhs,
        # box upper bound from the UNweighted rows (duplicates cannot
        # change a max); b_norm pairs with the weighted rows (cosine)
        ub_raw=(b * f["rowv_bin"]).amax(dim=(1, 2, 3)),
        b_norm=torch.sqrt((b_eff * b_eff).sum(dim=(1, 2, 3))),
    )


def reproject_grouped(shared, geom, rise_pixels, sqrt_m, x):
    """The sqrt(m)-weighted reprojection P(x) (R, C_u, l2, d2) of the R
    candidates' volumes x (R, l3, d3^2), with the binary row validity
    rowv_bin and the weighted one (rowv_bin * sqrt(m)), each (R, C_u, l2,
    d2). shared needs Wsum (C_u, d2, d3^2), copies_h_u, xy_any and linear:
    what scoring a solved group needs of build_group_shared."""
    df = _data_factors(shared, geom, rise_pixels, sqrt_m)
    P, _ = _projections(shared, df, geom.l3, geom.d3)
    rowv_bin = df["rowv_bin"]
    return P(x), rowv_bin, rowv_bin * df["sqrt_m"][..., None, None]
