"""Matrix-free bounded least-squares solve for one denovo3D candidate.

Counterpart of ``helicon_tpu/denovo3d/solver.py`` for what the grid
search's best-volume re-solve runs on the separable operators (tilt = psi
= 0): CG on the normal equations, then FISTA with the box [0, max b] or
unbounded, for the models lsq, lreg (the centre-voxel seed of an all-zero
fit), ridge, lasso and elasticnet (l2 in every matvec, l1 in the prox,
the alpha-decay retry of an all-zero fit); the score metrics cosine,
ssim, ms_ssim, mutual_information and composite (``_candidate_score``,
which the grouped scorer of ``grid`` shares); the thresh clip of the
prediction; the fsc half-set splits of modes 1-4 (mode 1 draws JAX's
permutation through ``_jax_random``). The power iteration is seeded from
ones, as the reference's XLA path. The grouped scoring solve lives in
``group_solve``, the fused single-candidate solve in
``candidate_solve``. Both interpolations are ported.

ard (ROADMAP A7) raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SolveConfig", "SCORE_METRICS", "regularization_from_algorithm", "solve_candidate"]

SCORE_METRICS = ("cosine", "ssim", "ms_ssim", "mutual_information", "composite")
MODELS = ("lsq", "lreg", "ridge", "lasso", "elasticnet")


def regularization_from_algorithm(algorithm: dict, n_rows: int):
    """(l1_reg, l2_reg) matching the sklearn objectives of the reference
    solver zoo: lasso/elasticnet scale alpha by the equation count;
    ridge does not."""
    model = algorithm.get("model", "lsq")
    l1 = l2 = 0.0
    if model in ("lasso", "elasticnet"):
        alpha = float(algorithm.get("alpha", 1e-4))
        l1_ratio = 1.0 if model == "lasso" else float(algorithm.get("l1_ratio", 0.5))
        l1 = alpha * l1_ratio * n_rows
        l2 = alpha * (1.0 - l1_ratio) * n_rows
    elif model == "ridge":
        l2 = float(algorithm.get("alpha", 1.0))
    return l1, l2


class SolveConfig(NamedTuple):
    """Solver configuration (the reference's fields)."""

    interpolation: str = "nn"
    model: str = "lsq"
    cg_iters: int = 120
    fista_iters: int = 120
    power_iters: int = 8
    fsc_test: int = 0
    score_metric: str = "cosine"
    thresh_fraction: float = -1.0
    positive_constraint: int = -1
    l2_reg: float = 0.0
    l1_reg: float = 0.0
    separable: bool = False
    compute_dtype: str = "float32"
    reg_per_row: bool = False
    ard_iters: int = 12
    ard_probes: int = 4
    ard_prior: float = 1e-6


def check_in_slice(cfg: SolveConfig, grouped: bool = False) -> None:
    """Raise for every configuration the port does not cover yet
    (NotImplementedError naming its ROADMAP item), and for an unknown score
    metric (ValueError, as the reference). ``grouped``: the grid search's
    grouped scorer, where fsc rides the kernel only with lsq + cosine and
    no thresh clip, as the reference's kernel does (its grid.py:590-608);
    the single-candidate solve takes fsc with every model."""
    if cfg.score_metric not in SCORE_METRICS:
        raise ValueError(f"Unknown score_metric {cfg.score_metric!r}; supported: {SCORE_METRICS}")
    bad = []
    if not cfg.separable:
        bad.append("tilt or psi != 0 (ROADMAP A7)")
    if not cfg.interpolation.startswith(("nn", "linear")):
        bad.append(f"interpolation={cfg.interpolation!r}")
    if cfg.model == "ard":
        bad.append("model='ard' (ROADMAP A7)")
    elif cfg.model not in MODELS:
        bad.append(f"model={cfg.model!r}")
    if grouped and cfg.fsc_test:
        if cfg.l1_reg or cfg.l2_reg:
            bad.append("fsc_test with l1/l2 regularization: the reference scores it per "
                       "candidate (ROADMAP A7)")
        elif cfg.model != "lsq" or cfg.score_metric != "cosine" or cfg.thresh_fraction >= 0:
            bad.append("fsc_test with a model other than lsq, a 2D score metric or "
                       "thresh_fraction: the reference scores it on its grouped XLA path, "
                       "not the kernel (ROADMAP A6.6b)")
    if bad:
        raise NotImplementedError("not ported yet: " + "; ".join(bad))


def _cosine(a, b):
    """Cosine of each pair of rows of a, b (B, ...), 0 where a norm is 0."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    num = (a * b).sum(dim=1)
    den = torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1)
    return torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)


def _candidate_score(pred, b_eff, b2d, rowv, cfg: SolveConfig, copy_rank=None, inv_w=None):
    """Score B reprojections per cfg.score_metric: pred, b_eff and rowv
    (B, C, l2, d2), b2d (l2, d2) the image region; returns (B,).

    cosine compares the row stacks. The 2D metrics compare the image
    region with one reprojection image, each pixel taken from the last
    valid copy of the candidate's Halton-ordered copy list: the last valid
    row without copy_rank; with the grouped scorer's canonical copy table,
    copy_rank (B, C) gives each copy's last Halton position (-1 unselected)
    and inv_w (B, C) = 1/sqrt(m) undoes the row weighting. composite is
    the mean of cosine and the three 2D metrics."""
    cos = _cosine(pred, b_eff)
    if cfg.score_metric == "cosine":
        return cos
    return _image_scores(cfg.score_metric, cos, _image_of(pred, rowv, copy_rank, inv_w), b2d)


def _image_of(pred, rowv, copy_rank=None, inv_w=None):
    """The reprojection image (B, l2, d2) the 2D metrics compare: each
    pixel from the last valid copy (see _candidate_score), 0 where no row
    is valid."""
    valid = rowv > 0
    if copy_rank is None:
        C = rowv.shape[1]
        c_last = (C - 1) - torch.argmax(valid.flip(1).to(torch.int32), dim=1)
    else:
        rank = torch.as_tensor(copy_rank, device=pred.device).to(torch.int32)
        eff = torch.where(valid, rank[:, :, None, None], -1)
        c_last = torch.argmax(eff, dim=1)
    src = pred if inv_w is None else pred * inv_w[:, :, None, None]
    return torch.gather(src.float(), 1, c_last[:, None])[:, 0] * valid.any(dim=1)


def _image_scores(metric: str, cos, pred2d, b2d):
    """The 2D metric (or composite, with the cosines cos) of each image of
    pred2d (B, l2, d2) against the region b2d (l2, d2)."""
    from ..core.analysis import (
        ms_ssim_score_traced,
        mutual_information_score_traced,
        ssim_score_traced,
    )

    ref2d = b2d.float()
    if metric == "ssim":
        return ssim_score_traced(pred2d, ref2d)
    if metric == "ms_ssim":
        return ms_ssim_score_traced(pred2d, ref2d)
    if metric == "mutual_information":
        return mutual_information_score_traced(pred2d, ref2d)
    parts = torch.stack([
        cos,
        ssim_score_traced(pred2d, ref2d),
        ms_ssim_score_traced(pred2d, ref2d),
        mutual_information_score_traced(pred2d, ref2d),
    ])
    return parts.mean(dim=0)


def _pid_split_masks(geom, mode: int):
    """Data-row pixel-id split masks (1, l2, d2) float32 numpy of fsc
    modes 1 (random: the pixels whose rank in JAX's permutation(PRNGKey(0),
    n) falls in its first half), 2 (even/odd), 3 (halves) and 4 (outer
    thirds against the centre); pid = i * d2 + j."""
    l2, d2 = geom.l2, geom.d2
    n = l2 * d2
    pid = np.arange(n).reshape(l2, d2)
    if mode == 1:
        from .._jax_random import PRNGKey, permutation

        rank = np.empty(n, np.int64)
        rank[permutation(PRNGKey(0), n)] = np.arange(n)
        set1 = (rank < n // 2).reshape(l2, d2)
    elif mode == 2:
        set1 = pid % 2 == 0
    elif mode == 3:
        set1 = pid < n // 2
    else:
        set1 = (pid < n // 3) | (pid >= 2 * n // 3)
    return set1[None].astype(np.float32), (~set1[None]).astype(np.float32)


def _vdot(a, b):
    return torch.sum(a * b)


def _cg_from(N, rhs, x0, iters: int, x0_is_zero: bool = False):
    """Fixed-iteration conjugate gradients for N x = rhs, warm-started."""
    r = rhs if x0_is_zero else rhs - N(x0)
    p = r
    rs = _vdot(r, r)
    x = x0
    for _ in range(iters):
        Np = N(p)
        pNp = _vdot(p, Np)
        alpha = torch.where(pNp > 0, rs / pNp.clamp_min(1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Np
        rs_new = _vdot(r, r)
        beta = torch.where(rs > 0, rs_new / rs.clamp_min(1e-30), 0.0)
        p = r + beta * p
        rs = rs_new
    return x


def _cg(N, rhs, iters: int):
    """Fixed-iteration conjugate gradients for N x = rhs, x0 = 0."""
    return _cg_from(N, rhs, torch.zeros_like(rhs), iters, x0_is_zero=True)


def _power_iteration(N, like: torch.Tensor, iters: int):
    """Largest eigenvalue of the PSD operator N (for the FISTA step),
    seeded from ones, padded by a margin that grows as iters shrink."""
    v = torch.ones_like(like, dtype=torch.float32)
    v = v / torch.linalg.vector_norm(v).clamp_min(1e-30)
    for _ in range(iters):
        w = N(v)
        v = w / torch.linalg.vector_norm(w).clamp_min(1e-30)
    margin = 1.2 if iters >= 4 else (1.5 if iters >= 2 else 1.8)
    return margin * _vdot(v, N(v))


def _fista(N, rhs, x0, lb, ub, l1, iters: int, lipschitz):
    """FISTA on 0.5 x.N.x - rhs.x + l1 |x|_1 with box projection."""
    eta = 1.0 / lipschitz.clamp_min(1e-20)

    def prox(v):
        if l1:
            v = torch.sign(v) * torch.clamp_min(torch.abs(v) - eta * l1, 0.0)
        return torch.clamp(v, lb, ub)

    x = y = torch.clamp(x0, lb, ub)
    t = np.float32(1.0)
    for _ in range(iters):
        g = N(y) - rhs
        x_new = prox(y - eta * g)
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        y = x_new + float((t - np.float32(1.0)) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def _positive(cfg: SolveConfig, rise_pixel: float, twist_degree: float, l3: int) -> bool:
    """Positivity: explicit flag, or auto when pitch > 2 * volume length."""
    if cfg.positive_constraint > 0:
        return True
    if cfg.positive_constraint < 0:
        pitch = np.round(
            np.float32(rise_pixel) * np.float32(360.0) / np.abs(np.float32(twist_degree))
        )
        return bool(pitch > 2 * l3)
    return False


# the alpha-decay retry of an all-zero regularized fit: scale *= 0.1 in
# float32 while the scale exceeds this (the reference's bound)
RETRY_DECAY, RETRY_FLOOR = np.float32(0.1), np.float32(1e-7)


def seed_lreg(x: torch.Tensor, vol_dims: int) -> torch.Tensor:
    """x with each all-zero volume (its last vol_dims axes) replaced by
    the lreg seed: 1 at the centre voxel (flat index n // 2), 0 elsewhere."""
    flat = x.reshape(*x.shape[: x.dim() - vol_dims], -1)
    seed = torch.zeros_like(flat)
    seed[..., flat.shape[-1] // 2] = 1.0
    return torch.where((flat != 0).any(dim=-1, keepdim=True), flat, seed).reshape(x.shape)


def _solve_one_weighting(ops, rowv, mask_f, cfg: SolveConfig, positive: bool, ub_val,
                         full_rows: bool = True, reg_scale=1.0):
    """Solve with the data-row weighting rowv; returns (x, score).

    full_rows (rowv is the row-validity mask) lets the data term use the
    fused P^T P; otherwise it is P^T (P(v) * rowv). reg_scale multiplies
    the l1 / l2 coefficients (the row count when cfg.reg_per_row)."""
    P, PT, PTP, S, ST = ops["P"], ops["PT"], ops["PTP"], ops["S"], ops["ST"]
    b_eff = ops["b"][None] * rowv

    if full_rows:
        def N0(v):
            return (PTP(v) + ST(S(v))) * mask_f
    else:
        def N0(v):
            return (PT(P(v) * rowv) + ST(S(v))) * mask_f

    reg_scale = np.float32(reg_scale)
    l1_eff = np.float32(cfg.l1_reg) * reg_scale
    l2_eff = np.float32(cfg.l2_reg) * reg_scale
    rhs = PT(b_eff) * mask_f
    lb = torch.zeros_like(ub_val) if positive else torch.full_like(ub_val, -torch.inf)
    ub = ub_val if positive else torch.full_like(ub_val, torch.inf)

    def run(scale):
        # one CG warm start + FISTA pass at regularization (l1, l2) * scale
        N = N0
        if cfg.l2_reg:
            l2s = float(l2_eff * scale)

            def N(v):
                return N0(v) + l2s * v * mask_f

        x = _cg(N, rhs, cfg.cg_iters) if cfg.cg_iters > 0 else torch.zeros_like(rhs)
        if cfg.fista_iters > 0:
            L = _power_iteration(N, rhs, cfg.power_iters)
            x = _fista(N, rhs, x, lb, ub, float(l1_eff * scale), cfg.fista_iters, L)
        else:
            x = torch.clamp(x, lb, ub)
        return x * mask_f

    scale = np.float32(1.0)
    x = run(scale)
    if cfg.l1_reg > 0 or cfg.l2_reg > 0:
        while not bool((x != 0).any()) and scale > RETRY_FLOOR:
            scale = np.float32(scale * RETRY_DECAY)
            x = run(scale)
    elif cfg.model == "lreg":
        x = seed_lreg(x, 3)
    pred = P(x) * rowv
    if cfg.thresh_fraction >= 0:
        pred = torch.clamp_min(pred, 0.0)
    score = _candidate_score(pred[None], b_eff[None], ops["b"], rowv[None], cfg)[0]
    return x, score


def solve_candidate(
    geom,
    cfg: SolveConfig,
    image_region,
    twist_degree,
    rise_pixel,
    copies_h,
    copies_c,
    copies_valid,
    pairs_hc,
    pairs_valid,
    tilt_degree=0.0,
    psi_degree=0.0,
    dy_pixel=0.0,
    key=None,
    pair_ops=None,
    sym_keep=None,
    device="cuda",
):
    """Reconstruct and score one candidate (the separable branch of the
    reference's _solve_candidate_impl) on ``device`` (the card unless the
    caller asks for "cpu"). ``key`` is accepted and not used (only ard
    draws random numbers). Returns dict(rec3d (l3, d3, d3), rec3d_half1,
    rec3d_half2 (zeros without fsc), score (with fsc, full / 2 + (half1 +
    half2) / 4), scores (the full solve's, then the halves')) there."""
    check_in_slice(cfg)
    if tilt_degree != 0.0 or psi_degree != 0.0:
        raise NotImplementedError("tilt or psi != 0 is not ported yet (ROADMAP A7)")
    from .projector_separable import build_problem_separable

    cdt = getattr(torch, cfg.compute_dtype)
    mask = geom.cylindrical_mask()
    ops = build_problem_separable(
        geom, image_region, twist_degree, rise_pixel, copies_h, copies_c,
        copies_valid, pairs_hc, pairs_valid, dy_pixel, cfg.interpolation,
        mask, geom.cell_valid_mask(), compute_dtype=cdt, pair_ops=pair_ops,
        sym_keep=sym_keep, device=device,
    )
    mask_f = ops["mask"].to(torch.float32)
    rowv = ops["row_valid"].to(torch.float32)
    positive = _positive(cfg, float(rise_pixel), float(twist_degree), geom.l3)
    ub_val = torch.amax(ops["b"][None] * rowv)
    reg_scale = 1.0
    if cfg.reg_per_row:
        # the data-row count with the candidate's own valid copies
        n_valid = max(1, int(np.sum(np.asarray(copies_valid))))
        reg_scale = np.float32(geom.d2 * geom.l2) * np.float32(n_valid)
    x, score = _solve_one_weighting(ops, rowv, mask_f, cfg, positive, ub_val,
                                    reg_scale=reg_scale)
    scores, halves = [score], [torch.zeros_like(x), torch.zeros_like(x)]
    combined = score
    if cfg.fsc_test >= 1:
        for hi, m in enumerate(_pid_split_masks(geom, cfg.fsc_test)):
            halves[hi], sh = _solve_one_weighting(
                ops, rowv * torch.as_tensor(m, device=rowv.device), mask_f, cfg, positive,
                ub_val, full_rows=False, reg_scale=reg_scale,
            )
            scores.append(sh)
        combined = scores[0] / 2 + (scores[1] + scores[2]) / 4
    return dict(rec3d=x, rec3d_half1=halves[0], rec3d_half2=halves[1], score=combined,
                scores=torch.stack(scores))
