"""Matrix-free bounded least-squares solve for one denovo3D candidate.

Counterpart of ``helicon_tpu/denovo3d/solver.py`` for the configuration
the grid search's best-volume re-solve runs: the lsq model (CG on the
normal equations, then FISTA with the box [0, max b] or unbounded), the
cosine score, the separable operators (tilt = psi = 0). The power
iteration is seeded from ones, as the reference's XLA path. The grouped
scoring solve lives in ``group_solve``, the fused single-candidate solve
in ``candidate_solve``. Both interpolations are ported.

Other models, score metrics and fsc half-set splits raise
NotImplementedError (ROADMAP A6, A7).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SolveConfig", "regularization_from_algorithm", "solve_candidate"]


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


def check_in_slice(cfg: SolveConfig) -> None:
    """Raise for every configuration the port does not cover yet."""
    bad = []
    if not cfg.separable:
        bad.append("tilt or psi != 0 (ROADMAP A7)")
    if not cfg.interpolation.startswith(("nn", "linear")):
        bad.append(f"interpolation={cfg.interpolation!r}")
    if cfg.model != "lsq" or cfg.l1_reg or cfg.l2_reg:
        bad.append(f"model={cfg.model!r} (ROADMAP A6)")
    if cfg.score_metric != "cosine":
        bad.append(f"score_metric={cfg.score_metric!r} (ROADMAP A6)")
    if cfg.fsc_test:
        bad.append("fsc_test (ROADMAP A6)")
    if cfg.thresh_fraction >= 0:
        bad.append("thresh_fraction >= 0 (ROADMAP A6)")
    if bad:
        raise NotImplementedError("not ported yet: " + "; ".join(bad))


def _vdot(a, b):
    return torch.sum(a * b)


def _cosine(a, b):
    num = _vdot(a, b)
    den = torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)
    return torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)


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


def _solve_one_weighting(ops, rowv, mask_f, cfg: SolveConfig, positive: bool, ub_val):
    """lsq + cosine solve with the full data rows; returns (x, score)."""
    P, PT, PTP, S, ST = ops["P"], ops["PT"], ops["PTP"], ops["S"], ops["ST"]
    b_eff = ops["b"][None] * rowv

    def N(v):
        return (PTP(v) + ST(S(v))) * mask_f

    rhs = PT(b_eff) * mask_f
    lb = torch.zeros_like(ub_val) if positive else torch.full_like(ub_val, -torch.inf)
    ub = ub_val if positive else torch.full_like(ub_val, torch.inf)
    x = _cg(N, rhs, cfg.cg_iters) if cfg.cg_iters > 0 else torch.zeros_like(rhs)
    if cfg.fista_iters > 0:
        L = _power_iteration(N, rhs, cfg.power_iters)
        x = _fista(N, rhs, x, lb, ub, 0.0, cfg.fista_iters, L)
    else:
        x = torch.clamp(x, lb, ub)
    x = x * mask_f
    pred = P(x) * rowv
    return x, _cosine(pred.ravel(), b_eff.ravel())


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
    caller asks for "cpu"). Returns dict(rec3d (l3, d3, d3), score,
    scores) there."""
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
    x, score = _solve_one_weighting(ops, rowv, mask_f, cfg, positive, ub_val)
    return dict(rec3d=x, score=score, scores=score[None])
