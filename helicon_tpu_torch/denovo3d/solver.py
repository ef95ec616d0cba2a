"""Matrix-free bounded least-squares solve of denovo3D candidates.

Counterpart of ``helicon_tpu/denovo3d/solver.py``'s per-candidate solve
(``_solve_candidate_impl``, ``_solve_one_weighting``, ``ard_em``): the
grid search's per-candidate path and its best-volume re-solve. CG on the
normal equations, then FISTA with the box [0, max b] or unbounded, for
the models lsq, lreg (the centre-voxel seed of an all-zero fit), ridge,
lasso and elasticnet (l2 in every matvec, l1 in the prox, the alpha-decay
retry of an all-zero fit) and ard (evidence maximization, ``ard_em``); the
score metrics cosine, ssim, ms_ssim, mutual_information and composite
(``_candidate_score``, which the grouped scorer of ``grid`` shares); the
thresh clip of the prediction; the fsc half-set splits of modes 1-4 (mode
1 draws JAX's permutation through ``_jax_random``). The power iteration is
seeded from ones, as the reference's XLA path.

``solve_candidates`` solves k candidates of one table shape together. At
tilt = psi = 0 they solve on the separable operators' dense factors with
B2 (``candidate_solve``: the kernels on the card, the plain version on the
CPU), the fsc halves on a j-dependent z-Gram and ard's normal operator on
B2's matvec entry; any other pose solves in torch on the gather projector
(``projector``). The grouped scoring solve lives in ``group_solve``. Both
interpolations are ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SolveConfig", "SCORE_METRICS", "regularization_from_algorithm", "solve_candidate",
           "solve_candidates", "ard_em"]

SCORE_METRICS = ("cosine", "ssim", "ms_ssim", "mutual_information", "composite")
MODELS = ("lsq", "lreg", "ridge", "lasso", "elasticnet", "ard")


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
    grouped scorer (separable, no ard, no fsc with l1/l2: the reference's
    routing rule sends those per candidate), where fsc rides the kernel
    only with lsq + cosine and no thresh clip, as the reference's kernel
    does (its grid.py:590-608); the per-candidate solve takes fsc with
    every model."""
    if cfg.score_metric not in SCORE_METRICS:
        raise ValueError(f"Unknown score_metric {cfg.score_metric!r}; supported: {SCORE_METRICS}")
    bad = []
    if not cfg.interpolation.startswith(("nn", "linear")):
        bad.append(f"interpolation={cfg.interpolation!r}")
    if cfg.model not in MODELS:
        bad.append(f"model={cfg.model!r}")
    if grouped and cfg.fsc_test and (cfg.model != "lsq" or cfg.score_metric != "cosine"
                                     or cfg.thresh_fraction >= 0):
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


def _bsum(a: torch.Tensor, nd: int) -> torch.Tensor:
    """Sum over the trailing nd axes (one volume's): a scalar per volume."""
    return a.sum(dim=tuple(range(a.dim() - nd, a.dim())))


def _bcol(v, nd: int):
    """A per-volume scalar broadcast against volumes of nd axes."""
    return v.reshape(v.shape + (1,) * nd) if isinstance(v, torch.Tensor) else v


def _cg_from(N, rhs, x0, iters: int, x0_is_zero: bool = False, nd: int | None = None):
    """Fixed-iteration conjugate gradients for N x = rhs, warm-started;
    each volume of nd trailing axes (all of rhs's by default) solved on its
    own step lengths."""
    nd = rhs.dim() if nd is None else nd
    r = rhs if x0_is_zero else rhs - N(x0)
    p = r
    rs = _bsum(r * r, nd)
    x = x0
    for _ in range(iters):
        Np = N(p)
        pNp = _bsum(p * Np, nd)
        alpha = _bcol(torch.where(pNp > 0, rs / pNp.clamp_min(1e-30), 0.0), nd)
        x = x + alpha * p
        r = r - alpha * Np
        rs_new = _bsum(r * r, nd)
        beta = _bcol(torch.where(rs > 0, rs_new / rs.clamp_min(1e-30), 0.0), nd)
        p = r + beta * p
        rs = rs_new
    return x


def _cg(N, rhs, iters: int, nd: int | None = None):
    """Fixed-iteration conjugate gradients for N x = rhs, x0 = 0."""
    return _cg_from(N, rhs, torch.zeros_like(rhs), iters, x0_is_zero=True, nd=nd)


def _power_iteration(N, like: torch.Tensor, iters: int, nd: int | None = None):
    """Largest eigenvalue of the PSD operator N (for the FISTA step) of
    each volume, seeded from ones, padded by a margin that grows as iters
    shrink."""
    nd = like.dim() if nd is None else nd
    v = torch.ones_like(like, dtype=torch.float32)
    v = v / _bcol(torch.sqrt(_bsum(v * v, nd)).clamp_min(1e-30), nd)
    for _ in range(iters):
        w = N(v)
        v = w / _bcol(torch.sqrt(_bsum(w * w, nd)).clamp_min(1e-30), nd)
    margin = 1.2 if iters >= 4 else (1.5 if iters >= 2 else 1.8)
    return margin * _bsum(v * N(v), nd)


def _fista(N, rhs, x0, lb, ub, l1, iters: int, lipschitz, nd: int | None = None):
    """FISTA on 0.5 x.N.x - rhs.x + l1 |x|_1 with box projection; lb, ub,
    l1 and lipschitz are numbers or one value per volume."""
    nd = rhs.dim() if nd is None else nd
    eta = _bcol(1.0 / lipschitz.clamp_min(1e-20), nd)
    lb, ub, l1 = (_bcol(v, nd) for v in (lb, ub, l1))

    def prox(v):
        if isinstance(l1, torch.Tensor) or l1:
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


def ard_em(N0, rhs, b_sq, n_rows, mask_f, key, vol_shape, iters: int = 12, probes: int = 4,
           inner_cg: int = 40, prior: float = 1e-6, threshold_lambda: float = 1e4):
    """Matrix-free ARD (sparse Bayesian) regression by evidence
    maximization, the reference's ard_em (its solver.py:210-291), for a
    batch of volumes: rhs (..., *mask_f.shape), b_sq and n_rows one value
    per volume. Each EM step is

      coef  = (alpha A^T A + diag(lam))^-1 alpha A^T b      (CG, warm)
      S_ii  ~ Hutchinson diagonal of the same inverse (Rademacher probes
              drawn from fold_in(key, step) as jax.random draws them over
              vol_shape, one warm CG solve per probe)
      gamma = 1 - lam * S_ii
      lam   = (gamma + 2 prior) / (coef^2 + 2 prior)
      alpha = (n_rows - sum gamma + 2 prior) / (|b - A coef|^2 + 2 prior)

    with sklearn's pruning: coefficients whose precision exceeds
    threshold_lambda are held at zero. N0(v) is the unregularized normal
    operator A^T A v * mask; key a raw JAX key (``_jax_random``)."""
    from .._jax_random import fold_in, rademacher

    nd = mask_f.dim()
    prior = np.float32(prior)
    mask_b = mask_f > 0.5
    alpha = n_rows / b_sq.clamp_min(1e-30)
    lam = mask_f.expand_as(rhs)
    coef = torch.zeros_like(rhs)
    diag_prev = lam
    for it in range(iters):
        z_all = torch.from_numpy(rademacher(fold_in(key, it), (probes,) + tuple(vol_shape)))
        z_all = z_all.to(rhs.device).reshape((probes,) + tuple(mask_f.shape)) * mask_f
        keep = mask_b & (lam < threshold_lambda)
        keep_f = keep.to(torch.float32)
        lam_eff = torch.where(keep, lam, float(threshold_lambda))
        a = _bcol(alpha, nd)

        def M(v, a=a, lam_eff=lam_eff):
            return (a * N0(v) + lam_eff * v) * mask_f

        coef = _cg_from(M, a * rhs * mask_f, coef * keep_f, inner_cg, nd=nd) * keep_f
        diag_sum = torch.zeros_like(rhs)
        for z in z_all:
            z = z.expand_as(rhs)
            diag_sum = diag_sum + z * _cg_from(M, z, diag_prev * z, inner_cg, nd=nd)
        diag = torch.clamp_min(diag_sum / np.float32(probes), 0.0)
        gamma = torch.clamp(1.0 - lam_eff * diag, 0.0, 1.0) * keep_f
        lam = torch.where(mask_b, (gamma + 2.0 * prior) / (coef * coef + 2.0 * prior), 0.0)
        rmse = torch.clamp_min(
            b_sq - 2.0 * _bsum(coef * rhs, nd) + _bsum(coef * N0(coef), nd), 0.0)
        alpha = (n_rows - _bsum(gamma, nd) + 2.0 * prior) / (rmse + 2.0 * prior)
        diag_prev = diag
    return coef


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


def retry_all_zero(solve_at, x: torch.Tensor, vol_dims: int):
    """The reference's alpha-decay retry (its solver.py:466-475) for a
    batch of volumes x (..., vol): while a volume is all zero and the scale
    exceeds 1e-7, the scale drops tenfold in float32 and the batch is
    solved again by solve_at(scale); each volume keeps its first nonzero
    solution. Returns (x, rounds)."""
    def nonzero(v):
        return (v != 0).flatten(v.dim() - vol_dims).any(dim=-1)

    found = nonzero(x)
    scale, rounds = np.float32(1.0), 0
    while not bool(found.all()) and scale > RETRY_FLOOR:
        scale = np.float32(scale * RETRY_DECAY)
        rounds += 1
        x_new = solve_at(scale)
        x = torch.where(_bcol(found, vol_dims), x, x_new)
        found = found | nonzero(x_new)
    return x, rounds


def seed_lreg(x: torch.Tensor, vol_dims: int) -> torch.Tensor:
    """x with each all-zero volume (its last vol_dims axes) replaced by
    the lreg seed: 1 at the centre voxel (flat index n // 2), 0 elsewhere."""
    flat = x.reshape(*x.shape[: x.dim() - vol_dims], -1)
    seed = torch.zeros_like(flat)
    seed[..., flat.shape[-1] // 2] = 1.0
    return torch.where((flat != 0).any(dim=-1, keepdim=True), flat, seed).reshape(x.shape)


class _Batch:
    """k candidates' operators as one batch of flat volumes (k, l3, d3^2).

    ``ops`` holds batched closures (P (k, l3, d3, d3) -> (k, C, l2, d2),
    PT, S, ST), b, row_valid (k, C, l2, d2) and mask: of
    build_problems_separable, whose dense factors B2 solves on
    (``candidate_solve``: its kernels on CUDA tensors, its plain version
    on CPU tensors), or _stacked_ops of the gather projectors, solved on
    the closures in torch.
    ``w`` is a data-row weighting: None for the full rows, else the fsc
    half's pixel-id mask (1, l2, d2)."""

    def __init__(self, ops, cfg: SolveConfig, geom):
        self.ops, self.cfg = ops, cfg
        self.vol = geom.volume_shape
        self.flat = (geom.l3, geom.d3 * geom.d3)
        self.on_b2 = "factors" in ops
        self.mask = ops["mask"].to(torch.float32).reshape(self.flat)
        self.rowv = ops["row_valid"].to(torch.float32)
        self.b = ops["b"]
        self._inp = None

    def P(self, x):
        return self.ops["P"](x.reshape((-1,) + self.vol))

    def PT(self, r):
        return self.ops["PT"](r).reshape((-1,) + self.flat)

    def S(self, x):
        return self.ops["S"](x.reshape((-1,) + self.vol))

    def inputs(self, w, rhs, scal):
        """B2's inputs for the weighting w (its z-Gram, j-dependent for a
        half), rhs (k, l3, d3^2) and scal (k, 4)."""
        from .candidate_solve import candidate_inputs

        f = self.ops["factors"]
        if self._inp is None:
            self._inp = candidate_inputs(f, getattr(torch, self.cfg.compute_dtype), rhs, scal,
                                         a_top=self.ops["a_top"])
        gz = None
        if w is not None:
            mz = f["Mz"].float()  # (k, C, l2, l3)
            gz = torch.einsum("kcim,kcin,ij->kcmnj", mz, mz, w[0]).contiguous()
        return dataclasses.replace(
            self._inp, gz=self._inp.gz if gz is None else gz,
            rhs=rhs.contiguous(), scal=scal.contiguous())

    def N0(self, w):
        """The unregularized normal operator of the weighting w, masked."""
        k = self.rowv.shape[0]
        if self.on_b2:
            from .candidate_solve import candidate_matvec

            dev = self.mask.device
            inp = self.inputs(w, torch.zeros((k,) + self.flat, device=dev),
                              torch.zeros((k, 4), device=dev))
            return lambda v: candidate_matvec(inp, v)
        ops = self.ops
        rows = self.rowv if w is None else self.rowv * w

        def N0(v):
            vol = v.reshape((k,) + self.vol)
            out = ops["PT"](ops["P"](vol) * rows) + ops["ST"](ops["S"](vol))
            return out.reshape(v.shape) * self.mask
        return N0

    def solve(self, w, rhs, l1, l2, lb, ub):
        """CG, the power iteration from ones and FISTA with the box and the
        l1 soft-threshold, per candidate (l1, l2, lb, ub (k,)); returns x
        (k, l3, d3^2), masked."""
        cfg = self.cfg
        if self.on_b2:
            from .candidate_solve import solve_candidate_kernel

            scal = torch.stack([l2, l1, lb, ub], dim=1)
            x = solve_candidate_kernel(self.inputs(w, rhs, scal), cfg.cg_iters, cfg.fista_iters,
                                       cfg.power_iters)
            if cfg.fista_iters <= 0:  # the box still holds without FISTA
                x = torch.clamp(x, _bcol(lb, 2), _bcol(ub, 2)) * self.mask
            return x
        N0 = self.N0(w)
        N = N0
        if cfg.l2_reg:
            def N(v):
                return N0(v) + _bcol(l2, 2) * v * self.mask
        x = _cg(N, rhs, cfg.cg_iters, nd=2) if cfg.cg_iters > 0 else torch.zeros_like(rhs)
        if cfg.fista_iters > 0:
            L = _power_iteration(N, rhs, cfg.power_iters, nd=2)
            x = _fista(N, rhs, x, lb, ub, l1 if cfg.l1_reg else 0.0, cfg.fista_iters, L, nd=2)
        else:
            x = torch.clamp(x, _bcol(lb, 2), _bcol(ub, 2))
        return x * self.mask


def _stacked_ops(ops) -> dict:
    """One batch of per-candidate operator dicts (the gather projector's):
    closures over the leading candidate axis, a candidate at a time."""
    def each(name):
        return lambda t: torch.stack([o[name](ti) for o, ti in zip(ops, t)])

    return dict(P=each("P"), PT=each("PT"), S=each("S"), ST=each("ST"), b=ops[0]["b"],
                row_valid=torch.stack([o["row_valid"] for o in ops]), mask=ops[0]["mask"])


def _tick(times, name, t0):
    """Add the host seconds since t0, after a device synchronisation, to
    times[name]; returns the time now."""
    if times is None:
        return t0
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t = time.perf_counter()
    times[name] = times.get(name, 0.0) + (t - t0)
    return t


def _solve_weighting(batch: _Batch, w, positive, ub_val, reg_scale, key, times=None):
    """Solve and score k candidates under the data-row weighting w (None:
    the full rows; else an fsc half's pixel-id mask), the reference's
    _solve_one_weighting. Returns (x (k, l3, d3^2), score (k,), retry
    rounds); times accumulates solve_s and score_s."""
    cfg = batch.cfg
    dev = batch.mask.device
    t0 = time.perf_counter()
    rowv = batch.rowv if w is None else batch.rowv * w
    b_eff = batch.b[None, None] * rowv
    rhs = batch.PT(b_eff) * batch.mask
    rounds = 0
    if cfg.model == "ard":
        from .._jax_random import fold_in, split, uniform

        # the equation count: valid data rows plus the symmetry rows that
        # two random volumes find nonzero (the reference's two probes)
        kp1, kp2 = split(fold_in(key, 7))
        m3 = batch.mask.reshape(batch.vol)
        p1, p2 = (torch.from_numpy(uniform(kp, batch.vol, 1.0, 2.0)).to(dev) * m3
                  for kp in (kp1, kp2))
        k = len(rhs)
        n_sym = ((batch.S(p1.expand((k,) + batch.vol)) != 0)
                 | (batch.S(p2.expand((k,) + batch.vol)) != 0)).flatten(1).sum(dim=1)
        n_rows = _bsum(rowv, 3) + n_sym.to(torch.float32)
        b_sq = _bsum(b_eff * b_eff, 3)
        x = ard_em(batch.N0(w), rhs, b_sq, n_rows, batch.mask, key, batch.vol,
                   iters=cfg.ard_iters, probes=cfg.ard_probes,
                   inner_cg=max(8, cfg.cg_iters // 3), prior=cfg.ard_prior)
    else:
        reg = torch.as_tensor(np.asarray(reg_scale, np.float32), device=dev)
        l1 = reg * np.float32(cfg.l1_reg)
        l2 = reg * np.float32(cfg.l2_reg)
        lb = torch.where(positive, 0.0, -torch.inf).to(torch.float32)
        ub = torch.where(positive, ub_val, torch.inf).to(torch.float32)

        def solve_at(scale):
            return batch.solve(w, rhs, l1 * float(scale), l2 * float(scale), lb, ub)

        x = solve_at(np.float32(1.0))
        if cfg.l1_reg > 0 or cfg.l2_reg > 0:
            x, rounds = retry_all_zero(solve_at, x, 2)
        elif cfg.model == "lreg":
            x = seed_lreg(x, 2)
    t0 = _tick(times, "solve_s", t0)
    pred = batch.P(x) * rowv
    if cfg.thresh_fraction >= 0:
        pred = torch.clamp_min(pred, 0.0)
    score = _candidate_score(pred, b_eff, batch.b, rowv, cfg)
    _tick(times, "score_s", t0)
    return x, score, rounds


def _stacked(a, k: int):
    """Per-candidate rows of a table given for k candidates (or for one)."""
    a = np.asarray(a)
    return a if a.ndim and len(a) == k else np.broadcast_to(a, (k,) + a.shape)


def solve_candidates(
    geom,
    cfg: SolveConfig,
    image_region,
    twists,
    rises_pixel,
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
    times: dict | None = None,
):
    """Reconstruct and score k candidates of one table shape: the
    reference's _solve_candidate_impl for each (its vmap over a batch).
    Tables carry a leading candidate axis: twists, rises_pixel (k,),
    copies (k, C), pairs_hc (k, P, 4), pairs_valid (k, P), pair_ops
    ((k, O, 2), (k, O), (k, P, 2)), sym_keep (k, P, l3, d3, d3).

    cfg.separable (tilt = psi = 0) builds the separable operators of the
    k candidates together in the dense symmetry form (pair_ops is
    required), so that B2 solves every candidate (and ard's normal
    operator runs on its matvec entry). A non-separable pose builds the
    gather projector, a candidate at a time. ``key`` (a raw JAX key, default
    PRNGKey(0)) feeds ard's probes. ``times`` accumulates the host
    seconds of the builds (build_s), the solves (solve_s) and the scoring
    (score_s), each ended by a device synchronisation, and the retry's
    extra rounds (retry_rounds). Returns dict(rec3d (k, l3, d3, d3),
    rec3d_half1, rec3d_half2 (zeros without fsc), score (k,) (with fsc,
    full / 2 + (half1 + half2) / 4), scores (k, 1 or 3)) on ``device``."""
    from .._jax_random import PRNGKey, fold_in
    from .projector import build_problem
    from .projector_separable import build_problems_separable

    check_in_slice(cfg)
    if cfg.separable and (tilt_degree != 0.0 or psi_degree != 0.0):
        raise ValueError("the separable operators need tilt = psi = 0")
    dev = torch.device(device)
    if cfg.separable and pair_ops is None:
        raise ValueError("the separable solve runs on B2's dense symmetry factors: pass pair_ops")
    twists = np.atleast_1d(np.asarray(twists, np.float32))
    rises_pixel = np.atleast_1d(np.asarray(rises_pixel, np.float32))
    k = len(twists)
    key = PRNGKey(0) if key is None else key
    mask, cellok = geom.cylindrical_mask(), geom.cell_valid_mask()
    cdt = getattr(torch, cfg.compute_dtype)
    tabs = [_stacked(t, k) for t in (copies_h, copies_c, copies_valid, pairs_hc, pairs_valid)]
    keep = None if sym_keep is None else _stacked(sym_keep, k)
    t0 = time.perf_counter()
    if cfg.separable:
        ops = build_problems_separable(
            geom, image_region, twists, rises_pixel, *tabs, dy_pixel, cfg.interpolation, mask,
            cellok, compute_dtype=cdt, sym_keep=keep, device=dev,
            pair_ops=tuple(_stacked(a, k) for a in pair_ops))
    else:
        ops = _stacked_ops([
            build_problem(geom, image_region, twists[i], rises_pixel[i], *(t[i] for t in tabs),
                          tilt_degree, psi_degree, dy_pixel, cfg.interpolation, mask, cellok,
                          sym_keep=None if keep is None else keep[i], device=dev)
            for i in range(k)])
    batch = _Batch(ops, cfg, geom)
    positive = torch.as_tensor(
        [_positive(cfg, float(r), float(t), geom.l3) for t, r in zip(twists, rises_pixel)],
        device=dev)
    ub_val = torch.amax((batch.b[None, None] * batch.rowv).flatten(1), dim=1)
    reg_scale = np.ones(k, np.float32)
    if cfg.reg_per_row:
        # the data-row count with each candidate's own valid copies
        n_valid = np.maximum(1, np.asarray(tabs[2]).reshape(k, -1).sum(axis=1))
        reg_scale = np.float32(geom.d2 * geom.l2) * n_valid.astype(np.float32)
    _tick(times, "build_s", t0)
    x, score, rounds = _solve_weighting(batch, None, positive, ub_val, reg_scale, key, times)
    scores, halves = [score], [torch.zeros_like(x), torch.zeros_like(x)]
    combined = score
    if cfg.fsc_test >= 1:
        for hi, m in enumerate(_pid_split_masks(geom, cfg.fsc_test)):
            halves[hi], sh, r = _solve_weighting(batch, torch.as_tensor(m, device=dev), positive,
                                                 ub_val, reg_scale, fold_in(key, hi + 1), times)
            scores.append(sh)
            rounds = max(rounds, r)
        combined = scores[0] / 2 + (scores[1] + scores[2]) / 4
    if times is not None:
        times["retry_rounds"] = max(times.get("retry_rounds", 0), rounds)
    vol = (k,) + geom.volume_shape
    return dict(rec3d=x.reshape(vol), rec3d_half1=halves[0].reshape(vol),
                rec3d_half2=halves[1].reshape(vol), score=combined,
                scores=torch.stack(scores, dim=1))


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
    """Reconstruct and score one candidate on ``device`` (the card unless
    the caller asks for "cpu"): solve_candidates for one. cfg.separable
    needs tilt = psi = 0 and pair_ops; otherwise the gather
    projector serves any pose. Returns dict(rec3d (l3, d3, d3),
    rec3d_half1, rec3d_half2 (zeros without fsc), score (with fsc, full /
    2 + (half1 + half2) / 4), scores (the full solve's, then the
    halves'))."""
    out = solve_candidates(
        geom, cfg, image_region, [twist_degree], [rise_pixel], *(
            np.asarray(t)[None] for t in (copies_h, copies_c, copies_valid, pairs_hc,
                                          pairs_valid)),
        tilt_degree, psi_degree, dy_pixel, key=key,
        pair_ops=None if pair_ops is None else tuple(np.asarray(a)[None] for a in pair_ops),
        sym_keep=None if sym_keep is None else np.asarray(sym_keep)[None], device=device,
    )
    return {k: v[0] for k, v in out.items()}
