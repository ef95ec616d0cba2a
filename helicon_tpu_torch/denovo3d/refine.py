"""Local refinement of (tilt, psi, dy) for denovo3D candidates.

Counterpart of ``helicon_tpu/denovo3d/refine.py``: Gauss-Newton on the
pose with the density x held fixed during each step, x re-solved between
steps. The solve at each pose is ``solver.solve_candidates`` on the gather
projector (the grid passes the reference's refine_cfg: non-separable,
float32), k candidates a launch, each at its own pose: on the card its P,
PT and ST(S(x)) are the kernels K1 / K2 / K4, whose results repeat bit
for bit from run to run (a moving candidate's Gauss-Newton path would
amplify any difference). The step's J^T J, J^T r and r^T r come
from K3 (``gather_kernels.pose_jacobian``: the analytic derivative of the
linear-interpolation residual (P(x) - b) * row_valid, the reference's
``jax.jacfwd`` of it, reduced on the card); the damped 3 x 3 solve
(J^T J + 1e-6 I) runs in float64 in torch. The residual is always linear,
as the reference's (nn is piecewise constant in the pose).

Two semantics, chosen by the reference's rule (``_native_refine_eligible``
with ``HELICON_NATIVE_REFINE``), which picks its C++ engine or its JAX
loops:

- fixed (the engine, native/refine_engine.cpp, and the vmapped
  ``_refine_batch``): the start pose clipped into the bounds, exactly
  max_iter steps, each pose scored before its step and the final iterate
  scored too. refine_all_candidates always runs these; refine_tilt_psi_dy
  runs them for an eligible config whose start lies inside the bounds. On
  the engine's route positivity's upper bound max(b) is clamped at 0
  (ROADMAP C5).
- loop (the reference's Python loop in refine_tilt_psi_dy, for any other
  config, an out-of-bounds start or HELICON_NATIVE_REFINE=0): the
  unclipped start scored, an early exit once the clipped new pose lies
  within 1e-4 of the best, the last iterate not scored.

The port compiles and imports nothing of the JAX package: the engine's
semantics are kept, its host loop is not driven.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["refine_tilt_psi_dy", "refine_all_candidates", "gn_step"]


def _pose_bounds(r_range: dict) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) float32 triples for (tilt, psi, dy) from a refine-range
    dict: a scalar half-width or an explicit (lo, hi) per key (defaults
    30, 45, 5)."""

    def one(v, default):
        if isinstance(v, (tuple, list, np.ndarray)):
            return float(v[0]), float(v[1])
        b = float(default if v is None else v)
        return -b, b

    lo_t, hi_t = one(r_range.get("tilt", 30.0), 30.0)
    lo_p, hi_p = one(r_range.get("psi", 45.0), 45.0)
    lo_d, hi_d = one(r_range.get("dy", 5.0), 5.0)
    return (np.array([lo_t, lo_p, lo_d], np.float32),
            np.array([hi_t, hi_p, hi_d], np.float32))


def _native_refine_eligible(cfg) -> bool:
    """The reference's rule for its C++ engine: the lsq + cosine default
    with no l1 / l2, no thresh clip and no fsc, either interpolation, unless
    HELICON_NATIVE_REFINE=0."""
    if os.environ.get("HELICON_NATIVE_REFINE", "auto") == "0":
        return False
    return (
        cfg.score_metric == "cosine"
        and cfg.model == "lsq"
        and cfg.l1_reg == 0.0
        and cfg.l2_reg == 0.0
        and cfg.thresh_fraction < 0
        and cfg.fsc_test == 0
    )


def gn_step(geom, image_region, twists, rises_pixel, copies, x_vol, params):
    """One damped Gauss-Newton step on (tilt, psi, dy) of k candidates,
    their volumes x_vol (k, l3, d3, d3) fixed: twists, rises_pixel (k,),
    copies (copies_h, copies_c, copies_valid) (k, C), params (k, 3) float32.
    Runs where x_vol lies (K3 on the card). Returns (new params (k, 3)
    float32 numpy, r^T r (k,) float64 numpy)."""
    from .gather_kernels import gather_tables, pose_jacobian
    from .projector_separable import _as

    dev = x_vol.device
    params = np.asarray(params, np.float32).reshape(-1, 3)
    mask = _as(geom.cylindrical_mask().reshape(-1).astype(np.float32), dev)
    cellok = _as(geom.cell_valid_mask().reshape(-1).astype(np.float32), dev)
    tab = gather_tables(geom, twists, rises_pixel, *copies, params[:, 0], params[:, 1],
                        params[:, 2], "linear", mask, cellok, derivatives=True)
    b = _as(image_region, dev, torch.float32).T
    JtJ, Jtr, rtr = pose_jacobian(tab, x_vol.float(), b)
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    step = torch.linalg.solve(JtJ + 1e-6 * eye, Jtr[..., None])[..., 0]
    new = params - step.cpu().numpy().astype(np.float32)
    return new.astype(np.float32), rtr.cpu().numpy()


def _solve_at(geom, cfg, region, twists, rises_pixel, tables, params, device, clamp_ub):
    """Solve and score k candidates at their poses params (k, 3): (scores
    (k,) float32 numpy, volumes (k, l3, d3, d3) on device)."""
    from .solver import solve_candidates

    out = solve_candidates(geom, cfg, region, twists, rises_pixel, *tables, params[:, 0],
                           params[:, 1], params[:, 2], device=device, clamp_ub=clamp_ub)
    return out["score"].float().cpu().numpy(), out["rec3d"]


def _refine_fixed(geom, cfg, region, twists, rises_pixel, tables, p0, lo, hi, max_iter, device,
                  clamp_ub):
    """The fixed semantics for k candidates from the clipped starts p0 (k,
    3): max_iter (solve, score, step, clip) rounds, then the final iterate
    scored. Returns (best params (k, 3), best scores (k,))."""
    params = p0.astype(np.float32).copy()
    best_p = params.copy()
    best_s = np.full(len(params), -np.inf, np.float32)

    def score(params):
        s, x = _solve_at(geom, cfg, region, twists, rises_pixel, tables, params, device,
                         clamp_ub)
        better = s > best_s
        best_p[better] = params[better]
        np.maximum(best_s, s, out=best_s)
        return x

    for _ in range(max_iter):
        x = score(params)
        new, _ = gn_step(geom, region, twists, rises_pixel, tables[:3], x, params)
        params = np.clip(new, lo, hi).astype(np.float32)
    score(params)
    return best_p, best_s


def refine_tilt_psi_dy(geom, cfg, image_region, twist_degree: float, rise_pixel: float, copies,
                       pairs, tilt0: float, psi0: float, dy0: float, r_range: dict,
                       device="cuda"):
    """Refine one candidate's pose (the refine_mode="topk" path and the
    web app's per-task refinement); return the best (tilt, psi, dy).

    copies (copies_h, copies_c, copies_valid) (C,), pairs (pairs_hc,
    pairs_valid); r_range: tilt / psi / dy bounds and max_iter (outer
    iterations, default 5). The fixed semantics for an eligible config
    whose start lies inside the bounds, else the loop's (module docstring).
    Runs on ``device`` (the card unless the caller asks for "cpu")."""
    max_iter = int(r_range.get("max_iter", 5))
    lo, hi = _pose_bounds(r_range)
    p0 = np.array([tilt0, psi0, dy0], np.float32)
    tw = np.float32([twist_degree])
    ri = np.float32([rise_pixel])
    tables = tuple(np.asarray(t)[None] for t in (*copies, *pairs))
    if _native_refine_eligible(cfg) and bool(np.all((p0 >= lo) & (p0 <= hi))):
        best_p, _ = _refine_fixed(geom, cfg, image_region, tw, ri, tables,
                                  np.clip(p0, lo, hi)[None], lo, hi, max_iter, device, True)
        return tuple(float(v) for v in best_p[0])

    params = p0
    best = (params.copy(), -np.inf)
    for _ in range(max_iter):
        s, x = _solve_at(geom, cfg, image_region, tw, ri, tables, params[None], device, False)
        if float(s[0]) > best[1]:
            best = (params.copy(), float(s[0]))
        new, _ = gn_step(geom, image_region, tw, ri, tables[:3], x, params[None])
        params = np.clip(new[0], lo, hi).astype(np.float32)
        if np.allclose(params, best[0], atol=1e-4):
            break
    return tuple(float(v) for v in best[0])


def refine_all_candidates(geom, cfg, image_region, twists, rises_pixel, tables, tilt0: float,
                          psi0: float, dy0: float, r_range: dict, batch_size: int | None = None,
                          device="cuda"):
    """refine_mode="all": refine every candidate's (tilt, psi, dy) from the
    grid's pose, with the fixed semantics (module docstring), batch_size
    candidates a launch (None: all; the grid sizes it from free memory).

    tables: (copies_h, copies_c, copies_valid, pairs_hc, pairs_valid) with
    a leading candidate axis (grid._candidate_tables). Returns (scores (n,)
    float32, params (n, 3) float32)."""
    n = len(twists)
    max_iter = int(r_range.get("max_iter", 5))
    lo, hi = _pose_bounds(r_range)
    twists = np.asarray(twists, np.float32)
    rises_pixel = np.asarray(rises_pixel, np.float32)
    tables = tuple(np.asarray(t) for t in tables)
    dev = torch.device(device)
    k = max(1, batch_size or n)
    p0 = np.clip(np.array([tilt0, psi0, dy0], np.float32), lo, hi)
    clamp_ub = _native_refine_eligible(cfg)
    scores = np.zeros(n, np.float32)
    params = np.zeros((n, 3), np.float32)
    for s in range(0, n, k):
        sl = slice(s, min(s + k, n))
        params[sl], scores[sl] = _refine_fixed(
            geom, cfg, image_region, twists[sl], rises_pixel[sl], tuple(t[sl] for t in tables),
            np.broadcast_to(p0, (sl.stop - s, 3)), lo, hi, max_iter, dev, clamp_ub)
    return scores, params
