"""The solve and the score of a search, frozen.

A copy of the port's plain solves: the twist group's (``denovo3d/
group_solve.solve_group_reference``, with the grid's power seed, ones) and
one candidate's on the dense separable factors
(``denovo3d/candidate_solve._solve_plain``). Per candidate: CG from zero
on the normal equations, a power iteration from ones for the step,
FISTA with the box [lb, ub], then the volume masked; the group's score is
the cosine <x, rhs> / (|P x| |b_eff|).

``Rounding`` names where a value is rounded before a product (the
program rounds there to its compute dtype): float32 rounds nothing; fp8
rounds to float8 e4m3 under a power-of-two scale per candidate, the
precision below the program's bf16, and serves as the control.
"""

from __future__ import annotations

import numpy as np
import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor, dims) -> torch.Tensor:
    """t rounded to float8 e4m3 under a power-of-two scale that puts the
    largest magnitude over dims (kept) at or under 448."""
    amax = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    scale = torch.exp2(torch.floor(torch.log2(E4M3_MAX / amax)))
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Rounding:
    """The rounding of a value before a product: the stored A_top, or a
    candidate's block of volumes or products (..., l3, n), each under a
    scale of its own (the trailing two axes)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"rounding {kind!r}")
        self.kind = kind

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        return a if self.kind == "float32" else _fp8(a, (-2, -1))


def _csum(a):
    return a.sum(dim=(-2, -1))


def _col(v):
    return v[..., None, None]


def _margin(power_iters: int) -> float:
    return 1.2 if power_iters >= 4 else (1.5 if power_iters >= 2 else 1.8)


def _fista_coefs(n: int) -> list:
    out, t = [], np.float32(1.0)
    for _ in range(n):
        t_new = np.float32(0.5) * (np.float32(1.0)
                                   + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def _cg_power_fista(mv, rhs, lb, ub, mask, cg_iters, fista_iters, power_iters):
    """CG from 0, the power iteration from ones, FISTA in the box; x
    masked. mv maps (..., l3, n) blocks; lb, ub are per block."""
    x = torch.zeros_like(rhs)
    r, p = rhs.clone(), rhs.clone()
    rs = _csum(rhs * rhs)
    for _ in range(cg_iters):
        Np = mv(p)
        pNp = _csum(p * Np)
        alpha = torch.where(pNp > 0, rs / pNp.clamp_min(1e-30), 0.0)
        x = x + _col(alpha) * p
        r = r - _col(alpha) * Np
        rs_new = _csum(r * r)
        beta = torch.where(rs > 0, rs_new / rs.clamp_min(1e-30), 0.0)
        p = r + _col(beta) * p
        rs = rs_new
    lb, ub = _col(lb), _col(ub)
    if fista_iters > 0:
        v = torch.ones_like(rhs)
        v = v / _col(torch.sqrt(_csum(v * v)).clamp_min(1e-30))
        for _ in range(power_iters):
            w = mv(v)
            v = w / _col(torch.sqrt(_csum(w * w)).clamp_min(1e-30))
        eta = _col(1.0 / (_margin(power_iters) * _csum(v * mv(v))).clamp_min(1e-20))
        x = torch.clamp(x, lb, ub)
        y = x
        for coef in _fista_coefs(fista_iters):
            x_new = torch.clamp(y - eta * (mv(y) - rhs), lb, ub)
            y = x_new + coef * (x_new - x)
            x = x_new
    else:
        x = torch.clamp(x, lb, ub)
    return x * mask


def group_solve(op, lb, ub, iters, rounding: Rounding):
    """Solve and score G twist groups of R candidates together
    (``operators.group_operators``'s inputs stacked on a leading G; lb, ub
    (G, R)); returns (x (G, R, l3, d3^2), cosine (G, R))."""
    cg_iters, fista_iters, power_iters = iters
    A = rounding(op["A_top"])  # (G, rows, d3^2)
    Gz, Mz_ops, a_f, Cn, deg, mask = (op[k] for k in ("Gz", "Mz_ops", "a_f", "Cn", "deg",
                                                      "mask"))
    G, R, C_u, l3 = Gz.shape[:4]
    O, d3sq, d2 = Mz_ops.shape[2], mask.shape[1], op["d2"]
    nd = C_u * d2

    def mix(t_d):
        t_d = t_d.reshape(G, R, l3, C_u, d2)
        return torch.einsum("grcmn,grncj->grmcj", Gz, t_d).reshape(G, R, l3, nd)

    def mv(X):
        T = torch.einsum("grmk,gnk->grmn", rounding(X), A)
        u = mix(T[..., :nd])
        ts = T[..., nd:].reshape(G, R, l3, O, d3sq)
        vals = torch.einsum("gromn,grnop->gromp", Mz_ops, ts)
        av = a_f * vals
        cav = torch.einsum("grox,grxmp->gromp", Cn, av)
        L = (deg * mask) * av - (a_f * mask) * cav
        gs = torch.einsum("gromn,gromp->grnop", Mz_ops, L).reshape(G, R, l3, O * d3sq)
        Gm = rounding(torch.cat([u, gs], dim=-1))
        return torch.einsum("grmn,gnd->grmd", Gm, A) * mask

    rhs = op["rhs"]
    x = _cg_power_fista(mv, rhs, lb, ub, mask, cg_iters, fista_iters, power_iters)
    t_d = torch.einsum("grmk,gnk->grmn", rounding(x), A[:, :nd])
    den = torch.sqrt(_csum(t_d * mix(t_d)).clamp_min(0.0)) * op["b_norm"]
    num = _csum(x * rhs)
    return x, torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)


def normal_operator(op):
    """v -> N v, the masked normal operator (data rows and symmetry pairs)
    of one candidate on its dense separable factors
    (``operators.candidate_operators``), for v (l3, d3^2); any float
    dtype."""
    A, Gz, b1, pok, mask = op["A"], op["Gz"], op["b1"], op["pok"], op["mask"]
    C, l3, nd, d3sq = op["C"], Gz.shape[1], op["nd"], mask.shape[1]
    O = b1.shape[1] // l3

    def mv(v):
        T = v @ A.T  # (l3, rows)
        z = torch.einsum("cmn,ncj->mcj", Gz, T[:, :nd].reshape(l3, C, -1)).reshape(l3, nd)
        tmp = T[:, nd:].reshape(l3, O, d3sq).transpose(0, 1).reshape(O * l3, d3sq)
        ubar = b1.T @ ((b1 @ tmp) * pok)
        ubar = ubar.reshape(O, l3, d3sq).transpose(0, 1).reshape(l3, O * d3sq)
        return (torch.cat([z, ubar], dim=-1) @ A) * mask

    return mv


def candidate_solve(op, lb, ub, iters):
    """Solve one candidate on its dense separable factors; returns x
    (l3, d3^2)."""
    cg_iters, fista_iters, power_iters = iters
    return _cg_power_fista(normal_operator(op), op["rhs"], lb, ub, op["mask"], cg_iters,
                           fista_iters, power_iters)
