"""Fused single-candidate solve (B2) and in-kernel operator build + score (B3).

Counterpart of the v1/v2 half of ``helicon_tpu/denovo3d/pallas_solver.py``:

    pallas_inputs :72            -> candidate_inputs
    _kernel :100, :210           -> solve_candidate_kernel (B2)
    full_kernel_inputs :267      -> full_kernel_inputs
    _full_kernel :335, :549      -> score_candidate_kernel (B3)
    validate_on_device :1108     -> validate_on_gpu

B2 solves one candidate's normal equations on the factors that
``projector_separable.build_problem_separable`` returns (``ops["factors"]``),
for either interpolation. Its matvec, for v (l3, d3^2), is

    (W2^T Gzmix(v W2^T) + sum_o [B1^T (pok * B1 (v Mxy_o^T))]_o Mxy_o + l2 v) * mask

and the solve runs CG from 0, a power iteration seeded from ones, then
FISTA with the l1 soft-threshold and the box [lb, ub]. The z-Gram may
depend on the ray j (k, C, l3, l3, d2): the fsc half-set solves, whose
pixel-id split weights the data rows. ``candidate_matvec`` runs the
matvec alone with l2 = 0, the normal operator ard's EM loop applies. The
per-candidate path of the grid search (``solver.solve_candidates``) solves
every separable candidate on B2. B3 builds W2 (the
nearest-neighbour ray deposit) and Mxy (the rotation one-hots) itself from
per-copy and per-op angles, forms rhs = (u W2) * mask, runs B2's solve and
returns the cosine score <x, rhs> / (sqrt(<x, data_term(x)>) |b|). B3 is
nearest-neighbour only, as the reference (ROADMAP C4).

The port stacks W2 and the Mxy_o into one operand A = [W2; Mxy_0 ..], the
shape of the grouped solve's A_top, and drops the TPU-only pieces: the
stored transposes w2t / mxyt, the d2p sublane padding and ``fits_vmem``.
Inputs carry a leading axis of k candidates of one shape, solved in one
launch. CPU tensors take the plain PyTorch versions
(``solve_candidate_reference``, ``score_candidate_reference``); CUDA
tensors take the kernels of ``csrc/candidate_solve.cu`` (with the product
kernels of ``csrc/group_solve.cu``) or raise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .grid import _tf32_off
from .group_solve import L3_MAX, _fista_coefs, _ga, _margin, _xat, k_split, sm_count
from .projector_separable import _as, _op_angles

__all__ = [
    "CandidateInputs",
    "FullInputs",
    "candidate_inputs",
    "factors_from_numpy",
    "full_kernel_inputs",
    "build_operators",
    "build_operators_reference",
    "solve_candidate_kernel",
    "solve_candidate_reference",
    "candidate_matvec",
    "score_candidate_kernel",
    "score_candidate_reference",
    "validate_on_gpu",
    "pair_fold",
    "launches",
]

# kernel launches made on CUDA tensors, by entry (each C entry launches one
# kernel; hts_gemm_xat two in bf16: the cast, then the product; a split
# float32 first product adds its ordered sum)
launches = {"solve_candidate": 0, "candidate_matvec": 0, "score_candidate": 0}

OL_MAX = 256  # O * l3 the pair fold's per-thread ubar registers hold (csrc OLMAX)


@dataclasses.dataclass
class CandidateInputs:
    """B2's inputs for k candidates of one shape. ``a_top`` is in the
    compute dtype; the rest is float32."""

    a_top: torch.Tensor  # (k, rows, d3^2) [W2; Mxy_0 .. Mxy_{O-1}], rows = C*d2 + O*d3^2
    # (k, C, l3, l3) per-copy z-Gram, or (.., l3, l3, d2) j-dependent (the
    # fsc half-set solves: the pixel-id split inside)
    gz: torch.Tensor
    b1: torch.Tensor  # (k, P*l3, O*l3) pair difference folded with the z-shifts
    pok: torch.Tensor  # (k, P*l3, d3^2) pair validity
    mask: torch.Tensor  # (l3, d3^2)
    rhs: torch.Tensor  # (k, l3, d3^2)
    scal: torch.Tensor  # (k, 4) [l2, l1, lb, ub]
    d2: int

    @property
    def shape(self):
        """(k, C, O, l3, d3^2)."""
        k, C, l3 = self.gz.shape[:3]
        return k, C, self.b1.shape[2] // l3, l3, self.mask.shape[1]

    @property
    def gz_stride(self) -> int:
        """The z-Gram's element stride: 1, or d2 where it depends on j."""
        return self.d2 if self.gz.dim() == 5 else 1

    @classmethod
    def stack(cls, items):
        """One batch from single-candidate inputs of one shape."""
        kw = {
            f.name: torch.cat([getattr(it, f.name) for it in items])
            for f in dataclasses.fields(cls) if f.name not in ("mask", "d2")
        }
        return cls(mask=items[0].mask, d2=items[0].d2, **kw)


@dataclasses.dataclass
class FullInputs:
    """B3's inputs for k candidates of one shape: the small per-candidate
    tables the kernel builds W2 and Mxy from, float32."""

    theta: torch.Tensor  # (k, C) per-copy in-plane angle, radians
    cvf: torch.Tensor  # (k, C) copy validity
    op_theta: torch.Tensor  # (k, O) per-op in-plane angle, radians
    gz: torch.Tensor  # (k, C, l3, l3) per-copy z-Gram
    u: torch.Tensor  # (k, l3, C*d2) u[m, c*d2 + j] = sum_i Mz[c, i, m] b_eff[c, i, j]
    b1: torch.Tensor  # (k, P*l3, O*l3)
    pok: torch.Tensor  # (k, P*l3, d3^2)
    mask: torch.Tensor  # (l3, d3^2)
    plane_ok: torch.Tensor  # (d3^2,) in-plane cell mask
    scal: torch.Tensor  # (k, 4) [l2, l1, lb, ub]
    b_norm: torch.Tensor  # (k,) |b_eff|
    d2: int
    d3: int
    n_taps: int  # ray samples each side of a cell's projection
    scale: float  # scale2d_to_3d
    dy_pixel: float
    cdt: torch.dtype

    @property
    def shape(self):
        """(k, C, O, l3, d3^2)."""
        k, C, l3, _ = self.gz.shape
        return k, C, self.op_theta.shape[1], l3, self.d3 * self.d3

    @classmethod
    def stack(cls, items):
        """One batch from single-candidate inputs of one shape."""
        shared = ("mask", "plane_ok", "d2", "d3", "n_taps", "scale", "dy_pixel", "cdt")
        kw = {
            f.name: torch.cat([getattr(it, f.name) for it in items])
            for f in dataclasses.fields(cls) if f.name not in shared
        }
        return cls(**{k: getattr(items[0], k) for k in shared}, **kw)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _fold_pairs(f) -> torch.Tensor:
    """B1[k, p*l3 + m, o*l3 + n] = (e_p0 - e_p1)[o] * Mz_o[m, n]: the pair
    difference and the per-op z-shift folded into one small matrix per
    candidate (factors with a leading k)."""
    k, O, l3, _ = f["Mz_ops"].shape
    pidx = f["pair_idx"].long()
    P = pidx.shape[1]
    de = (torch.nn.functional.one_hot(pidx[..., 0], O).float()
          - torch.nn.functional.one_hot(pidx[..., 1], O).float())  # (k, P, O)
    return torch.einsum("kpo,komn->kpmon", de, f["Mz_ops"].float()).reshape(k, P * l3, O * l3)


def _scal(values, device) -> torch.Tensor:
    return torch.as_tensor([list(map(float, values))], dtype=torch.float32, device=device)


def candidate_inputs(factors, cdt, rhs, scal, gz=None, a_top=None) -> CandidateInputs:
    """B2's inputs from ``ops["factors"]``: of build_problem_separable for
    one candidate (k = 1; scal = (l2, l1, lb, ub), rhs (l3, d3, d3) or
    (l3, d3^2), gz (C, l3, l3[, d2])), or of build_problems_separable for
    k (a leading k on the factors, rhs, scal (k, 4) and gz). The operand
    [W2; Mxy] in ``cdt`` is ``a_top`` where given in cdt (the batched
    build's own, of which Wsum and Mxy_ops are views), else stacked here;
    gz is the z-Gram in place of the factors' own."""
    f = factors
    if f["Wsum"].dim() == 3:  # one candidate
        f = {n: t if n in _SHARED_FACTORS else t[None] for n, t in f.items()}
        scal = _scal(scal, f["Wsum"].device)
        gz = None if gz is None else gz[None]
    k, C, d2, d3sq = f["Wsum"].shape
    O, l3 = f["Mz_ops"].shape[1:3]
    if a_top is None or a_top.dtype != cdt:
        a_top = torch.cat([f["Wsum"].reshape(k, C * d2, d3sq).to(cdt),
                           f["Mxy_ops"].reshape(k, O * d3sq, d3sq).to(cdt)], dim=1)
    return CandidateInputs(
        a_top=a_top.contiguous(),
        gz=(f["Gz"] if gz is None else gz).float().contiguous(),
        b1=_fold_pairs(f).contiguous(),
        pok=f["pair_ok"].float().reshape(k, -1, d3sq).contiguous(),
        mask=f["mask"].float().reshape(l3, d3sq).contiguous(),
        rhs=rhs.float().reshape(k, l3, d3sq).contiguous(),
        scal=scal.float().contiguous(),
        d2=d2,
    )


# the factors a batch's candidates share (projector_separable.SHARED_FACTORS)
_SHARED_FACTORS = ("mask", "plane_ok")


def factors_from_numpy(factors_np, compute_dtype=torch.float32, device="cuda") -> dict:
    """The JAX package's ``ops["factors"]`` (as numpy arrays) as the port's
    tensors on ``device``: Wsum, Gz, Mz_ops and Mxy_ops in compute_dtype,
    pair_idx int64, the rest float32."""
    out = {}
    for k, v in factors_np.items():
        if k == "pair_idx":
            out[k] = torch.as_tensor(np.array(v, np.int64), device=device)
            continue
        t = torch.as_tensor(np.array(v, np.float32), device=device)
        out[k] = t.to(compute_dtype) if k in ("Wsum", "Gz", "Mz_ops", "Mxy_ops") else t
    return out


def full_kernel_inputs(geom, ops, twist_degree, rise_pixel, copies_h, copies_c,
                       copies_valid, op_hc, cdt, interpolation: str = "nn",
                       scal=(0.0, 0.0, -math.inf, math.inf), dy_pixel=0.0) -> FullInputs:
    """B3's inputs for one candidate (k = 1): the small tables from
    ``ops`` of build_problem_separable (its factors, b and row_valid, built
    with the same interpolation), the copy and op tables, cdt for the
    built operators and scal = (l2, l1, lb, ub). The big W2 and Mxy are not
    materialized here. rise_pixel is unused (the rise is in the factors),
    as in the reference.

    The build rounds to the nearest cell with weight 1, so linear factors
    would be solved against a different operator: raises for anything but
    nearest-neighbour, as the reference does."""
    if not interpolation.startswith("nn"):
        raise NotImplementedError(
            "the in-kernel operator build (B3) supports nearest-neighbor "
            "interpolation only; use candidate_inputs + solve_candidate_kernel "
            f"(B2) for interpolation={interpolation!r}"
        )
    f = ops["factors"]
    C, d2, d3sq = f["Wsum"].shape
    O, l3, _ = f["Mz_ops"].shape
    dev = f["Wsum"].device
    twist = _as(twist_degree, dev, torch.float32)
    op_hc = _as(op_hc, dev)
    theta = _op_angles(twist, _as(copies_h, dev), _as(copies_c, dev), geom.csym)
    op_theta = _op_angles(twist, op_hc[:, 0], op_hc[:, 1], geom.csym)
    b_eff = ops["b"][None] * ops["row_valid"].float()  # (C, l2, d2)
    u = torch.einsum("cim,cij->mcj", f["Mz"].float(), b_eff).reshape(l3, C * d2)
    s = float(geom.scale2d_to_3d)
    return FullInputs(
        theta=theta[None],
        cvf=_as(copies_valid, dev, torch.float32)[None],
        op_theta=op_theta[None],
        gz=f["Gz"].float().contiguous()[None],
        u=u.contiguous()[None],
        b1=_fold_pairs({n: t[None] for n, t in f.items()}).contiguous(),
        pok=f["pair_ok"].float().reshape(1, -1, d3sq).contiguous(),
        mask=f["mask"].float().reshape(l3, d3sq).contiguous(),
        plane_ok=f["plane_ok"].float().contiguous(),
        scal=_scal(scal, dev),
        b_norm=torch.sqrt((b_eff * b_eff).sum())[None],
        d2=d2,
        d3=geom.d3,
        n_taps=int(math.ceil(math.sqrt(2.0) / s)) + 2,
        scale=s,
        dy_pixel=float(dy_pixel),
        cdt=cdt,
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _csum(a):
    return a.sum(dim=(-2, -1))


def _col(v):
    return v[..., None, None]


def _data_term(A, gz, v, cdt, nd):
    """W2^T Gzmix(v W2^T) with the kernel's rounding points: v and the mix
    in the compute dtype, products accumulated in float32."""
    k, C, l3, _ = gz.shape
    W2 = A[:, :nd].float()
    y = torch.einsum("kmd,krd->kmr", v.to(cdt).float(), W2)  # (k, l3, C*d2)
    z = torch.einsum("kcmn,kncj->kmcj", gz, y.reshape(k, l3, C, -1)).reshape(k, l3, nd)
    return torch.einsum("kmr,krd->kmd", z.to(cdt).float(), W2)


def _pair_fold_plain(t_ops, b1, pok, cdt):
    """[B1^T (pok * B1 tmp)] on the op columns t_ops (k, l3, O*d3^2) of the
    first product, rounded to cdt: (k, l3, O*d3^2) float32."""
    k, l3, _ = t_ops.shape
    O = b1.shape[2] // l3
    d3sq = pok.shape[2]
    tmp = t_ops.reshape(k, l3, O, d3sq).transpose(1, 2).reshape(k, O * l3, d3sq)
    diff = torch.bmm(b1, tmp) * pok
    ubar = torch.bmm(b1.transpose(1, 2), diff).to(cdt).float()
    return ubar.reshape(k, O, l3, d3sq).transpose(1, 2).reshape(k, l3, O * d3sq)


def _matvec_plain(A, gz, b1, pok, mask, l2, v, cdt, nd):
    """The matvec of pallas_solver.py::_kernel for v (k, l3, d3^2), with
    its rounding points: v, the Gz mix and ubar in the compute dtype, tmp
    and the pair fold in float32. gz (k, C, l3, l3) or j-dependent (k, C,
    l3, l3, d2)."""
    k, C, l3 = gz.shape[:3]
    Af = A.float()
    T = torch.einsum("kmd,krd->kmr", v.to(cdt).float(), Af)  # (k, l3, rows)
    eq = "kcmnj,kncj->kmcj" if gz.dim() == 5 else "kcmn,kncj->kmcj"
    z = torch.einsum(eq, gz, T[..., :nd].reshape(k, l3, C, -1))
    ubar = _pair_fold_plain(T[..., nd:], b1, pok, cdt)
    Gm = torch.cat([z.reshape(k, l3, nd).to(cdt).float(), ubar], dim=-1)
    out = torch.einsum("kmr,krd->kmd", Gm, Af)
    return (out + _col(l2) * v) * mask


@_tf32_off
def candidate_matvec_reference(inp: CandidateInputs, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B2's matvec entry (candidate_matvec)."""
    k, C = inp.shape[:2]
    zero = torch.zeros(k, dtype=torch.float32, device=v.device)
    return _matvec_plain(inp.a_top, inp.gz, inp.b1, inp.pok, inp.mask, zero, v,
                         inp.a_top.dtype, C * inp.d2)


def _solve_plain(A, gz, b1, pok, mask, rhs, scal, cdt, nd, cg_iters, fista_iters, power_iters):
    """CG from 0, the power iteration seeded from ones and FISTA with the
    l1 soft-threshold and the box, as pallas_solver.py::_kernel."""
    l1, lb, ub = (_col(scal[:, i]) for i in (1, 2, 3))

    def mv(v):
        return _matvec_plain(A, gz, b1, pok, mask, scal[:, 0], v, cdt, nd)

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
    if fista_iters > 0:
        v = torch.ones_like(rhs)
        v = v / _col(torch.sqrt(_csum(v * v)).clamp_min(1e-30))
        for _ in range(power_iters):
            w = mv(v)
            v = w / _col(torch.sqrt(_csum(w * w)).clamp_min(1e-30))
        lips = _margin(power_iters) * _csum(v * mv(v))
        eta = _col(1.0 / lips.clamp_min(1e-20))
        x = torch.clamp(x, lb, ub)
        y = x
        for coef in _fista_coefs(fista_iters):
            w = y - eta * (mv(y) - rhs)
            x_new = torch.clamp(torch.sign(w) * torch.clamp_min(w.abs() - eta * l1, 0.0), lb, ub)
            y = x_new + coef * (x_new - x)
            x = x_new
    return x * mask


@_tf32_off
def solve_candidate_reference(inp: CandidateInputs, cg_iters: int, fista_iters: int,
                              power_iters: int) -> torch.Tensor:
    """Plain PyTorch version of B2. Returns x (k, l3, d3^2) float32."""
    nd = inp.shape[1] * inp.d2
    return _solve_plain(inp.a_top, inp.gz, inp.b1, inp.pok, inp.mask, inp.rhs, inp.scal,
                        inp.a_top.dtype, nd, cg_iters, fista_iters, power_iters)


def _angles(fin: FullInputs):
    """float32 cos / sin of the copy and op angles, computed once so that
    the kernel and its plain version round the same inputs."""
    return (torch.cos(fin.theta), torch.sin(fin.theta),
            torch.cos(fin.op_theta), torch.sin(fin.op_theta))


def build_operators_reference(fin: FullInputs) -> torch.Tensor:
    """Plain PyTorch version of B3's build: [W2; Mxy] (k, rows, d3^2) in
    fin.cdt, built as pallas_solver.py::_full_kernel builds them
    (:373-451), one elementwise operation at a time in float32."""
    cs_c, sn_c, cs_o, sn_o = _angles(fin)
    k, C, O, l3, d3sq = fin.shape
    d2, d3, s = fin.d2, fin.d3, fin.scale
    dev = fin.theta.device
    half = d3 // 2
    g = torch.arange(d3sq, device=dev)
    gxi, gyi = g % d3, g // d3
    gx, gy = gxi.float(), gyi.float()
    pln = fin.plane_ok > 0.5
    s2 = torch.tensor(s * s, dtype=torch.float32, device=dev)  # true division, as the kernel
    jc = (torch.arange(d2, device=dev) - d2 // 2).float()[:, None]  # (d2, 1)
    y0 = jc * s - fin.dy_pixel
    out = torch.empty((k, C * d2 + O * d3sq, d3sq), dtype=fin.cdt, device=dev)
    for b in range(k):  # one candidate at a time bounds the temporaries
        cs, sn = cs_c[b][:, None, None], sn_c[b][:, None, None]  # (C, 1, 1)
        dx, dy = cs * (-s), sn * s
        cx = y0 * sn + half  # (C, d2, 1)
        cy = y0 * cs + half
        k0 = torch.round(((gx - cx) * dx + (gy - cy) * dy) / s2)  # (C, d2, d3^2)
        count = torch.zeros_like(k0)
        for t in range(-fin.n_taps, fin.n_taps + 1):
            kc = k0 + t
            ink = (kc >= -(d2 // 2)) & (kc <= d2 - 1 - d2 // 2)
            xi = torch.round(cx + kc * dx).to(torch.int64)
            yi = torch.round(cy + kc * dy).to(torch.int64)
            count += (ink & (xi == gxi) & (yi == gyi) & pln).float()
        out[b, : C * d2] = (count * fin.cvf[b][:, None, None]).reshape(C * d2, d3sq)
        cs, sn = cs_o[b][:, None], sn_o[b][:, None]  # (O, 1)
        X = gx - half  # cell i's offsets from the axis
        Y = gy - half
        xi = torch.round(X * cs - Y * sn + half).to(torch.int64)  # (O, d3^2)
        yi = torch.round(X * sn + Y * cs + half).to(torch.int64)
        inb = (xi >= 0) & (xi <= d3 - 1) & (yi >= 0) & (yi <= d3 - 1)
        idx = torch.where(inb, yi * d3 + xi, -1)
        mxy = (g == idx[..., None]).float() * fin.plane_ok  # (O, d3^2, d3^2)
        out[b, C * d2 :] = mxy.reshape(O * d3sq, d3sq)
    return out


def _score_plain(x, rhs, dt, bn):
    num = _csum(x * rhs)
    den = torch.sqrt(_csum(x * dt).clamp_min(0.0)) * bn
    return torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)


@_tf32_off
def score_candidate_reference(fin: FullInputs, cg_iters: int, fista_iters: int,
                              power_iters: int):
    """Plain PyTorch version of B3. Returns (x (k, l3, d3^2), score (k,))."""
    k, C, O, l3, d3sq = fin.shape
    nd = C * fin.d2
    cdt = fin.cdt
    A = build_operators_reference(fin)
    rhs = torch.einsum("kmr,krd->kmd", fin.u.to(cdt).float(), A[:, :nd].float()) * fin.mask
    x = _solve_plain(A, fin.gz, fin.b1, fin.pok, fin.mask, rhs, fin.scal, cdt, nd,
                     cg_iters, fista_iters, power_iters)
    # cosine without the reprojection: <P x, b> = <x, rhs>,
    # |P x|^2 = <x, P^T P x> = <x, data_term(x)>
    return x, _score_plain(x, rhs, _data_term(A, fin.gz, x, cdt, nd), fin.b_norm)


# ---------------------------------------------------------------------------
# the CUDA kernel path
# ---------------------------------------------------------------------------


def _launcher(key: str, dev: torch.device):
    """The kernel library's launcher for one entry point: its kernels
    count in ``launches[key]``."""
    from .._build import Launcher

    def count(kernels: int) -> None:
        launches[key] += kernels

    return Launcher(dev, count)


def _check_cuda(tensors: dict, dev, cdt, shape, d2) -> None:
    k, C, O, l3, d3sq = shape
    gz = tensors.get("gz")
    if gz is not None and tuple(gz.shape) not in ((k, C, l3, l3), (k, C, l3, l3, d2)):
        raise ValueError(f"gz shape {tuple(gz.shape)} is neither (k, C, l3, l3) nor (.., d2)")
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the compute dtype must be float32 or bfloat16, got {cdt}")
    if l3 > L3_MAX or O * l3 > OL_MAX:
        raise ValueError(f"l3 = {l3}, O*l3 = {O * l3} exceed the kernel's {L3_MAX}, {OL_MAX}")
    for name, t in tensors.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev}")
        if name != "a_top" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if cdt == torch.bfloat16 and (d3sq % 2 or d2 % 2):
        raise ValueError("the bf16 kernels copy element pairs: d3^2 and d2 must be even")


def _matvec_cuda(run, A, gz, b1, pok, mask, scal, d2):
    """B2's matvec on the card: returns (matvec(src, dst), its scratch).
    The z-Gram gz (k, C, l3, l3) or j-dependent (k, C, l3, l3, d2)."""
    k, C, l3 = gz.shape[:3]
    d3sq = mask.shape[1]
    rows = A.shape[1]
    nd = C * d2
    O = b1.shape[2] // l3
    PL = b1.shape[1]
    n = l3 * d3sq
    js = d2 if gz.dim() == 5 else 1
    bf16 = int(A.dtype == torch.bfloat16)
    dev = A.device
    kchunk, nsplit = k_split(k, l3, rows, d3sq, sm_count(dev))
    T = torch.empty((k, l3, rows), dtype=torch.float32, device=dev)
    Gm = torch.empty((k, l3, rows), dtype=A.dtype, device=dev)
    xb = torch.empty((k, l3, d3sq), dtype=A.dtype, device=dev) if bf16 else None
    part = torch.empty((nsplit, k, l3, d3sq), dtype=torch.float32, device=dev)

    # T, Gm and xb keep unpadded pitches (rows, d3^2): B2's operand A is
    # unpadded, so the products copy it in 8-byte pieces anyway
    def matvec(src, dst):
        _xat(run, src, A, T, xb, rows)
        run("hts_glue_data", T, gz, Gm, k, 1, l3, C, d2, rows, rows, js, bf16)
        run("hcs_sym_fold", T, b1, pok, Gm, k, l3, O * l3, PL, nd, d3sq, rows, bf16)
        _ga(run, Gm, A, part, kchunk, nsplit)
        run("hcs_reduce_l2_mask", part, src, scal, mask, dst, nsplit, k, n)

    return matvec, dict(T=T, Gm=Gm, xb=xb, part=part, kchunk=kchunk, nsplit=nsplit)


def _solve_cuda(run, A, gz, b1, pok, mask, rhs, scal, d2, cg_iters, fista_iters,
                power_iters):
    """B2's solve on the card; returns x (k, l3, d3^2) float32."""
    k, l3, d3sq = rhs.shape
    n = l3 * d3sq
    f32 = dict(dtype=torch.float32, device=A.device)
    matvec, buf = _matvec_cuda(run, A, gz, b1, pok, mask, scal, d2)
    x, r, p, q, w = (torch.empty((k, l3, d3sq), **f32) for _ in range(5))
    rs, eta = (torch.empty(k, **f32) for _ in range(2))

    run("hts_cg_init", rhs, x, r, p, rs, k, n)
    for _ in range(cg_iters):
        matvec(p, q)
        run("hts_cg_step", x, r, p, q, rs, k, n)
    if fista_iters > 0:
        run("hcs_seed_ones", r, k, n)  # v in r
        for _ in range(power_iters):
            matvec(r, w)
            run("hts_normalize", r, w, k, n)
        matvec(r, w)
        run("hts_rayleigh", r, w, eta, _margin(power_iters), k, n)
        run("hcs_fista_init", x, p, scal, k, n)
        for coef in _fista_coefs(fista_iters):  # y in p
            matvec(p, q)
            run("hcs_fista_step", x, p, q, rhs, eta, scal, coef, k, n)
    run("hts_apply_mask", x, mask, k, n)
    return x, dict(buf, q=q)


def pair_fold(T: torch.Tensor, b1: torch.Tensor, pok: torch.Tensor, nd: int,
              cdt: torch.dtype) -> torch.Tensor:
    """B2's pair fold alone: [B1^T (pok * B1 tmp)] on the op columns of the
    first product's T (k, l3, rows) float32 (columns nd on), for b1 (k,
    P*l3, O*l3) and pok (k, P*l3, d3^2), rounded to cdt; (k, l3, O*d3^2)
    float32. CPU tensors run the plain version; CUDA tensors the kernel."""
    if _device_of(T, "pair_fold") == "cpu":
        return _pair_fold_plain(T[..., nd:], b1, pok, cdt)
    k, l3, rows = T.shape
    pl, ol = b1.shape[1:]
    d3sq = pok.shape[2]
    _check_cuda(dict(T=T, b1=b1, pok=pok), T.device, cdt, (k, 0, ol // l3, l3, d3sq), 0)
    Gm = torch.empty((k, l3, rows), dtype=cdt, device=T.device)
    _launcher("solve_candidate", T.device)("hcs_sym_fold", T, b1, pok, Gm, k, l3, ol, pl, nd,
                                           d3sq, rows, int(cdt == torch.bfloat16))
    return Gm[..., nd:].float()


def _device_of(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type


def solve_candidate_kernel(inp: CandidateInputs, cg_iters: int, fista_iters: int,
                           power_iters: int) -> torch.Tensor:
    """B2: the fused solve of k candidates. CPU tensors run the plain
    version; CUDA tensors run the kernels (never the plain version).
    Returns x (k, l3, d3^2) float32."""
    if _device_of(inp.a_top, "solve_candidate_kernel") == "cpu":
        return solve_candidate_reference(inp, cg_iters, fista_iters, power_iters)
    dev = inp.a_top.device
    tensors = {f.name: getattr(inp, f.name) for f in dataclasses.fields(inp) if f.name != "d2"}
    _check_cuda(tensors, dev, inp.a_top.dtype, inp.shape, inp.d2)
    x, _ = _solve_cuda(_launcher("solve_candidate", dev), inp.a_top, inp.gz, inp.b1, inp.pok,
                       inp.mask, inp.rhs, inp.scal, inp.d2, cg_iters, fista_iters, power_iters)
    return x


def candidate_matvec(inp: CandidateInputs, v: torch.Tensor) -> torch.Tensor:
    """B2's matvec alone with l2 = 0, (W2^T Gzmix(v W2^T) + pair fold) *
    mask for v (k, l3, d3^2) float32: the unregularized normal operator
    (P^T P + S^T S) v * mask of each candidate, the operator ard's EM loop
    applies. CPU tensors run the plain version; CUDA tensors run the
    kernels (never the plain version)."""
    if _device_of(inp.a_top, "candidate_matvec") == "cpu":
        return candidate_matvec_reference(inp, v)
    k, C, O, l3, d3sq = inp.shape
    dev = inp.a_top.device
    tensors = {f.name: getattr(inp, f.name) for f in dataclasses.fields(inp)
               if f.name not in ("d2", "rhs", "scal")}
    tensors["v"] = v
    _check_cuda(tensors, dev, inp.a_top.dtype, inp.shape, inp.d2)
    if tuple(v.shape) != (k, l3, d3sq):
        raise ValueError(f"v must be (k, l3, d3^2) = {(k, l3, d3sq)}, got {tuple(v.shape)}")
    matvec, _ = _matvec_cuda(_launcher("candidate_matvec", dev), inp.a_top, inp.gz, inp.b1,
                             inp.pok, inp.mask, torch.zeros((k, 4), dtype=torch.float32,
                                                            device=dev), inp.d2)
    out = torch.empty_like(v)
    matvec(v, out)
    return out


def _build_cuda(run, fin: FullInputs) -> torch.Tensor:
    k, C, O, l3, d3sq = fin.shape
    nd = C * fin.d2
    bf16 = int(fin.cdt == torch.bfloat16)
    A = torch.empty((k, nd + O * d3sq, d3sq), dtype=fin.cdt, device=fin.theta.device)
    cs_c, sn_c, cs_o, sn_o = _angles(fin)
    s = fin.scale
    run("hcs_build_w2", cs_c, sn_c, fin.cvf, fin.plane_ok, A, k, C, fin.d2, fin.d3, s, s * s,
        fin.dy_pixel, fin.n_taps, A.shape[1], bf16)
    run("hcs_build_mxy", cs_o, sn_o, fin.plane_ok, A, k, O, fin.d3, nd, A.shape[1], bf16)
    return A


def _check_full(fin: FullInputs) -> torch.device:
    dev = fin.theta.device
    skip = ("d2", "d3", "n_taps", "scale", "dy_pixel", "cdt")
    tensors = {f.name: getattr(fin, f.name) for f in dataclasses.fields(fin) if f.name not in skip}
    _check_cuda(tensors, dev, fin.cdt, fin.shape, fin.d2)
    return dev


def build_operators(fin: FullInputs) -> torch.Tensor:
    """B3's operator build alone: [W2; Mxy] (k, rows, d3^2) in fin.cdt.
    CPU tensors run the plain version; CUDA tensors run the kernels."""
    if _device_of(fin.theta, "build_operators") == "cpu":
        return build_operators_reference(fin)
    _check_full(fin)
    return _build_cuda(_launcher("score_candidate", fin.theta.device), fin)


def score_candidate_kernel(fin: FullInputs, cg_iters: int, fista_iters: int, power_iters: int):
    """B3: build W2 and Mxy, solve and score k candidates. CPU tensors run
    the plain version; CUDA tensors run the kernels (never the plain
    version). Returns (x (k, l3, d3^2), score (k,)), float32."""
    if _device_of(fin.theta, "score_candidate_kernel") == "cpu":
        return score_candidate_reference(fin, cg_iters, fista_iters, power_iters)
    dev = _check_full(fin)
    run = _launcher("score_candidate", dev)
    k, C, O, l3, d3sq = fin.shape
    nd = C * fin.d2
    n = l3 * d3sq
    bf16 = int(fin.cdt == torch.bfloat16)
    A = _build_cuda(run, fin)
    rows = A.shape[1]
    kchunk, nsplit = k_split(k, l3, rows, d3sq, sm_count(dev))
    Gm = torch.empty((k, l3, rows), dtype=fin.cdt, device=dev)
    part = torch.empty((nsplit, k, l3, d3sq), dtype=torch.float32, device=dev)
    rhs = torch.empty((k, l3, d3sq), dtype=torch.float32, device=dev)
    # rhs = (u W2) * mask: u in the data columns, zeros in the op columns
    run("hcs_pack_cols", fin.u, Gm, k, l3, nd, rows, bf16)
    _ga(run, Gm, A, part, kchunk, nsplit)
    run("hts_reduce_mask", part, fin.mask, None, None, rhs, nsplit, k, l3, d3sq, l3)
    x, buf = _solve_cuda(run, A, fin.gz, fin.b1, fin.pok, fin.mask, rhs, fin.scal, fin.d2,
                         cg_iters, fista_iters, power_iters)
    # the data term of x: the data columns of the first product, the Gz
    # mix, zeros in the op columns, the second product (x is masked, so
    # the mask the reduction applies changes no sum)
    T, dt = buf["T"], buf["q"]
    _xat(run, x, A, T, buf["xb"], nd)
    run("hts_glue_data", T, fin.gz, Gm, k, 1, l3, C, fin.d2, rows, rows, 1, bf16)
    run("hcs_pack_cols", None, Gm, k, l3, nd, rows, bf16)
    _ga(run, Gm, A, part, kchunk, nsplit)
    run("hts_reduce_mask", part, fin.mask, None, None, dt, nsplit, k, l3, d3sq, l3)
    score = torch.empty(k, dtype=torch.float32, device=dev)
    run("hcs_score", x, rhs, dt, fin.b_norm, score, k, n)
    return x, score


# ---------------------------------------------------------------------------
# the standing validation on the card
# ---------------------------------------------------------------------------


@_tf32_off
def validate_on_gpu(device="cuda") -> dict:
    """Run both kernels (B2 on prebuilt factors, with l2 and l1; B3 with
    its own build and score) on the CUDA device ``device`` against the
    closure path of ``solver`` on a small self-contained problem, the
    geometry of the reference's ``validate_on_device``. The gates are its
    5e-3 (relative on x, absolute on the score): a kernel fault gives
    garbage, not 1e-3. Raises without a card."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("validate_on_gpu needs a CUDA device")
    from .geometry import ReconstructionGeometry, select_copies, select_pair_ops
    from .projector_separable import build_problem_separable
    from .solver import _cg, _cosine, _fista, _power_iteration

    dev = torch.device("cuda", torch.cuda.current_device() if device.index is None
                       else device.index)
    geom = ReconstructionGeometry(d2=12, l2=16, d3=12, l3=8, rmin=0.0, rmax=5.0,
                                  scale2d_to_3d=1.0, csym=1)
    region = np.random.default_rng(0).random((geom.d2, geom.l2)).astype(np.float32)
    ch, cc, cv = select_copies(geom, 2.5, 6)
    ops_hc, ops_v, pair_idx, pv = select_pair_ops(geom, 30.0, 2.5, 5, 8)
    ops = build_problem_separable(
        geom, region, np.float32(30.0), np.float32(2.5), ch, cc, cv,
        np.zeros((5, 4), np.int32), pv, 0.0, "nn", geom.cylindrical_mask(),
        geom.cell_valid_mask(), compute_dtype=torch.float32,
        pair_ops=(ops_hc, ops_v, pair_idx), device=dev,
    )
    mask_f = ops["mask"].float()
    rowv = ops["row_valid"].float()
    b_eff = ops["b"][None] * rowv
    rhs = ops["PT"](b_eff) * mask_f
    CG, FI, PW = 8, 10, 4
    lb, ub = 0.0, float(b_eff.max())
    PTP, S, ST = ops["PTP"], ops["S"], ops["ST"]
    out = {"device": torch.cuda.get_device_name(dev)}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    # v1: factor-consuming solve, l2 + l1 regularized
    l2_reg, l1_reg = 0.01, 0.001

    def N1(v):
        return (PTP(v) + ST(S(v))) * mask_f + l2_reg * v * mask_f

    x = _cg(N1, rhs, CG)
    x_ref = _fista(N1, rhs, x, lb, ub, l1_reg, FI, _power_iteration(N1, rhs, PW)) * mask_f
    inp = candidate_inputs(ops["factors"], torch.float32, rhs, (l2_reg, l1_reg, lb, ub))
    x_k = solve_candidate_kernel(inp, CG, FI, PW)
    out["v1_rel_err"] = rel(x_k[0], x_ref.reshape(geom.l3, -1))

    # v2: in-kernel operator build + solve + cosine score
    def N2(v):
        return (PTP(v) + ST(S(v))) * mask_f

    x = _cg(N2, rhs, CG)
    x2 = _fista(N2, rhs, x, lb, ub, 0.0, FI, _power_iteration(N2, rhs, PW)) * mask_f
    score_ref = float(_cosine((ops["P"](x2) * rowv)[None], b_eff[None])[0])
    fin = full_kernel_inputs(geom, ops, 30.0, 2.5, ch, cc, cv, ops_hc, torch.float32,
                             scal=(0.0, 0.0, lb, ub))
    x2_k, sc = score_candidate_kernel(fin, CG, FI, PW)
    out["v2_rel_err"] = rel(x2_k[0], x2.reshape(geom.l3, -1))
    out["v2_score_abs_err"] = abs(float(sc[0]) - score_ref)
    out["ok"] = bool(out["v1_rel_err"] < 5e-3 and out["v2_rel_err"] < 5e-3
                     and out["v2_score_abs_err"] < 5e-3)
    return out
