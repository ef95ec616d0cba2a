"""Grouped CG / power-iteration / FISTA solve with the in-kernel cosine score.

Counterpart of the v3 half of ``helicon_tpu/denovo3d/pallas_solver.py``
(``grouped_pallas_inputs`` :662, ``_group_kernel`` :754,
``solve_group_pallas`` :950, ``validate_grouped_on_device`` :1014) with
its options: per-candidate l2 (a ridge term in every matvec) and l1 (a
soft-threshold in FISTA's prox) columns, the score or none
(``with_score``), and a j-dependent z-Gram for the fsc half-set solves.

One twist group of R candidates shares the stacked operand
A_top = [Wsum; Mxy] (rows x d3^2). The normal-operator matvec for the
candidate-major block X (R*l3, d3^2) is

    T = X . A_top^T                           (first product)
    u  = Gz mix of T's data columns           (per candidate and copy)
    gs = Mz_ops^T L(Mz_ops T's op columns)    (op-axis graph Laplacian)
    Y  = [u; gs] . A_top * mask               (second product)

Per candidate: CG from 0, a power iteration seeded from rhs (as the TPU
kernel) or, with ``power_seed="ones"``, from ones (as the reference's XLA
grouped solve, ``solver._power_iteration``; the grid search takes the
reference's seed, ``grid.POWER_SEED``), FISTA with the box [lb, ub], then cosine = <x, rhs> /
(sqrt(<t_d, Gz mix t_d>) |b|).

``solve_group`` takes a ``GroupInputs`` batch of G groups. On CPU tensors
it runs ``solve_group_reference`` (plain PyTorch); on CUDA tensors it
runs the hand-written kernels of ``csrc/group_solve.cu`` or raises.
``gemm_xat`` and ``gemm_ga`` run the two products alone.

``GroupInputs.empty`` gives ``a_top`` rows a pitch of a multiple of 8
elements (16 bytes of bf16, 32 of float32): ``a_top`` is the
``[..., :d3^2]`` view of a (G, rows, pitch) buffer, so that the products
copy it in 16-byte pieces. Both dtypes run one streaming product kernel
shape: bf16 on the tensor cores, float32 on the FMA units in full float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "GroupInputs",
    "group_inputs",
    "group_inputs_from_numpy",
    "solve_group",
    "solve_group_reference",
    "gemm_xat",
    "gemm_ga",
    "padded_pitch",
    "launches",
    "validate_grouped_on_gpu",
]

# kernel launches made by solve_group on CUDA tensors (each C entry
# launches one kernel, hts_gemm_xat two in bf16: the cast, then the
# product; a split float32 first product adds its ordered sum)
launches = 0

L3_MAX = 64  # z extent the kernel's per-thread arrays hold (csrc L3MAX)
# the products' tiles, in both dtypes: 256 of the wide side (A_top's rows
# or columns) by up to 128 candidate rows; K slices of 64 (bf16) or 32
# (float32)
_WIDE, _NARROW, _KSTEP, _KSTEP_F32 = 256, 128, 64, 32
_PITCH = 8  # elements a padded row pitch is a multiple of (16 bytes of bf16)


def padded_pitch(n: int) -> int:
    """n rounded up to a multiple of 8: the row pitch of the buffers the
    bf16 products copy in 16-byte pieces."""
    return -(-n // _PITCH) * _PITCH


@dataclasses.dataclass
class GroupInputs:
    """The solve's inputs for G groups of R candidates (candidate-major).
    ``a_top`` is in the compute dtype, its rows contiguous or with a
    padded pitch; the rest is float32 and contiguous."""

    a_top: torch.Tensor  # (G, rows, d3^2), rows = C_u*d2 + O*d3^2
    # (G, R, C_u, l3, l3) multiplicity-weighted z-Gram, or (.., l3, l3, d2)
    # j-dependent (the fsc half-set solves: the pixel-id split inside)
    gz: torch.Tensor
    mz: torch.Tensor  # (G, R, O, l3, l3) per-op z-shift
    af: torch.Tensor  # (G, R, O, l3, d3^2) op-sample validity
    cn: torch.Tensor  # (G, R, O, O) pair-count matrix
    deg: torch.Tensor  # (G, R, O, l3, d3^2) Cn @ af
    mask: torch.Tensor  # (l3, d3^2) cylindrical mask
    rhs: torch.Tensor  # (G, R, l3, d3^2)
    lb: torch.Tensor  # (G, R)
    ub: torch.Tensor  # (G, R)
    bn: torch.Tensor  # (G, R) |b_eff|
    d2: int

    @property
    def shape(self):
        """(G, R, C_u, O, l3, d3^2)."""
        G, R, C_u, l3 = self.gz.shape[:4]
        return G, R, C_u, self.mz.shape[2], l3, self.mask.shape[1]

    @property
    def gz_stride(self) -> int:
        """The z-Gram's element stride: 1, or d2 where it depends on j."""
        return self.d2 if self.gz.dim() == 6 else 1

    @classmethod
    def empty(cls, G: int, like: "GroupInputs"):
        """Uninitialised inputs for G groups shaped as ``like``'s groups.
        ``a_top`` is the [..., :d3^2] view of a (G, rows, padded_pitch(d3^2))
        buffer whose padding is zero."""
        kw = {
            f.name: torch.empty((G,) + getattr(like, f.name).shape[1:],
                                dtype=getattr(like, f.name).dtype,
                                device=getattr(like, f.name).device)
            for f in dataclasses.fields(cls) if f.name not in ("mask", "d2", "a_top")
        }
        _, rows, d3sq = like.a_top.shape
        buf = torch.empty((G, rows, padded_pitch(d3sq)), dtype=like.a_top.dtype,
                          device=like.a_top.device)
        buf[..., d3sq:].zero_()
        return cls(a_top=buf[..., :d3sq], mask=like.mask, d2=like.d2, **kw)

    def put(self, g: int, one: "GroupInputs") -> None:
        """Copy the single group ``one`` into slot g."""
        for f in dataclasses.fields(self):
            if f.name not in ("mask", "d2"):
                getattr(self, f.name)[g].copy_(getattr(one, f.name)[0])


def group_inputs(shared, tens) -> GroupInputs:
    """The solve's inputs for one group (G = 1) from build_group_shared
    and build_candidate_tensors_grouped, plus the (R,) box bounds
    tens["lb"], tens["ub"]. Counterpart of grouped_pallas_inputs. Without
    "rhs" (the matvec factors alone) rhs, lb, ub and b_norm are zeros."""
    R = tens["Gz"].shape[0]
    l3, d3sq = shared["mask_f"].shape[0], shared["A_top"].shape[1]
    dev = shared["A_top"].device
    if "rhs" in tens:
        rhs, lb, ub, bn = (tens[k] for k in ("rhs", "lb", "ub", "b_norm"))
    else:
        rhs = torch.zeros((R, l3, d3sq), device=dev)
        lb = ub = bn = torch.zeros(R, device=dev)
    return GroupInputs(
        a_top=shared["A_top"][None],
        gz=tens["Gz"].float()[None],
        mz=tens["Mz_ops"].float()[None],
        af=tens["a_f"].float()[None],
        cn=tens["Cn"].float()[None],
        deg=tens["deg"].float()[None],
        mask=shared["mask_f"].reshape(l3, d3sq),
        rhs=rhs[None],
        lb=lb[None],
        ub=ub[None],
        bn=bn[None],
        d2=shared["Wsum"].shape[1],
    )


def group_inputs_from_numpy(shared_np, tens_np):
    """The same inputs, as float32 CPU tensors, from the JAX package's
    build_group_shared / build_candidate_tensors_grouped outputs (as numpy;
    tens_np stacked over the R candidates and holding 'lb'/'ub'), so both
    solvers can be fed identical operators."""

    def t(x):
        return torch.as_tensor(np.array(x, np.float32))

    shared = {k: t(shared_np[k]) for k in ("mask_f", "Wsum", "A_top")}
    return group_inputs(shared, {k: t(v) for k, v in tens_np.items()})


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _data_mix(inp: GroupInputs, t_d: torch.Tensor) -> torch.Tensor:
    """u[m, c, j] = sum_n Gz[c, m, n(, j)] t_d[n, c, j] per candidate."""
    G, R, C_u, O, l3, d3sq = inp.shape
    t_d = t_d.reshape(G, R, l3, C_u, inp.d2)
    eq = "grcmnj,grncj->grmcj" if inp.gz.dim() == 6 else "grcmn,grncj->grmcj"
    return torch.einsum(eq, inp.gz, t_d).reshape(G, R, l3, -1)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[..., None, None]


def matvec_reference(inp: GroupInputs, X: torch.Tensor, masked: bool = True,
                     l2: torch.Tensor | None = None) -> torch.Tensor:
    """(NTN(X) + l2 X) for X (G, R, l3, d3^2) float32 (times the mask if
    masked; l2 a (G, R) column or None), with the kernel's rounding points:
    X and [u; gs] in the compute dtype, every product accumulated in
    float32, the ridge term on X in float32."""
    G, R, C_u, O, l3, d3sq = inp.shape
    nd = C_u * inp.d2
    cdt = inp.a_top.dtype
    A = inp.a_top.float()
    T = torch.einsum("grmk,gnk->grmn", X.to(cdt).float(), A)
    u = _data_mix(inp, T[..., :nd])
    ts = T[..., nd:].reshape(G, R, l3, O, d3sq)
    vals = torch.einsum("gromn,grnop->gromp", inp.mz, ts)
    av = inp.af * vals
    cav = torch.einsum("grox,grxmp->gromp", inp.cn, av)
    L = (inp.deg * inp.mask) * av - (inp.af * inp.mask) * cav
    gs = torch.einsum("gromn,gromp->grnop", inp.mz, L).reshape(G, R, l3, O * d3sq)
    Gm = torch.cat([u, gs], dim=-1).to(cdt).float()
    Y = torch.einsum("grmn,gnd->grmd", Gm, A)
    if l2 is not None:
        Y = Y + _col(l2) * X
    return Y * inp.mask if masked else Y


def _margin(power_iters: int) -> float:
    return 1.2 if power_iters >= 4 else (1.5 if power_iters >= 2 else 1.8)


def _fista_coefs(fista_iters: int) -> list:
    """(t - 1) / t_new of FISTA's data-independent t sequence, in float32."""
    out, t = [], np.float32(1.0)
    for _ in range(fista_iters):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def _power_start(rhs: torch.Tensor, power_seed: str) -> torch.Tensor:
    """The power iteration's unnormalised start: rhs, or ones."""
    if power_seed == "rhs":
        return rhs
    if power_seed == "ones":
        return torch.ones_like(rhs)
    raise ValueError(f"power_seed must be 'rhs' or 'ones', not {power_seed!r}")


def solve_group_reference(
    inp: GroupInputs, cg_iters: int, fista_iters: int, power_iters: int,
    l1: torch.Tensor | None = None, l2: torch.Tensor | None = None,
    with_score: bool = True, power_seed: str = "rhs",
):
    """Plain PyTorch version of the grouped solve, with optional (G, R)
    float32 l1 / l2 columns; the power iteration starts from rhs or ones
    (``power_seed``). Returns (x (G, R, l3, d3^2) float32, score (G, R)
    float32; zero without ``with_score``)."""

    def mv(v):
        return matvec_reference(inp, v, l2=l2)

    def csum(a):
        return a.sum(dim=(-2, -1))

    col = _col

    def prox(v):  # the soft-threshold (with l1), then the box
        if l1 is not None:
            v = torch.sign(v) * torch.clamp_min(torch.abs(v) - eta * col(l1), 0.0)
        return torch.clamp(v, lb, ub)

    rhs = inp.rhs
    x = torch.zeros_like(rhs)
    r, p = rhs.clone(), rhs.clone()
    rs = csum(rhs * rhs)
    for _ in range(cg_iters):
        Np = mv(p)
        pNp = csum(p * Np)
        alpha = torch.where(pNp > 0, rs / pNp.clamp_min(1e-30), 0.0)
        x = x + col(alpha) * p
        r = r - col(alpha) * Np
        rs_new = csum(r * r)
        beta = torch.where(rs > 0, rs_new / rs.clamp_min(1e-30), 0.0)
        p = r + col(beta) * p
        rs = rs_new

    lb, ub = col(inp.lb), col(inp.ub)
    if fista_iters > 0:
        v = _power_start(rhs, power_seed)
        v = v / col(torch.sqrt(csum(v * v)).clamp_min(1e-30))
        for _ in range(power_iters):
            w = mv(v)
            v = w / col(torch.sqrt(csum(w * w)).clamp_min(1e-30))
        lips = _margin(power_iters) * csum(v * mv(v))
        eta = col(1.0 / lips.clamp_min(1e-20))
        x = torch.clamp(x, lb, ub)
        y = x
        for coef in _fista_coefs(fista_iters):
            g = mv(y) - rhs
            x_new = prox(y - eta * g)
            y = x_new + coef * (x_new - x)
            x = x_new
    else:
        x = torch.clamp(x, lb, ub)
    x = x * inp.mask
    if not with_score:
        return x, torch.zeros_like(inp.bn)

    # cosine without the reprojection: <P x, b> = <x, rhs>,
    # |P x|^2 = <t_d, Gz mix t_d> (data columns of the first product)
    nd = inp.gz.shape[2] * inp.d2
    cdt = inp.a_top.dtype
    t_d = torch.einsum("grmk,gnk->grmn", x.to(cdt).float(), inp.a_top[:, :nd].float())
    den2 = csum(t_d * _data_mix(inp, t_d))
    num = csum(x * rhs)
    den = torch.sqrt(den2.clamp_min(0.0)) * inp.bn
    score = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    return x, score


# ---------------------------------------------------------------------------
# the CUDA kernel path
# ---------------------------------------------------------------------------


def _rows_layout_ok(a: torch.Tensor) -> bool:
    """a (G, rows, n) is contiguous, or the [..., :n] view of rows whose
    pitch is a multiple of 8 elements."""
    if a.is_contiguous():
        return True
    G, rows, n = a.shape
    P = a.stride(1)
    return (a.stride(2) == 1 and P % _PITCH == 0 and P >= n
            and (G == 1 or a.stride(0) == rows * P))


def _check_cuda_inputs(inp: GroupInputs) -> None:
    G, R, C_u, O, l3, d3sq = inp.shape
    dev = inp.a_top.device
    if inp.a_top.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a_top must be float32 or bfloat16, got {inp.a_top.dtype}")
    if l3 > L3_MAX:
        raise ValueError(f"l3 = {l3} exceeds the kernel's {L3_MAX}")
    gz_shapes = ((G, R, C_u, l3, l3), (G, R, C_u, l3, l3, inp.d2))
    if tuple(inp.gz.shape) not in gz_shapes:
        raise ValueError(f"gz shape {tuple(inp.gz.shape)} is neither of {gz_shapes}")
    for f in dataclasses.fields(inp):
        t = getattr(inp, f.name)
        if f.name in ("d2", "a_top"):
            continue
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{f.name} must be a contiguous tensor on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{f.name} must be float32, got {t.dtype}")
    if inp.a_top.shape != (G, C_u * inp.d2 + O * d3sq, d3sq):
        raise ValueError(f"a_top shape {tuple(inp.a_top.shape)} does not match the group")
    if not _rows_layout_ok(inp.a_top):
        raise ValueError(f"a_top (strides {inp.a_top.stride()}) must be contiguous or the "
                         "[..., :d3^2] view of rows whose pitch is a multiple of 8 elements")
    if inp.a_top.dtype == torch.bfloat16 and (d3sq % 2 or inp.d2 % 2):
        raise ValueError("the bf16 kernel copies element pairs: d3^2 and d2 must be even")


def _count(kernels: int) -> None:
    global launches
    launches += kernels


def sm_count(dev: torch.device) -> int:
    """The number of SMs of the CUDA device dev."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def k_split(G: int, M: int, K: int, N: int, n_sm: int, nsplit: int | None = None):
    """(kchunk, nsplit) of the second product (G groups of M x K by K x N)
    on a card of n_sm SMs: K is split so that G * tiles * splits fills the
    card (one tile per SM at a time, in either dtype) twice over, each
    split covering >= 8 K slices of 64; or into ``nsplit`` parts if
    given. kchunk is a multiple of 64 (of both dtypes' K slices)."""
    k_tiles = -(-K // _KSTEP)
    if nsplit is None:
        tiles = G * -(-M // _NARROW) * -(-N // _WIDE)
        nsplit = max(1, min(-(-2 * n_sm // tiles), k_tiles // 8))
    kchunk = -(-k_tiles // max(1, min(nsplit, k_tiles))) * _KSTEP
    return kchunk, -(-K // kchunk)


def x_split(G: int, M: int, N: int, K: int, n_sm: int):
    """(kchunk, nsplit) of the float32 first product (G groups of M x K by
    K x N) on a card of n_sm SMs: no split while G * tiles fills the card;
    else K (d3^2) is split into the number of parts, each >= 8 K slices of
    32, whose blocks fill the card's waves best (the fewest on a tie), so
    that a short launch (one group: 83 tiles on 132 SMs) does not leave
    SMs idle. kchunk is a multiple of 64."""
    tiles = G * -(-M // _NARROW) * -(-N // _WIDE)
    k_slices = -(-K // _KSTEP_F32)
    if tiles >= n_sm or k_slices < 16:
        return K, 1

    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // n_sm) * n_sm)

    s = max(range(1, k_slices // 8 + 1), key=lambda s: (fill(s), -s))
    kchunk = -(-K // (s * _KSTEP)) * _KSTEP
    return kchunk, -(-K // kchunk)


def _xat(run, X, A, out, xb, N: int) -> None:
    """Launch out[g, m, n] = sum_k X[g, m, k] A[g, n, k] for n < N (the
    first product): X (G, M, d3^2) or (G, R, l3, d3^2) float32 contiguous,
    A (G, rows, d3^2) with unit last stride, out (G, M, rows) float32, xb
    the (G, M, ldx) scratch for bf16(X) (None in float32). A float32
    product that x_split splits goes through a (nsplit, G, M, rows) buffer
    and an ordered sum into out (no atomics: it repeats bit for bit)."""
    G, rows, K = A.shape
    M = X.numel() // (G * K)
    bf16 = int(A.dtype == torch.bfloat16)
    kchunk, nsplit = (K, 1) if bf16 else x_split(G, M, N, K, sm_count(A.device))
    part = out if nsplit == 1 else torch.empty((nsplit, G, M, rows), dtype=torch.float32,
                                               device=A.device)
    run("hts_gemm_xat", X, A, part, xb, G, M, N, K, rows, A.stride(1),
        xb.stride(1) if bf16 else K, kchunk, nsplit, bf16, kernels=1 + bf16)
    if nsplit > 1:
        run("hts_reduce_mask", part, None, None, None, out, nsplit, G, M, rows, 1)


def _ga(run, Gm, A, part, kchunk: int, nsplit: int) -> None:
    """Launch part[s, g, m, n] = sum_{k in split s} Gm[g, m, k] A[g, k, n]
    (the second product): Gm (G, M, >= rows) in A's dtype, A (G, rows,
    d3^2), both with unit last stride; part (nsplit, G, M, d3^2) float32."""
    G, M, _ = Gm.shape
    rows, d3sq = A.shape[1:]
    run("hts_gemm_ga", Gm, A, part, G, M, d3sq, rows, Gm.stride(1), A.stride(1), kchunk, nsplit,
        int(A.dtype == torch.bfloat16))


def _check_product(A: torch.Tensor, *others) -> None:
    if A.dtype not in (torch.float32, torch.bfloat16) or not _rows_layout_ok(A):
        raise ValueError("A must be float32 or bfloat16, contiguous or a view of rows whose "
                         "pitch is a multiple of 8 elements")
    for t in (A,) + others:
        if t.device != A.device or t.stride(-1) != 1 or (A.dtype == torch.bfloat16
                                                         and t.stride(1) % 2):
            raise ValueError("the products take tensors on one device with unit last stride "
                             "(and even row pitches in bf16)")


def gemm_xat(X: torch.Tensor, A: torch.Tensor, N: int | None = None) -> torch.Tensor:
    """The first product alone: T (G, M, N) float32 = X . A[:, :N]^T, with X
    (G, M, d3^2) float32 rounded to A's dtype and A (G, rows, d3^2) (N
    defaults to rows). CPU tensors run the plain version; CUDA tensors the
    kernel (never the plain version)."""
    rows = A.shape[1]
    N = rows if N is None else N
    if A.device.type == "cpu":
        return torch.einsum("gmk,gnk->gmn", X.to(A.dtype).float(), A[:, :N].float())
    _check_product(A, X)
    from .._build import Launcher

    G, M, K = X.shape
    out = torch.empty((G, M, rows), dtype=torch.float32, device=A.device)
    xb = (torch.empty((G, M, padded_pitch(K)), dtype=A.dtype, device=A.device)
          if A.dtype == torch.bfloat16 else None)
    _xat(Launcher(A.device, _count), X.float().contiguous(), A, out, xb, N)
    return out[..., :N]


def gemm_ga(Gm: torch.Tensor, A: torch.Tensor, nsplit: int | None = None) -> torch.Tensor:
    """The second product alone, before its split reduction: part
    (nsplit, G, M, d3^2) float32 whose sum over the splits, in order, is
    Gm . A, for Gm (G, M, rows) and A (G, rows, d3^2) in one dtype. nsplit
    defaults to solve_group's choice. CPU tensors run the plain version
    (one split); CUDA tensors the kernel."""
    if A.device.type == "cpu":
        return torch.einsum("gmr,grd->gmd", Gm.float(), A.float())[None]
    _check_product(A, Gm)
    if Gm.dtype != A.dtype:
        raise TypeError(f"Gm ({Gm.dtype}) and A ({A.dtype}) must share a dtype")
    from .._build import Launcher

    G, M, rows = Gm.shape
    kchunk, nsplit = k_split(G, M, rows, A.shape[2], sm_count(A.device), nsplit)
    part = torch.empty((nsplit, G, M, A.shape[2]), dtype=torch.float32, device=A.device)
    _ga(Launcher(A.device, _count), Gm, A, part, kchunk, nsplit)
    return part


def solve_group(
    inp: GroupInputs, cg_iters: int, fista_iters: int, power_iters: int,
    l1: torch.Tensor | None = None, l2: torch.Tensor | None = None,
    with_score: bool = True, power_seed: str = "rhs",
):
    """Grouped solve and score. l1 / l2: optional (G, R) float32 columns
    (FISTA's soft-threshold; the ridge term of every matvec); without
    ``with_score`` the score is zero and its product is skipped;
    ``power_seed`` starts the power iteration from rhs or ones. CPU
    tensors run the plain version; CUDA tensors run the kernels of
    csrc/group_solve.cu (never the plain version). Returns (x (G, R, l3,
    d3^2), score (G, R)), float32."""
    if inp.a_top.device.type == "cpu":
        return solve_group_reference(inp, cg_iters, fista_iters, power_iters, l1, l2, with_score,
                                     power_seed)
    if inp.a_top.device.type != "cuda":
        raise ValueError(f"solve_group runs on cpu or cuda, not {inp.a_top.device}")
    from .._build import Launcher

    _check_cuda_inputs(inp)
    if power_seed not in ("rhs", "ones"):
        raise ValueError(f"power_seed must be 'rhs' or 'ones', not {power_seed!r}")
    for name, c in (("l1", l1), ("l2", l2)):
        if c is not None and (c.shape != inp.lb.shape or c.dtype != torch.float32
                              or c.device != inp.a_top.device or not c.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (G, R) float32 column on the card")
    G, R, C_u, O, l3, d3sq = inp.shape
    nd = C_u * inp.d2
    rows = inp.a_top.shape[1]
    M = R * l3
    ncand = G * R
    n = l3 * d3sq
    bf16 = int(inp.a_top.dtype == torch.bfloat16)
    dev = inp.a_top.device
    f32 = dict(dtype=torch.float32, device=dev)
    run = Launcher(dev, _count)

    kchunk, nsplit = k_split(G, M, rows, d3sq, sm_count(dev))
    T = torch.empty((G, M, rows), **f32)
    # [u; gs] and bf16(X) with 16-byte row pitches
    Gm = torch.empty((G, M, padded_pitch(rows)), dtype=inp.a_top.dtype, device=dev)
    xb = (torch.empty((G, M, padded_pitch(d3sq)), dtype=inp.a_top.dtype, device=dev)
          if bf16 else None)
    part = torch.empty((nsplit, G, M, d3sq), **f32)
    x, r, p, q, w = (torch.empty((G, R, l3, d3sq), **f32) for _ in range(5))
    rs, eta, score = (torch.empty((G, R), **f32) for _ in range(3))
    ldg = Gm.stride(1)
    js = inp.gz_stride

    def matvec(src, dst):
        _xat(run, src, inp.a_top, T, xb, rows)
        run("hts_glue_data", T, inp.gz, Gm, G, R, l3, C_u, inp.d2, rows, ldg, js, bf16)
        run("hts_glue_sym", T, inp.mz, inp.af, inp.cn, inp.deg, inp.mask, Gm,
            G, R, l3, nd, O, d3sq, rows, ldg, bf16)
        _ga(run, Gm, inp.a_top, part, kchunk, nsplit)
        run("hts_reduce_mask", part, inp.mask, None if l2 is None else src, l2, dst, nsplit, G,
            M, d3sq, l3)

    run("hts_cg_init", inp.rhs, x, r, p, rs, ncand, n)
    for _ in range(cg_iters):
        matvec(p, q)
        run("hts_cg_step", x, r, p, q, rs, ncand, n)
    if fista_iters > 0:
        # v in r, from rhs or from ones (filled into w, which the first
        # matvec overwrites)
        start = inp.rhs if power_seed == "rhs" else w.fill_(1.0)
        run("hts_normalize", r, start, ncand, n)
        for _ in range(power_iters):
            matvec(r, w)
            run("hts_normalize", r, w, ncand, n)
        matvec(r, w)
        run("hts_rayleigh", r, w, eta, _margin(power_iters), ncand, n)
        run("hts_fista_init", x, p, inp.lb, inp.ub, ncand, n)
        for coef in _fista_coefs(fista_iters):  # y in p
            matvec(p, q)
            run("hts_fista_step", x, p, q, inp.rhs, eta, inp.lb, inp.ub, l1, coef, ncand, n)
    else:
        run("hts_fista_init", x, p, inp.lb, inp.ub, ncand, n)
    run("hts_apply_mask", x, inp.mask, ncand, n)
    if not with_score:
        return x, score.zero_()
    # score: the data columns of the first product, then the Gz mix
    _xat(run, x, inp.a_top, T, xb, nd)
    run("hts_score", T, inp.gz, x, inp.rhs, inp.bn, score, G, R, l3, C_u, inp.d2, rows, n, js)
    return x, score


# ---------------------------------------------------------------------------
# the standing check of the grouped envelope on the card
# ---------------------------------------------------------------------------

# the configurations of validate_grouped_on_device (pallas_solver.py:1058)
VALIDATE_CONFIGS = dict(
    default=dict(),
    fsc=dict(fsc_test=2),
    ridge=dict(model="ridge", l2_reg=0.05),
    lasso=dict(model="lasso", l1_reg=1e-4, reg_per_row=True),
    elasticnet=dict(model="elasticnet", l1_reg=5e-5, l2_reg=5e-5, reg_per_row=True),
    lreg=dict(model="lreg"),
    thresh=dict(thresh_fraction=0.1),
    ssim=dict(score_metric="ssim"),
)


def validate_grouped_on_gpu(device="cuda") -> dict:
    """Score one small self-contained twist group (the reference's
    validate_grouped_on_device: a simulated image, d2 = 14, l2 = 32,
    d3 = 12, l3 = 4, eight rises, cg / fista / power 6 / 8 / 2, float32)
    under each configuration of VALIDATE_CONFIGS twice on the card: the
    kernel route (solve_group) and the plain route (solve_group_reference
    on the same CUDA tensors), through the grid's grouped scorer. Returns
    one ``v3_<name>_abs_err`` per configuration (``v3_score_abs_err`` for
    the default), and ok: every error under 5e-3. Raises without a card."""
    from ..helix import simulate_helical_projection
    from . import grid
    from .geometry import ReconstructionGeometry, estimate_copy_pair_counts, estimate_n_pair_ops
    from .solver import SolveConfig

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("validate_grouped_on_gpu needs a CUDA device")
    img = simulate_helical_projection(
        n=1, twist=29.4, rise=4.75, csym=1, helical_diameter=100.0, ball_radius=6.0,
        polymer=0, planarity=1.0, ny=64, nx=128, apix=2.0, rng=0, device=device,
    )
    geom = ReconstructionGeometry(d2=14, l2=32, d3=12, l3=4, rmin=0.0, rmax=5.0,
                                  scale2d_to_3d=0.858, csym=1)
    region = img[: geom.d2, : geom.l2].astype(np.float32)
    rises = np.asarray([1.0, 1.05, 1.1, 1.15, 1.2, 1.25, 1.3, 1.35], np.float32)
    twists = np.full(len(rises), 29.4, np.float32)
    n_copies, n_pairs = estimate_copy_pair_counts(geom, float(rises.min()), 8,
                                                  rise_pixel_max=float(rises.max()))
    n_ops = estimate_n_pair_ops(geom, float(rises.min()))
    out = {"device": torch.cuda.get_device_name(device)}
    ok = True
    for name, kw in VALIDATE_CONFIGS.items():
        cfg = SolveConfig(interpolation="nn", cg_iters=6, fista_iters=8, power_iters=2,
                          separable=True, compute_dtype="float32", **kw)
        s = [grid._tf32_off(grid._grouped_scoring)(
                geom, cfg, twists, rises, n_copies, n_pairs, n_ops, region, np.float32(0.0), {},
                device, solve=f)[0]
             for f in (solve_group, solve_group_reference)]
        err = float(np.abs(s[0] - s[1]).max())
        out["v3_score_abs_err" if name == "default" else f"v3_{name}_abs_err"] = err
        ok = ok and bool(np.all(np.isfinite(s[0]))) and err < 5e-3
    out["ok"] = bool(ok)
    return out
