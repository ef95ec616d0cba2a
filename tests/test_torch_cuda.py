"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit and skips
without one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py configures JAX for the other tests.)
Tolerances: float32 scores 1e-4 and x 1e-3 relative (the kernel sums in
another order than cuBLAS); bf16 A_top scores 1e-3 and x 5e-3 relative
(both versions round to bf16 at the same points; a sum in another order
can still flip one rounding).
"""

import numpy as np
import pytest
import torch

from helicon_tpu_torch.denovo3d import candidate_solve as cs
from helicon_tpu_torch.denovo3d import grid
from helicon_tpu_torch.denovo3d import group_solve as gs
from helicon_tpu_torch.denovo3d.geometry import (
    ReconstructionGeometry,
    compute_sym_dedup_mask,
    estimate_copy_pair_counts,
    estimate_n_pair_ops,
    select_copies,
)
from helicon_tpu_torch.denovo3d.projector_grouped import (
    build_candidate_tensors_grouped,
    build_group_shared,
)
from helicon_tpu_torch.denovo3d.projector_separable import build_problem_separable
from helicon_tpu_torch.denovo3d.solver import SolveConfig

pytestmark = pytest.mark.cuda
ITERS = (10, 16, 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _group(device, cdt, csym, n_rises, twist, dy, positive_constraint, seed, d3=20,
           pid_mask=None):
    """One twist group built by the port from a seeded random region (with
    pid_mask (l2, d2): an fsc half-set's j-dependent z-Gram, rhs and |b|)."""
    geom = ReconstructionGeometry(d2=24, l2=64, d3=d3, l3=8, rmin=2.0, rmax=d3 // 2 - 1,
                                  scale2d_to_3d=0.8, csym=csym)
    region = np.random.default_rng(seed).random((geom.d2, geom.l2)).astype(np.float32)
    rises = np.linspace(1.6, 2.0, n_rises).astype(np.float32)
    n_copies, n_pairs = estimate_copy_pair_counts(
        geom, float(rises.min()), 8, rise_pixel_max=float(rises.max())
    )
    n_ops = estimate_n_pair_ops(geom, float(rises.min()))
    u = set()
    for r in rises:
        ch, cc, cv = select_copies(geom, float(r), n_copies)
        u.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    rp, m, ch_u, cc_u, pidx, pval, _ = grid._group_tables(
        geom, twist, rises, n_copies, n_pairs, n_ops, len(u), n_rises, {}
    )
    hmax = (n_ops // csym - 1) // 2
    ops_h = np.repeat(np.arange(-hmax, hmax + 1), csym).astype(np.int32)
    ops_c = np.tile(np.arange(csym), 2 * hmax + 1).astype(np.int32)
    shared = build_group_shared(geom, np.float32(twist), ch_u, cc_u, ops_h, ops_c,
                                np.float32(dy), "nn", geom.cylindrical_mask(),
                                geom.cell_valid_mask(), cdt, device)
    tens = build_candidate_tensors_grouped(shared, geom, region, rp, np.sqrt(m), pidx, pval,
                                           pid_mask=pid_mask)
    tens["lb"], tens["ub"] = grid._box_bounds(
        grid._positive(SolveConfig(positive_constraint=positive_constraint), rp, twist,
                       geom.l3),
        tens["ub_raw"],
    )
    return gs.group_inputs(shared, tens)


# (csym, candidates, twist, dy px, positive_constraint)
CASES = [(1, 13, 29.4, 0.0, -1), (2, 5, -61.0, 0.7, -1), (3, 33, 12.5, 0.0, 0),
         (1, 64, 2.0, 0.0, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"csym{c[0]}_R{c[1]}")
def test_kernel_matches_plain(cuda, dtype, case):
    inp = _group(cuda, getattr(torch, dtype), *case, seed=0)
    launches = gs.launches
    x_k, s_k = gs.solve_group(inp, *ITERS)
    assert gs.launches > launches
    x_p, s_p = gs.solve_group_reference(inp, *ITERS)
    assert bool(torch.isfinite(s_k).all()) and bool(torch.isfinite(x_k).all())
    if dtype == "float32":
        assert float((s_k - s_p).abs().max()) <= 1e-4
        assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-3
    else:
        assert float((s_k - s_p).abs().max()) <= 1e-3
        assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 5e-3


def test_kernel_batch_of_groups(cuda):
    """Groups of one launch are independent: G distinct twist groups give
    each group's result alone, and the plain version's on the batch."""
    csym, n_rises, _, dy, positive_constraint = CASES[1]
    twists = (-61.0, -45.5, -20.25, 10.0, 33.0, 58.5, 75.0)
    ones = [_group(cuda, torch.bfloat16, csym, n_rises, t, dy, positive_constraint, seed=1)
            for t in twists]
    many = gs.GroupInputs.empty(len(ones), ones[0])
    for g, one in enumerate(ones):
        many.put(g, one)
    x_k, s_k = gs.solve_group(many, *ITERS)
    assert torch.unique(s_k[:, 0]).numel() == len(twists)
    for g, one in enumerate(ones):
        _, s1 = gs.solve_group(one, *ITERS)
        assert float((s_k[g] - s1[0]).abs().max()) <= 1e-3
    x_p, s_p = gs.solve_group_reference(many, *ITERS)
    assert float((s_k - s_p).abs().max()) <= 1e-3
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 5e-3


def test_reconstruct_grid_cuda_matches_cpu(cuda):
    """The whole search in float32 on the card against the CPU run."""
    img = np.load(__file__.rsplit("/", 1)[0] + "/data/class_avg_amyloid.npy")
    tw = np.repeat(np.asarray([2.0, 2.25], np.float32), 3)
    ri = np.tile(np.asarray([4.6, 4.75, 4.9], np.float32), 2)
    kw = dict(apix=2.0, twists=tw, rises=ri, tube_diameter=110.0, cg_iters=10,
              fista_iters=16, power_iters=2, compute_dtype="float32")
    on_card = grid.reconstruct_grid(img, device=cuda, **kw)
    on_host = grid.reconstruct_grid(img, device="cpu", **kw)
    np.testing.assert_allclose(on_card.scores, on_host.scores, atol=1e-4)
    assert on_card.best_index == on_host.best_index
    rel = np.abs(on_card.best_volume - on_host.best_volume).max() / np.abs(
        on_host.best_volume).max()
    assert rel < 1e-3, rel


def _candidates(device, interpolation, twists, rise=1.7, csym=2, seed=0):
    """build_problem_separable outputs of a few candidates of one shape,
    with the tables and the dedup mask the best-volume re-solve uses."""
    geom = ReconstructionGeometry(d2=24, l2=64, d3=20, l3=8, rmin=2.0, rmax=9.0,
                                  scale2d_to_3d=0.8, csym=csym)
    region = np.random.default_rng(seed).random((geom.d2, geom.l2)).astype(np.float32)
    n_copies, n_pairs = estimate_copy_pair_counts(geom, rise, 8)
    n_ops = estimate_n_pair_ops(geom, rise)
    tw = np.asarray(twists, np.float32)
    tabs = grid._candidate_tables(geom, tw, np.full(len(tw), rise, np.float32), n_copies,
                                  n_pairs, n_ops)
    out = []
    for i, t in enumerate(tw):
        ch, cc, cv, phc, pv, ops_hc, ops_v, pidx = (a[i] for a in tabs)
        keep = compute_sym_dedup_mask(geom, float(t), rise, phc, pv) if interpolation == "nn" else None
        ops = build_problem_separable(geom, region, t, np.float32(rise), ch, cc, cv, phc, pv, 0.0,
                                      interpolation, geom.cylindrical_mask(),
                                      geom.cell_valid_mask(), pair_ops=(ops_hc, ops_v, pidx),
                                      sym_keep=keep, device=device)
        out.append((geom, float(t), rise, ops, (ch, cc, cv, ops_hc)))
    return out


def _rhs_scal(ops, l2_reg, l1_reg):
    rowv = ops["row_valid"].float()
    b_eff = ops["b"][None] * rowv
    return ops["PT"](b_eff) * ops["mask"].float(), (l2_reg, l1_reg, 0.0, float(b_eff.max()))


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_solve_candidate_kernel_matches_plain(cuda, dtype, interpolation):
    cdt = getattr(torch, dtype)
    items = []
    for _, _, _, ops, _ in _candidates(cuda, interpolation, (-61.0, 12.5, 33.0)):
        rhs, scal = _rhs_scal(ops, 0.01, 0.001)
        items.append(cs.candidate_inputs(ops["factors"], cdt, rhs, scal))
    inp = cs.CandidateInputs.stack(items)
    before = cs.launches["solve_candidate"]
    x_k = cs.solve_candidate_kernel(inp, *ITERS)
    assert cs.launches["solve_candidate"] > before
    assert torch.equal(x_k, cs.solve_candidate_kernel(inp, *ITERS))  # repeats bit for bit
    x_p = cs.solve_candidate_reference(inp, *ITERS)
    assert bool(torch.isfinite(x_k).all())
    rel = float((x_k - x_p).abs().max() / x_p.abs().max())
    assert rel <= (1e-3 if dtype == "float32" else 5e-3), rel
    one = cs.solve_candidate_kernel(items[1], *ITERS)
    assert float((one[0] - x_k[1]).abs().max() / x_p.abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_candidate_kernel_matches_plain(cuda, dtype):
    cdt = getattr(torch, dtype)
    fins = []
    for geom, t, rise, ops, (ch, cc, cv, ops_hc) in _candidates(cuda, "nn", (-61.0, 12.5, 33.0)):
        _, scal = _rhs_scal(ops, 0.0, 0.0)
        fins.append(cs.full_kernel_inputs(geom, ops, t, rise, ch, cc, cv, ops_hc, cdt, scal=scal))
    fin = cs.FullInputs.stack(fins)
    assert torch.equal(cs.build_operators(fin), cs.build_operators_reference(fin))
    before = cs.launches["score_candidate"]
    x_k, s_k = cs.score_candidate_kernel(fin, *ITERS)
    assert cs.launches["score_candidate"] > before
    x_p, s_p = cs.score_candidate_reference(fin, *ITERS)
    assert bool(torch.isfinite(s_k).all()) and bool(torch.isfinite(x_k).all())
    rel = float((x_k - x_p).abs().max() / x_p.abs().max())
    if dtype == "float32":
        assert float((s_k - s_p).abs().max()) <= 1e-4 and rel <= 1e-3, (s_k, s_p, rel)
    else:
        assert float((s_k - s_p).abs().max()) <= 1e-3 and rel <= 5e-3, (s_k, s_p, rel)


def test_validate_on_gpu(cuda):
    out = cs.validate_on_gpu()
    assert out["ok"], out


def _product_operands(device, M, padded, seed, dtype, G=3, d3sq=None):
    """Operands of the two products in dtype, rows and d3^2 not multiples
    of any tile: A (G, rows, d3^2) and Gm (G, M, rows) as views of rows
    with 16-byte pitches (padded) or as contiguous tensors whose pitches
    allow only 8-byte copies (bf16: rows 1,004, d3^2 300) or 4-byte copies
    (float32: rows 1,005, d3^2 301); X (G, M, d3^2) float32."""
    rng = np.random.default_rng(seed)
    rows, n = (1004, 300) if dtype == torch.bfloat16 else (1005, 301)
    d3sq = d3sq or n

    def make(shape, pitch):
        buf = torch.zeros(shape[:-1] + (pitch,), dtype=dtype, device=device)
        buf[..., : shape[-1]] = torch.from_numpy(rng.standard_normal(shape, np.float32))
        return buf[..., : shape[-1]]

    pad = gs.padded_pitch if padded else (lambda n: n)
    A = make((G, rows, d3sq), pad(d3sq))
    Gm = make((G, M, rows), pad(rows))
    X = torch.from_numpy(rng.standard_normal((G, M, d3sq), np.float32)).to(device)
    assert (A.stride(1) % 8 == 0) == padded and (Gm.stride(1) % 8 == 0) == padded
    return A, Gm, X


def _assert_float64_close(got, a, b):
    """got against the float64 product a @ b of the same bf16 or float32
    values: each entry within 1e-4 of the sum of the magnitudes of its
    terms, far above float32 accumulation over these depths (<= 1,005
    terms) and far below what a wrong row, column or slice would give."""
    want = torch.matmul(a.double(), b.double())
    scale = torch.matmul(a.double().abs(), b.double().abs())
    err = (got.double() - want).abs()
    assert bool((err <= 1e-4 * scale).all()), float((err / scale).max())


DTYPES = [torch.bfloat16, torch.float32]
# candidate rows: every tile width (8, 16, 32, 48, 80, 128) and two tiles (130)
M_CASES = [6, 13, 30, 40, 78, 80, 100, 130]
PITCHES = dict(argvalues=[True, False], ids=["pitch16B", "pitch8B_bf16_4B_f32"])


@pytest.mark.parametrize("padded", **PITCHES)
@pytest.mark.parametrize("M", M_CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bfloat16", "float32"])
def test_first_product_matches_float64(cuda, dtype, M, padded):
    A, _, X = _product_operands(cuda, M, padded, seed=M, dtype=dtype)
    before = gs.launches
    T = gs.gemm_xat(X, A)
    # bf16: the cast, then the product
    assert gs.launches == before + (2 if dtype == torch.bfloat16 else 1)
    assert torch.equal(T, gs.gemm_xat(X, A))  # repeats bit for bit
    _assert_float64_close(T, X.to(dtype), A.transpose(1, 2))
    assert torch.equal(gs.gemm_xat(X, A, N=333), T[..., :333])


def test_first_product_k_split_matches_float64(cuda):
    """A float32 first product too short to fill the card (one group, 4
    wide tiles) splits its K (5 splits of 320) and sums the splits in
    order: the product and the sum launch, the result repeats bit for
    bit and holds against float64."""
    A, _, X = _product_operands(cuda, 78, True, seed=7, dtype=torch.float32, G=1, d3sq=1444)
    assert gs.x_split(1, 78, A.shape[1], 1444, gs.sm_count(cuda)) == (320, 5)
    before = gs.launches
    T = gs.gemm_xat(X, A)
    assert gs.launches == before + 2
    assert torch.equal(T, gs.gemm_xat(X, A))
    _assert_float64_close(T, X, A.transpose(1, 2))


@pytest.mark.parametrize("nsplit", [1, 4])
@pytest.mark.parametrize("padded", **PITCHES)
@pytest.mark.parametrize("M", M_CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bfloat16", "float32"])
def test_second_product_matches_float64(cuda, dtype, M, padded, nsplit):
    A, Gm, _ = _product_operands(cuda, M, padded, seed=M + 1, dtype=dtype)
    before = gs.launches
    part = gs.gemm_ga(Gm, A, nsplit=nsplit)
    assert gs.launches == before + 1 and part.shape == (nsplit,) + Gm.shape[:2] + A.shape[2:]
    assert torch.equal(part, gs.gemm_ga(Gm, A, nsplit=nsplit))  # no atomics: bit for bit
    _assert_float64_close(part.double().sum(0), Gm, A)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bfloat16", "float32"])
@pytest.mark.parametrize("case", [(7, 6, 21, 1444), (32, 8, 5, 38)], ids=["amyloid", "OL_MAX"])
def test_pair_fold_matches_plain(cuda, dtype, case):
    """The pair fold kernel against the plain fold of _matvec_plain on the
    same tensors: at the amyloid's O*l3 = 42 over 1,444 cells (45 tiles of
    32 and a ragged 4; 126 rows of b1, ragged at 32 rows a chunk) and at
    O*l3 = OL_MAX over 38 cells. float32 within 1e-5 of the largest value
    (sums in another order than cuBLAS's bmm); bf16 within one bf16
    rounding of each value more; repeats bit for bit."""
    O, l3, P, d3sq = case
    assert O * l3 == cs.OL_MAX or (O * l3, d3sq % 32, P * l3 % 32) == (42, 4, 30)
    rng = np.random.default_rng(O)
    k, nd = 3, 10

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)

    T = rand(k, l3, nd + O * d3sq)
    b1 = rand(k, P * l3, O * l3)
    pok = torch.from_numpy((rng.random((k, P * l3, d3sq)) < 0.7).astype(np.float32)).to(cuda)
    before = cs.launches["solve_candidate"]
    got = cs.pair_fold(T, b1, pok, nd, dtype)
    assert cs.launches["solve_candidate"] == before + 1
    assert torch.equal(got, cs.pair_fold(T, b1, pok, nd, dtype))
    ref = cs._pair_fold_plain(T[..., nd:], b1, pok, torch.float32)
    scale = float(ref.abs().max())
    tol = 1e-5 * scale + (2.0**-8 * ref.abs() if dtype == torch.bfloat16 else 0.0)
    assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


def test_padded_a_top_gives_the_contiguous_result(cuda):
    """The padded a_top of GroupInputs.empty (16-byte copies) and the
    contiguous one of group_inputs (8-byte copies: d3^2 = 324) give the
    same solve, bit for bit."""
    one = _group(cuda, torch.bfloat16, *CASES[0], seed=2, d3=18)
    pad = gs.GroupInputs.empty(1, one)
    pad.put(0, one)
    assert one.a_top.is_contiguous() and one.a_top.stride(1) % 8 == 4
    assert pad.a_top.stride(1) == 328
    x1, s1 = gs.solve_group(one, *ITERS)
    x2, s2 = gs.solve_group(pad, *ITERS)
    assert torch.equal(x1, x2) and torch.equal(s1, s2)


def _columns(inp, l1, l2, seed=0):
    """(G, R) l1 / l2 columns of per-candidate values around l1 and l2."""
    G, R = inp.lb.shape
    f = torch.from_numpy(np.random.default_rng(seed).uniform(0.5, 1.5, (2, G, R)).astype(
        np.float32)).to(inp.lb.device)
    return (None if l1 is None else f[0] * l1), (None if l2 is None else f[1] * l2)


# (l1, l2, with_score, fsc half-set): the options of the grouped solve
OPTIONS = {"l2": (None, 0.05, True, False), "l1_l2_no_score": (0.02, 0.05, False, False),
           "l1": (0.02, None, True, False), "fsc_half": (None, None, True, True)}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [CASES[0], CASES[2]], ids=lambda c: f"csym{c[0]}_R{c[1]}")
def test_kernel_options_match_plain(cuda, dtype, case, option):
    """B1 with l1 / l2 columns, without the score, and with the
    j-dependent z-Gram of an fsc half-set against its plain version on the
    same tensors (phase 2's gates)."""
    l1, l2, with_score, half = OPTIONS[option]
    pid = None
    if half:  # fsc mode 2's first half: even pixel ids
        pid = (np.arange(64 * 24).reshape(64, 24) % 2 == 0).astype(np.float32)
    inp = _group(cuda, getattr(torch, dtype), *case, seed=3, pid_mask=pid)
    assert inp.gz_stride == (24 if half else 1)
    c1, c2 = _columns(inp, l1, l2)
    launches = gs.launches
    x_k, s_k = gs.solve_group(inp, *ITERS, l1=c1, l2=c2, with_score=with_score)
    assert gs.launches > launches
    x_p, s_p = gs.solve_group_reference(inp, *ITERS, l1=c1, l2=c2, with_score=with_score)
    assert bool(torch.isfinite(x_k).all()) and bool(x_k.abs().max() > 0)
    if not with_score:
        assert not bool(s_k.any()) and not bool(s_p.any())
    score_tol, x_tol = (1e-4, 1e-3) if dtype == "float32" else (1e-3, 5e-3)
    assert float((s_k - s_p).abs().max()) <= score_tol
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= x_tol


def test_zero_columns_give_the_plain_solve_bit_for_bit(cuda):
    """l1 = l2 = 0 columns reduce the options to the lsq solve exactly:
    the ridge term adds 0 * x, the soft-threshold subtracts 0."""
    inp = _group(cuda, torch.bfloat16, *CASES[0], seed=4)
    x1, s1 = gs.solve_group(inp, *ITERS)
    zero = torch.zeros_like(inp.lb)
    x2, s2 = gs.solve_group(inp, *ITERS, l1=zero, l2=zero)
    assert torch.equal(x1, x2) and torch.equal(s1, s2)


def test_validate_grouped_on_gpu(cuda):
    out = gs.validate_grouped_on_gpu()
    assert out["ok"], out
    assert len([k for k in out if k.startswith("v3_")]) == len(gs.VALIDATE_CONFIGS)


@pytest.mark.parametrize("config", ["lasso", "ssim", "fsc"])
def test_reconstruct_grid_envelope_cuda_matches_cpu(cuda, config):
    """Envelope searches in float32 on the card against the CPU run."""
    img = np.load(__file__.rsplit("/", 1)[0] + "/data/class_avg_amyloid.npy")
    tw = np.repeat(np.asarray([2.0, 2.25], np.float32), 3)
    ri = np.tile(np.asarray([4.6, 4.75, 4.9], np.float32), 2)
    kw = dict(apix=2.0, twists=tw, rises=ri, tube_diameter=110.0, cg_iters=10,
              fista_iters=16, power_iters=2, compute_dtype="float32",
              **dict(lasso=dict(algorithm=dict(model="lasso", alpha=1e-3)),
                     ssim=dict(score_metric="ssim"), fsc=dict(fsc_test=2))[config])
    on_card = grid.reconstruct_grid(img, device=cuda, **kw)
    on_host = grid.reconstruct_grid(img, device="cpu", **kw)
    np.testing.assert_allclose(on_card.scores, on_host.scores, atol=1e-4)
    assert on_card.effective["retry_rounds"] == on_host.effective["retry_rounds"]
    assert on_card.best_index == on_host.best_index


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_candidate_matvec_matches_plain(cuda, dtype):
    """B2's matvec entry (l2 = 0: ard's normal operator) against its plain
    version: float32 relative 1e-5, bf16 1e-3."""
    cdt = getattr(torch, dtype)
    items = []
    for _, _, _, ops, _ in _candidates(cuda, "nn", (-61.0, 12.5, 33.0)):
        rhs, scal = _rhs_scal(ops, 0.01, 0.0)
        items.append(cs.candidate_inputs(ops["factors"], cdt, rhs, scal))
    inp = cs.CandidateInputs.stack(items)
    v = torch.rand(inp.rhs.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = cs.launches["candidate_matvec"]
    got = cs.candidate_matvec(inp, v)
    assert cs.launches["candidate_matvec"] > before
    k, C = inp.shape[:2]
    want = cs._matvec_plain(inp.a_top, inp.gz, inp.b1, inp.pok, inp.mask,
                            torch.zeros(k, device=cuda), v, cdt, C * inp.d2)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= (1e-5 if dtype == "float32" else 1e-3), rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_solve_candidate_kernel_j_dependent_gz_matches_plain(cuda, dtype):
    """B2 on an fsc half's j-dependent z-Gram (k, C, l3, l3, d2) against its
    plain version, with l1 and l2 (phase 2's gates)."""
    from helicon_tpu_torch.denovo3d.solver import _pid_split_masks

    cdt = getattr(torch, dtype)
    cands = _candidates(cuda, "nn", (-61.0, 12.5, 33.0))
    geom = cands[0][0]
    m = torch.as_tensor(_pid_split_masks(geom, 2)[1][0], device=cuda)
    items = []
    for _, _, _, ops, _ in cands:
        rowv = ops["row_valid"].float() * m
        rhs = ops["PT"](ops["b"][None] * rowv) * ops["mask"].float()
        mz = ops["factors"]["Mz"].float()
        gz = torch.einsum("cim,cin,ij->cmnj", mz, mz, m)
        items.append(cs.candidate_inputs(ops["factors"], cdt, rhs,
                                         (0.01, 0.001, 0.0, float(ops["b"].max())), gz=gz))
    inp = cs.CandidateInputs.stack(items)
    assert inp.gz_stride == geom.d2
    x_k = cs.solve_candidate_kernel(inp, *ITERS)
    x_p = cs.solve_candidate_reference(inp, *ITERS)
    assert bool(torch.isfinite(x_k).all())
    rel = float((x_k - x_p).abs().max() / x_p.abs().max())
    assert rel <= (1e-3 if dtype == "float32" else 5e-3), rel


@pytest.mark.parametrize("config", ["lsq", "tilt", "ard", "elasticnet_fsc"])
def test_percand_search_cuda_matches_cpu(cuda, config, monkeypatch):
    """Per-candidate searches (HELICON_GRID_GROUPED=0) in float32 on the
    card against the CPU run: scores within 1e-4, B2 launched on the card
    for the separable configurations."""
    from helicon_tpu_torch.helix import simulate_helical_projection

    monkeypatch.setenv("HELICON_GRID_GROUPED", "0")
    img = simulate_helical_projection(
        n=1, twist=30.0, rise=6.0, csym=1, helical_diameter=40.0, ball_radius=5.0, polymer=0,
        planarity=1.0, ny=48, nx=96, apix=2.0, rng=0, device="cpu")
    kw = dict(apix=2.0, twists=np.float32([29.5, 31.0]), rises=np.float32([6.0, 6.0]),
              tube_diameter=44.0, sym_oversample=2, cg_iters=10, fista_iters=16, power_iters=2,
              compute_dtype="float32", return_best_volume=False,
              **dict(lsq={}, tilt=dict(tilt=3.0), ard=dict(algorithm=dict(model="ard")),
                     elasticnet_fsc=dict(algorithm=dict(model="elasticnet"), fsc_test=2))[config])
    on_card = grid.reconstruct_grid(img, device=cuda, **kw)
    on_host = grid.reconstruct_grid(img, device="cpu", **kw)
    assert on_card.effective["path"] == on_host.effective["path"] == "percand"
    np.testing.assert_allclose(on_card.scores, on_host.scores, atol=1e-4)
    assert (on_card.effective["b2_launches"] > 0) == (config != "tilt")


# ---------------------------------------------------------------------------
# the gather projector's kernels K1 / K2 / K4 and the pose Jacobian K3
# ---------------------------------------------------------------------------

# (name, geometry fields, candidates): small; the production d3 = 64, l3 =
# 18 volume (295 KB, past the kernels' shared memory); the amyloid's
GATHER_GEOMS = [
    ("small", dict(d2=24, l2=48, d3=20, l3=8, rmax=9, scale2d_to_3d=0.8, csym=2), 3),
    ("big_volume", dict(d2=32, l2=64, d3=64, l3=18, rmax=31, scale2d_to_3d=1.0, csym=1), 2),
    ("amyloid", dict(d2=56, l2=256, d3=38, l3=6, rmax=18, scale2d_to_3d=2 / 3, csym=1), 1),
]


def _gather_case(device, fields, k, interpolation, seed, twists=None, pose=None,
                 sym: bool = False):
    """k candidates' gather tables at random poses (or the given ones), a
    masked random volume each and random ray values, on device; with sym
    also their symmetry tables (last)."""
    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    geom = ReconstructionGeometry(rmin=0.0, **fields)
    rng = np.random.default_rng(seed)
    tw = rng.uniform(-3, 3, k).astype(np.float32) if twists is None else np.float32(twists)
    ri = rng.uniform(1.4, 1.7, k).astype(np.float32)
    n_copies, n_pairs = estimate_copy_pair_counts(geom, float(ri.min()), 8,
                                                  rise_pixel_max=float(ri.max()))
    ch, cc, cv = grid._candidate_tables(geom, tw, ri, n_copies, n_pairs, 5)[:3]
    mask = torch.as_tensor(geom.cylindrical_mask().reshape(-1), dtype=torch.float32,
                           device=device)
    cellok = torch.as_tensor(geom.cell_valid_mask().reshape(-1), dtype=torch.float32,
                             device=device)
    if pose is None:
        pose = (rng.uniform(2, 4, k), rng.uniform(-2, 2, k), rng.uniform(-1, 1, k))
    tab = gk.gather_tables(geom, tw, ri, ch, cc, cv, *(np.float32(p) for p in pose),
                           interpolation, mask, cellok, derivatives=interpolation == "linear")
    x = torch.rand((k,) + geom.volume_shape, device=device) * mask.reshape(geom.volume_shape)
    r = torch.rand(tab.shape, device=device)
    b = torch.rand((geom.l2, geom.d2), device=device)
    if not sym:
        return tab, x, r, b
    phc, pv = grid._candidate_tables(geom, tw, ri, n_copies, n_pairs, 5)[3:5]
    st = gk.sym_tables(geom, tw, ri, phc, pv, interpolation, mask, cellok)
    return tab, x, r, b, st


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
@pytest.mark.parametrize("case", GATHER_GEOMS, ids=lambda c: c[0])
def test_gather_kernels_match_plain(cuda, case, interpolation):
    """K1, K2 and K4 (P, row_valid, PT and ST(S(x)) bit for bit: the plain
    P sums each ray in the kernel's order, PT and ST(S(x)) sum exactly) and,
    linear, K3 (J^T J, J^T r within 1e-4 relative) against their plain
    versions on the same card tensors."""
    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    _, fields, k = case
    tab, x, r, b, st = _gather_case(cuda, fields, k, interpolation, seed=1, sym=True)
    before = dict(gk.launches)
    p_k, rv_k = gk.gather_project(tab, x, row_valid=True)
    p_p, rv_p = gk.gather_project_reference(tab, x, row_valid=True)
    pt_k, pt_p = gk.gather_backproject(tab, r), gk.gather_backproject_reference(tab, r)
    sts_k, sts_p = gk.sym_normal(st, x), gk.sym_normal_reference(st, x)
    torch.cuda.synchronize()
    assert bool((rv_k == rv_p).all()) and bool(rv_p.any())
    assert _rel(p_k, p_p) <= 1e-5 and torch.equal(p_k, p_p)
    assert torch.equal(pt_k, pt_p) and bool(pt_p.abs().max() > 0)
    # on the list of the live rays, as the projector launches them
    listed = gk.with_live_rays(tab, rv_k)
    assert listed.n_max > 0 and int(listed.rptr[-1]) == int(rv_p.sum())
    assert torch.equal(gk.gather_project(listed, x), p_p)
    assert torch.equal(gk.gather_backproject(listed, r), pt_p)
    assert torch.equal(sts_k, sts_p) and bool(sts_p.abs().max() > 0)
    assert gk.launches["sym_normal"] - before["sym_normal"] == 1
    if interpolation == "linear":
        got, want = gk.pose_jacobian(tab, x, b), gk.pose_jacobian_reference(tab, x, b)
        torch.cuda.synchronize()
        assert _rel(got[0], want[0]) <= 1e-4 and _rel(got[1], want[1]) <= 1e-4
        assert _rel(got[2], want[2]) <= 1e-4
    assert gk.launches["gather_project"] - before["gather_project"] == 2
    assert gk.launches["gather_backproject"] - before["gather_backproject"] == 2


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_gather_kernels_without_shared_memory(cuda, interpolation, monkeypatch):
    """The kernels' device-memory branch (the one a volume past their
    shared memory takes) on the small geometry: the same results."""
    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    tab, x, r, b, st = _gather_case(cuda, GATHER_GEOMS[0][1], 3, interpolation, seed=2,
                                    sym=True)
    listed = gk.with_live_rays(tab, gk.gather_project(tab, None, row_valid=True)[1])
    runs = []
    for limit in (gk.SMEM_LIMIT, 0):
        monkeypatch.setattr(gk, "SMEM_LIMIT", limit)
        runs.append([gk.gather_project(tab, x), gk.gather_backproject(tab, r), gk.sym_normal(st, x),
                     gk.gather_project(listed, x), gk.gather_backproject(listed, r)])
    torch.cuda.synchronize()
    staged, direct = runs
    assert _rel(direct[0], staged[0]) <= 1e-5
    assert all(torch.equal(a, c) for a, c in zip(direct, staged))
    if interpolation == "linear":
        got, want = gk.pose_jacobian(tab, x, b), gk.pose_jacobian_reference(tab, x, b)
        assert _rel(got[0], want[0]) <= 1e-4 and _rel(got[1], want[1]) <= 1e-4


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_gather_kernels_repeat_bit_for_bit(cuda, interpolation):
    """Launched again on the same inputs, K2, K3 and K4 give the same bits
    (exact integer sums, K3's block sums added in block order), at the
    amyloid's geometry and at k = 3 on the small one."""
    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    for (_, fields, k), seed in ((GATHER_GEOMS[2], 5), (GATHER_GEOMS[0], 6)):
        tab, x, r, b, st = _gather_case(cuda, fields, k, interpolation, seed=seed, sym=True)
        first = [gk.gather_backproject(tab, r), gk.sym_normal(st, x)]
        if interpolation == "linear":
            first += list(gk.pose_jacobian(tab, x, b))
        for _ in range(3):
            again = [gk.gather_backproject(tab, r), gk.sym_normal(st, x)]
            if interpolation == "linear":
                again += list(gk.pose_jacobian(tab, x, b))
            assert all(torch.equal(a, c) for a, c in zip(again, first))


def test_gather_project_half_way_ties_at_twist_30(cuda):
    """Twist 30 deg at tilt = psi = 0 and scale 1 puts nearest-neighbour
    samples exactly half-way between voxels (the centre column's y is kc / 2
    on a copy turned by 30 deg): the kernel rounds each as the plain
    version does (half to even, no fused multiply-add)."""
    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    fields = dict(d2=24, l2=48, d3=20, l3=8, rmax=9, scale2d_to_3d=1.0, csym=1)
    tab, x, _, _ = _gather_case(cuda, fields, 2, "nn", seed=3, twists=[30.0, 30.0],
                                pose=(np.zeros(2), np.zeros(2), np.zeros(2)))
    sampler = tab.sampler()
    ties = sum(int(((Y - torch.floor(Y)) == 0.5).sum())
               for _, (_, Y, _), _, _ in gk._chunks(tab, 0, sampler))
    assert ties > 0
    p_k, rv_k = gk.gather_project(tab, x, row_valid=True)
    p_p, rv_p = gk.gather_project_reference(tab, x, row_valid=True)
    torch.cuda.synchronize()
    assert bool((rv_k == rv_p).all())
    assert _rel(p_k, p_p) <= 1e-5


def test_refine_on_card_matches_cpu(cuda):
    """refine_all_candidates on the card (K1-K4 and the solve's torch ops)
    against the CPU (the plain versions) on the small tilted helix: poses
    within 5e-3, scores within 5e-4 (the reference's engine bounds)."""
    from helicon_tpu_torch.denovo3d import gather_kernels as gk
    from helicon_tpu_torch.denovo3d import refine
    from helicon_tpu_torch.denovo3d.solver import SolveConfig

    geom = ReconstructionGeometry(d2=22, l2=94, d3=22, l3=10, rmin=0.0, rmax=10,
                                  scale2d_to_3d=1.0, csym=1)
    rng = np.random.default_rng(4)
    region = rng.random((geom.d2, geom.l2)).astype(np.float32)
    tw, ri = np.float32([28.0, 30.0, 32.0]), np.float32([2.9, 3.0, 3.1])
    n_copies, n_pairs = estimate_copy_pair_counts(geom, 2.9, 8, rise_pixel_max=3.1)
    tabs = grid._candidate_tables(geom, tw, ri, n_copies, n_pairs, 5)[:5]
    cfg = SolveConfig(cg_iters=8, fista_iters=10, power_iters=2)
    rr = dict(tilt=8.0, psi=3.0, dy=1.0, max_iter=2)
    before = dict(gk.launches)
    s_c, p_c = refine.refine_all_candidates(geom, cfg, region, tw, ri, tabs, 0.5, 0.0, 0.0, rr,
                                            device=cuda)
    assert all(gk.launches[n] > before[n] for n in gk.launches)
    s_h, p_h = refine.refine_all_candidates(geom, cfg, region, tw, ri, tabs, 0.5, 0.0, 0.0, rr,
                                            device="cpu")
    np.testing.assert_allclose(p_c, p_h, atol=5e-3)
    np.testing.assert_allclose(s_c, s_h, atol=5e-4)
