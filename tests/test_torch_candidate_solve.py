"""The fused single-candidate solve (B2) and the in-kernel build + score
(B3) of candidate_solve.py, whose CUDA kernels replace
pallas_solver.py::_kernel and ::_full_kernel, against the JAX package;
and the linear interpolation of the port's builds.

On CPU tensors the entry points run their plain PyTorch versions. They
are held against the JAX package's Pallas kernels in interpret mode at the
tiny geometry of tests/test_pallas_solver.py (x rel 1e-4, score abs 1e-4:
that file's gates), the builds against the JAX package at atol 1e-5
(PARITY.md section 1), and a small linear grid against the JAX package's
grouped XLA path at 1e-4 (tests/test_pallas_solver.py:166). The kernels
themselves are compared with the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import math
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.denovo3d import geometry as ref_geo
from helicon_tpu.denovo3d import projector_grouped as ref_pg
from helicon_tpu.denovo3d import projector_separable as ref_ps
from helicon_tpu.denovo3d.grid import _group_tables
from helicon_tpu.denovo3d.pallas_solver import (
    full_kernel_inputs as ref_full_kernel_inputs,
    pallas_inputs,
    score_candidate_pallas,
    solve_candidate_pallas,
)
from helicon_tpu.denovo3d.solver import SolveConfig, _solve_group_impl
from helicon_tpu.helix import simulate_helical_projection
from helicon_tpu_torch.denovo3d import candidate_solve as cs
from helicon_tpu_torch.denovo3d import geometry as port_geo
from helicon_tpu_torch.denovo3d import group_solve as gs
from helicon_tpu_torch.denovo3d import grid as port_grid
from helicon_tpu_torch.denovo3d import projector_grouped as port_pg
from helicon_tpu_torch.denovo3d import projector_separable as port_ps
from helicon_tpu_torch.denovo3d.solver import SolveConfig as PortSolveConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
# tests/test_pallas_solver.py's small problem and its iteration budget
SMALL = dict(d2=12, l2=16, d3=12, l3=8, rmin=0.0, rmax=5.0, scale2d_to_3d=1.0, csym=1)
CG, FI, PW = 8, 10, 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def small():
    """The small problem built by both packages from one seed (nn)."""
    rg = ref_geo.ReconstructionGeometry(**SMALL)
    pg = port_geo.ReconstructionGeometry(**SMALL)
    region = np.random.default_rng(0).random((rg.d2, rg.l2)).astype(np.float32)
    ch, cc, cv = ref_geo.select_copies(rg, 2.5, 6)
    ops_hc, ops_v, pair_idx, pv = ref_geo.select_pair_ops(rg, 30.0, 2.5, 5, 8)
    phc = np.zeros((5, 4), np.int32)
    mask, cellok = rg.cylindrical_mask(), rg.cell_valid_mask()
    ref = ref_ps.build_problem_separable(
        rg, region, jnp.float32(30.0), jnp.float32(2.5), jnp.asarray(ch), jnp.asarray(cc),
        jnp.asarray(cv), jnp.asarray(phc), jnp.asarray(pv), 0.0, "nn", mask, cellok,
        compute_dtype=jnp.float32,
        pair_ops=(jnp.asarray(ops_hc), jnp.asarray(ops_v), jnp.asarray(pair_idx)),
    )
    port = port_ps.build_problem_separable(
        pg, region, np.float32(30.0), np.float32(2.5), ch, cc, cv, phc, pv, 0.0, "nn", mask,
        cellok, compute_dtype=torch.float32, pair_ops=(ops_hc, ops_v, pair_idx), device="cpu",
    )
    b_eff = ref["b"][None] * ref["row_valid"].astype(jnp.float32)
    rhs = np.array(ref["PT"](b_eff) * jnp.asarray(mask, jnp.float32)).reshape(rg.l3, -1)
    return dict(rg=rg, pg=pg, ref=ref, port=port, tables=(ch, cc, cv, ops_hc), rhs=rhs,
                ub=float(jnp.max(b_eff)))


def test_factors_match_reference(small):
    f_ref, f_port = small["ref"]["factors"], small["port"]["factors"]
    assert sorted(f_port) == sorted(f_ref)
    for k in f_ref:
        np.testing.assert_allclose(f_port[k].numpy().astype(np.float32),
                                   np.asarray(f_ref[k], np.float32), atol=1e-5, err_msg=k)


def test_factors_from_numpy_round_trip(small):
    f_np = {k: np.asarray(v) for k, v in small["ref"]["factors"].items()}
    f_t = cs.factors_from_numpy(f_np, device="cpu")
    assert sorted(f_t) == sorted(f_np)
    for k, v in f_np.items():
        assert f_t[k].device.type == "cpu"
        np.testing.assert_array_equal(f_t[k].numpy(), v, err_msg=k)
    assert f_t["pair_idx"].dtype == torch.int64
    bf = cs.factors_from_numpy(f_np, compute_dtype=torch.bfloat16, device="cpu")
    assert bf["Wsum"].dtype == bf["Mxy_ops"].dtype == torch.bfloat16
    assert bf["pair_ok"].dtype == torch.float32


def test_plain_solve_matches_pallas_kernel_interpret(small):
    """B2's plain version on the JAX package's own factors against its v1
    kernel (l2 + l1 + box), both in float32."""
    l2_reg, l1_reg, lb, ub = 0.01, 0.001, 0.0, small["ub"]
    f = small["ref"]["factors"]
    w2, w2t, gz_big, mxy, mxyt, b1, b1t, pok, maskk = pallas_inputs(f, jnp.float32)
    x_ref = np.asarray(solve_candidate_pallas(
        w2, w2t, gz_big, mxy, mxyt, b1, b1t, pok, jnp.asarray(small["rhs"]), maskk,
        jnp.asarray([[l2_reg, l1_reg, lb, ub]], jnp.float32), cg_iters=CG, fista_iters=FI,
        power_iters=PW, use_bf16=False, interpret=True,
    ))
    factors = cs.factors_from_numpy({k: np.asarray(v) for k, v in f.items()}, device="cpu")
    inp = cs.candidate_inputs(factors, torch.float32, torch.from_numpy(small["rhs"]),
                              (l2_reg, l1_reg, lb, ub))
    np.testing.assert_allclose(inp.b1[0].numpy(), np.asarray(b1), atol=0)
    before = dict(cs.launches)
    x = cs.solve_candidate_kernel(inp, CG, FI, PW)
    assert cs.launches == before  # CPU tensors never reach the kernel
    assert x.shape == (1,) + x_ref.shape
    assert _rel(x[0].numpy(), x_ref) < 1e-4


def test_plain_score_matches_pallas_kernel_interpret(small):
    """B3's plain version (its own build, solve and score) against the
    JAX package's v2 kernel; the port's inputs come from its own build."""
    rg, lb, ub = small["rg"], 0.0, small["ub"]
    ch, cc, cv, ops_hc = small["tables"]
    inp = ref_full_kernel_inputs(rg, small["ref"], jnp.float32(30.0), jnp.float32(2.5),
                                 jnp.asarray(ch), jnp.asarray(cc), jnp.asarray(cv),
                                 jnp.asarray(ops_hc), jnp.float32)
    theta, cvf, opth, gzb, uf, b1, b1t, pok, maskk, pln, b_norm = inp
    n_taps = int(math.ceil(math.sqrt(2.0) / rg.scale2d_to_3d)) + 2
    x_ref, sc_ref = score_candidate_pallas(
        theta, cvf, opth, gzb, uf, b1, b1t, pok, maskk, pln,
        jnp.asarray([[0.0, 0.0, lb, ub, float(b_norm), 0, 0, 0]], jnp.float32),
        C=len(theta), d2=rg.d2, d3=rg.d3, l3=rg.l3, n_taps=n_taps, cg_iters=CG,
        fista_iters=FI, power_iters=PW, use_bf16=False, scale2d_to_3d=rg.scale2d_to_3d,
        dy_pixel=0.0, interpret=True,
    )
    fin = cs.full_kernel_inputs(small["pg"], small["port"], 30.0, 2.5, ch, cc, cv, ops_hc,
                                torch.float32, scal=(0.0, 0.0, lb, ub))
    assert fin.n_taps == n_taps
    np.testing.assert_allclose(fin.b_norm.numpy(), [float(b_norm)], rtol=1e-6)
    x, score = cs.score_candidate_kernel(fin, CG, FI, PW)
    assert _rel(x[0].numpy(), np.asarray(x_ref)) < 1e-4
    assert abs(float(score[0]) - float(np.asarray(sc_ref)[0, 0])) < 1e-4


@pytest.mark.parametrize("case", [(30.0, 2.5, 1, 1.0), (-61.0, 1.7, 2, 0.858)],
                         ids=["c1", "c2"])
def test_plain_build_equals_factors(case):
    """B3's window-form build of W2 and Mxy gives exactly the operator
    build_problem_separable deposits by scatter (nn counts are exact)."""
    twist, rise, csym, s = case
    pg = port_geo.ReconstructionGeometry(**dict(SMALL, csym=csym, scale2d_to_3d=s))
    n_copies, n_pairs = port_geo.estimate_copy_pair_counts(pg, rise, 8)
    n_ops = port_geo.estimate_n_pair_ops(pg, rise)
    ch, cc, cv = port_geo.select_copies(pg, rise, n_copies)
    ops_hc, ops_v, pidx, pv = port_geo.select_pair_ops(pg, twist, rise, n_pairs, n_ops)
    region = np.random.default_rng(1).random((pg.d2, pg.l2)).astype(np.float32)
    ops = port_ps.build_problem_separable(
        pg, region, np.float32(twist), np.float32(rise), ch, cc, cv, np.zeros((len(pv), 4), np.int32), pv, 0.0, "nn",
        pg.cylindrical_mask(), pg.cell_valid_mask(), pair_ops=(ops_hc, ops_v, pidx),
        device="cpu",
    )
    fin = cs.full_kernel_inputs(pg, ops, twist, rise, ch, cc, cv, ops_hc, torch.float32)
    A = cs.build_operators(fin)[0]
    f = ops["factors"]
    nd = f["Wsum"].shape[0] * pg.d2
    assert torch.equal(A[:nd], f["Wsum"].reshape(nd, -1))
    assert torch.equal(A[nd:], f["Mxy_ops"].reshape(A.shape[0] - nd, -1))


def test_batch_of_candidates_solves_each(small):
    """k candidates in one call give each candidate's own result."""
    f = small["port"]["factors"]
    rhs = torch.from_numpy(small["rhs"])
    one = cs.candidate_inputs(f, torch.float32, rhs, (0.01, 0.001, 0.0, small["ub"]))
    other = cs.candidate_inputs(f, torch.float32, 2 * rhs, (0.0, 0.0, -math.inf, math.inf))
    both = cs.CandidateInputs.stack([one, other])
    x2 = cs.solve_candidate_kernel(both, CG, FI, PW)
    for i, it in enumerate((one, other)):
        np.testing.assert_allclose(x2[i].numpy(), cs.solve_candidate_kernel(it, CG, FI, PW)[0]
                                   .numpy(), atol=1e-6)


def test_entry_points_refuse_other_devices(small):
    inp = cs.candidate_inputs(small["port"]["factors"], torch.float32,
                              torch.from_numpy(small["rhs"]), (0, 0, 0, 1))
    inp.a_top = inp.a_top.to("meta")
    with pytest.raises(ValueError):
        cs.solve_candidate_kernel(inp, 1, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_pair_fold_plain_matches_its_definition(dtype):
    """pair_fold on CPU tensors (the plain fold of _matvec_plain, which the
    fold kernel is held against on the card) against its definition, cell
    by cell in float64: tmp[o*l3 + n] = T[n, nd + o*d3^2 + q], ubar =
    B1^T (pok[:, q] * B1 tmp), out[m, o*d3^2 + q] = ubar[o*l3 + m]; within
    float32 rounding (bf16: one bf16 rounding of each value more)."""
    rng = np.random.default_rng(3)
    k, O, l3, P, d3sq, nd = 2, 3, 4, 5, 7, 6
    T = rng.standard_normal((k, l3, nd + O * d3sq)).astype(np.float32)
    b1 = rng.standard_normal((k, P * l3, O * l3)).astype(np.float32)
    pok = (rng.random((k, P * l3, d3sq)) < 0.6).astype(np.float32)
    got = cs.pair_fold(*map(torch.from_numpy, (T, b1, pok)), nd, dtype).numpy()
    want = np.zeros((k, l3, O * d3sq))
    for b in range(k):
        B1 = b1[b].astype(np.float64)
        for q in range(d3sq):
            tmp = np.array([T[b, c % l3, nd + (c // l3) * d3sq + q] for c in range(O * l3)])
            ubar = B1.T @ (pok[b, :, q] * (B1 @ tmp))
            for c in range(O * l3):
                want[b, c % l3, (c // l3) * d3sq + q] = ubar[c]
    tol = 1e-5 * np.abs(want).max() + (2.0**-8 * np.abs(want) if dtype == torch.bfloat16 else 0)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def test_validate_on_gpu_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cs.validate_on_gpu()


# ---- linear interpolation --------------------------------------------------

GEOM = dict(d2=14, l2=32, d3=12, l3=6, rmin=0.0, rmax=5.0, scale2d_to_3d=0.858)


@pytest.fixture(scope="module", params=[(29.4, 1.3, 1), (-60.0, 1.7, 2)], ids=["c1", "c2"])
def linear_case(request):
    twist, rise, csym = request.param
    rg = ref_geo.ReconstructionGeometry(csym=csym, **GEOM)
    pg = port_geo.ReconstructionGeometry(csym=csym, **GEOM)
    region = np.random.default_rng(3).random((rg.d2, rg.l2)).astype(np.float32)
    n_copies, n_pairs = ref_geo.estimate_copy_pair_counts(rg, rise, 8)
    n_ops = ref_geo.estimate_n_pair_ops(rg, rise)
    ch, cc, cv = ref_geo.select_copies(rg, rise, n_copies)
    phc, pv = ref_geo.select_pairs(rg, twist, rise, n_pairs)
    ops_hc, ops_v, pidx, pv_ops = ref_geo.select_pair_ops(rg, twist, rise, n_pairs, n_ops)
    mask, cellok = rg.cylindrical_mask(), rg.cell_valid_mask()
    ref = ref_ps.build_problem_separable(
        rg, jnp.asarray(region), jnp.float32(twist), jnp.float32(rise), jnp.asarray(ch),
        jnp.asarray(cc), jnp.asarray(cv), jnp.asarray(phc), jnp.asarray(pv_ops), 0.0, "linear",
        mask, cellok, compute_dtype=jnp.float32,
        pair_ops=(jnp.asarray(ops_hc), jnp.asarray(ops_v), jnp.asarray(pidx)),
    )
    port = port_ps.build_problem_separable(
        pg, region, np.float32(twist), np.float32(rise), ch, cc, cv, phc, pv_ops, 0.0, "linear",
        mask, cellok, compute_dtype=torch.float32, pair_ops=(ops_hc, ops_v, pidx), device="cpu",
    )
    return pg, ref, port, (twist, rise, ch, cc, cv, ops_hc)


def test_linear_factors_match_reference(linear_case):
    _, ref, port, _ = linear_case
    np.testing.assert_array_equal(port["row_valid"].numpy(), np.asarray(ref["row_valid"]))
    for k in ref["factors"]:
        np.testing.assert_allclose(port["factors"][k].numpy().astype(np.float32),
                                   np.asarray(ref["factors"][k], np.float32), atol=1e-5,
                                   err_msg=k)


def test_linear_operators_match_reference(linear_case):
    pg, ref, port, _ = linear_case
    rng = np.random.default_rng(9)
    x = rng.standard_normal(pg.volume_shape).astype(np.float32)
    for k in ("P", "PTP", "S"):
        out, want = port[k](torch.from_numpy(x)).numpy(), np.asarray(ref[k](jnp.asarray(x)))
        np.testing.assert_allclose(out, want, atol=1e-5 * max(1.0, np.abs(want).max()))
    for fwd, adj in (("P", "PT"), ("S", "ST")):
        y = rng.standard_normal(np.asarray(ref[fwd](jnp.asarray(x))).shape).astype(np.float32)
        out, want = port[adj](torch.from_numpy(y)).numpy(), np.asarray(ref[adj](jnp.asarray(y)))
        np.testing.assert_allclose(out, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_full_kernel_inputs_raises_on_linear(linear_case):
    pg, _, port, (twist, rise, ch, cc, cv, ops_hc) = linear_case
    with pytest.raises(NotImplementedError):
        cs.full_kernel_inputs(pg, port, twist, rise, ch, cc, cv, ops_hc, torch.float32,
                              interpolation="linear")


def test_plain_solve_on_linear_factors_matches_closures(linear_case):
    """B2 is interpolation-agnostic: on linear factors (l2 = l1 = 0, no
    box) it solves the system of the port's linear closures."""
    from helicon_tpu_torch.denovo3d.solver import _cg, _fista, _power_iteration

    pg, _, port, _ = linear_case
    mask_f = port["mask"].float()
    b_eff = port["b"][None] * port["row_valid"].float()
    rhs = port["PT"](b_eff) * mask_f

    def N(v):
        return (port["PTP"](v) + port["ST"](port["S"](v))) * mask_f

    x = _cg(N, rhs, CG)
    x = _fista(N, rhs, x, -math.inf, math.inf, 0.0, FI, _power_iteration(N, rhs, PW)) * mask_f
    inp = cs.candidate_inputs(port["factors"], torch.float32, rhs, (0, 0, -math.inf, math.inf))
    assert _rel(cs.solve_candidate_kernel(inp, CG, FI, PW)[0].numpy(),
                x.reshape(pg.l3, -1).numpy()) < 1e-4


def _grouped_linear_case():
    """The linear case of tests/test_pallas_solver.py::test_grouped_kernel_matches_xla."""
    img = np.asarray(simulate_helical_projection(
        n=1, twist=29.4, rise=4.75, csym=1, helical_diameter=100.0, ball_radius=6.0, polymer=0,
        planarity=1.0, ny=64, nx=128, apix=2.0, rng=0,
    )).squeeze()
    kw = dict(d2=14, l2=32, d3=12, l3=4, rmin=0.0, rmax=5.0, scale2d_to_3d=0.858, csym=1)
    rg, pg = ref_geo.ReconstructionGeometry(**kw), port_geo.ReconstructionGeometry(**kw)
    region = img[: rg.d2, : rg.l2].astype(np.float32)
    rises = np.asarray([1.0, 1.1, 1.2], np.float32)
    n_copies, n_pairs = ref_geo.estimate_copy_pair_counts(
        rg, float(rises.min()), 8, rise_pixel_max=float(rises.max()))
    n_ops = ref_geo.estimate_n_pair_ops(rg, float(rises.min()))
    u = set()
    for r in rises:
        ch, cc, cv = ref_geo.select_copies(rg, float(r), n_copies)
        u.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    rp, m, ch_u, cc_u, pidx, pval, _ = _group_tables(
        rg, 29.4, rises, n_copies, n_pairs, n_ops, len(u), 3, {})
    return rg, pg, region, (rp, m, ch_u, cc_u, pidx, pval), n_ops


def test_linear_group_build_matches_reference():
    rg, pg, region, (rp, m, ch_u, cc_u, pidx, pval), n_ops = _grouped_linear_case()
    hmax = (n_ops - 1) // 2
    ops_h = np.arange(-hmax, hmax + 1).astype(np.int32)
    ops_c = np.zeros_like(ops_h)
    mask, cellok = rg.cylindrical_mask(), rg.cell_valid_mask()
    sh_r = ref_pg.build_group_shared(
        rg, jnp.float32(29.4), jnp.asarray(ch_u), jnp.asarray(cc_u), jnp.asarray(ops_h),
        jnp.asarray(ops_c), dy_pixel=jnp.float32(0.0), interpolation="linear", mask=mask,
        cellok=cellok, compute_dtype=jnp.float32,
    )
    tens_r = jax.vmap(lambda r, mm, pi, pv: ref_pg.build_candidate_tensors_grouped(
        sh_r, rg, jnp.asarray(region), r, jnp.sqrt(mm), pi, pv))(
        jnp.asarray(rp), jnp.asarray(m), jnp.asarray(pidx), jnp.asarray(pval))
    sh_p = port_pg.build_group_shared(pg, np.float32(29.4), ch_u, cc_u, ops_h, ops_c,
                                      np.float32(0.0), "linear", mask, cellok, torch.float32,
                                      "cpu")
    tens_p = port_pg.build_candidate_tensors_grouped(sh_p, pg, region, rp, np.sqrt(m), pidx, pval)
    assert sh_p["linear"]
    for k in ("A_top", "mask_f"):
        np.testing.assert_allclose(sh_p[k].numpy(), np.asarray(sh_r[k]), atol=1e-5, err_msg=k)
    for k in ("xy_any", "xy_ok_ops"):
        np.testing.assert_array_equal(sh_p[k].numpy(), np.asarray(sh_r[k]), err_msg=k)
    for k in ("Gz", "Mz_ops", "a_f", "Cn", "deg", "ub_raw"):
        np.testing.assert_allclose(tens_p[k].numpy(), np.asarray(tens_r[k]), atol=1e-5,
                                   err_msg=k)
    for k in ("rhs", "b_norm"):
        want = np.asarray(tens_r[k])
        np.testing.assert_allclose(tens_p[k].numpy(), want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=k)


def test_linear_group_scores_match_reference():
    """The linear grid of test_grouped_kernel_matches_xla: the port's
    build and plain grouped solve against the JAX package's XLA grouped
    path, each package building its own operators (scores 1e-4)."""
    rg, pg, region, (rp, m, ch_u, cc_u, pidx, pval), n_ops = _grouped_linear_case()
    iters = dict(cg_iters=6, fista_iters=8, power_iters=2)
    cfg = SolveConfig(interpolation="linear", model="lsq", separable=True,
                      compute_dtype="float32", **iters)
    s_ref = np.asarray(_solve_group_impl(
        rg, cfg, jnp.asarray(region), jnp.float32(29.4), jnp.asarray(rp), jnp.asarray(m),
        jnp.asarray(ch_u), jnp.asarray(cc_u), jnp.asarray(pidx), jnp.asarray(pval),
        n_ops_u=n_ops, fused_ntn=True,
    ))
    hmax = (n_ops - 1) // 2
    ops_h = np.arange(-hmax, hmax + 1).astype(np.int32)
    shared = port_pg.build_group_shared(pg, np.float32(29.4), ch_u, cc_u, ops_h,
                                        np.zeros_like(ops_h), np.float32(0.0), "linear",
                                        pg.cylindrical_mask(), pg.cell_valid_mask(),
                                        torch.float32, "cpu")
    tens = port_pg.build_candidate_tensors_grouped(shared, pg, region, rp, np.sqrt(m), pidx, pval)
    tens["lb"], tens["ub"] = port_grid._box_bounds(
        port_grid._positive(PortSolveConfig(), rp, 29.4, pg.l3), tens["ub_raw"])
    _, s = gs.solve_group(gs.group_inputs(shared, tens), **iters)
    np.testing.assert_allclose(s[0].numpy(), s_ref, atol=1e-4)
    np.testing.assert_array_equal(np.argsort(-s[0].numpy()), np.argsort(-s_ref))


# The JAX package's linear amyloid golden: reconstruct_grid(amyloid,
# apix=2.0, the 45-candidate grid, tube_diameter=110.0, cg/fista/power
# 10/16/2, compute_dtype="float32", interpolation="linear") on the CPU under
# jax.disable_jit(): its top five (twist, rise, score).
LINEAR_GOLDEN_TOP5 = (
    (2.0, 4.75, 0.92497635),
    (1.75, 4.45, 0.92486715),
    (2.0, 4.6, 0.92481905),
    (2.0, 5.05, 0.92470884),
    (2.0, 4.9, 0.92460716),
)


def test_linear_golden_matches_reference():
    from helicon_tpu_torch.denovo3d import build_candidate_grid, reconstruct_grid

    img = np.load(ROOT / "tests" / "data" / "class_avg_amyloid.npy")
    tw, ri = build_candidate_grid(1.0, 3.0, 0.25, 4.45, 5.06, 0.15, handedness="left")
    res = reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tube_diameter=110.0,
                           cg_iters=10, fista_iters=16, power_iters=2, compute_dtype="float32",
                           interpolation="linear", return_best_volume=True, device="cpu")
    top = res.top(5)
    np.testing.assert_array_equal(top[:, :2], np.asarray(LINEAR_GOLDEN_TOP5, np.float32)[:, :2])
    np.testing.assert_allclose(top[:, 2], np.asarray(LINEAR_GOLDEN_TOP5)[:, 2], atol=1e-4)
    bv = res.best_volume
    assert bv.shape == res.geom.volume_shape and np.all(np.isfinite(bv))
