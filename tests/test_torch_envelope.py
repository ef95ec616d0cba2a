"""The port's grouped solver envelope against the JAX package: the models
(ridge, lasso, elasticnet, lreg), the alpha-decay retry, the lreg seed,
thresh_fraction, the 2D score metrics and the fsc half-set splits.

  * The scorers (ssim, ms_ssim, mutual information) against the reference's
    traced versions on seeded images, constant images and samples that lie
    exactly on the histogram's bin edges (float32 sums in another order:
    1e-6).
  * The simulator against the reference's (its validate_grouped_on_device
    call and one more; the sum over the balls in another order: 1e-6 of
    the largest value).
  * The plain grouped solve with l1 / l2 columns, without the score, and
    with an fsc half-set's j-dependent z-Gram, against the Pallas kernel in
    interpret mode on identical operators (x rel 1e-4).
  * The port's grouped scorer (grid._grouped_scoring on CPU tensors)
    against the XLA grouped path _solve_group_impl(fused_ntn=True) on
    tests/test_pallas_solver.py::_grouped_case, scores within 1e-4, and
    against the Pallas kernel in interpret mode within 1e-4. A float32
    search seeds the power iteration from ones, as the XLA path; the
    Pallas kernel seeds from rhs, so its comparison gives the port's
    scorer the kernel's seed (ROADMAP C15: the seed moved mutual
    information's and a retried lasso's scores past 1e-4).
The whole slice (reconstruct_grid under each kind of option) is held
against the reference in tests/test_torch_grid.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.core import analysis as ref_an
from helicon_tpu.denovo3d import geometry as ref_geo
from helicon_tpu.denovo3d import solver as ref_solver
from helicon_tpu.denovo3d.pallas_solver import grouped_pallas_inputs, solve_group_pallas, wide_col
from helicon_tpu.helix import simulate_helical_projection as ref_simulate
from helicon_tpu_torch.core import analysis as port_an
from helicon_tpu_torch.denovo3d import geometry as port_geo
from helicon_tpu_torch.denovo3d import grid as port_grid
from helicon_tpu_torch.denovo3d import group_solve as gs
from helicon_tpu_torch.denovo3d import solver as port_solver
from helicon_tpu_torch.helix import simulate_helical_projection

from test_pallas_solver import ENVELOPE_CONFIGS, _grouped_case
from test_torch_group_solve import ITERS, _case

CPU = torch.device("cpu")

# ---------------------------------------------------------------------------
# the 2D scorers
# ---------------------------------------------------------------------------


def _images():
    """Five (64, 40) images (three ms-ssim scales): noise, a constant, a
    smooth image, samples on a 1/4 grid, a scaled copy of the reference."""
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((64, 40)).astype(np.float32)
    y, x = np.mgrid[:64, :40].astype(np.float32)
    imgs = np.stack([
        rng.standard_normal((64, 40)).astype(np.float32),
        np.full((64, 40), 3.0, np.float32),
        np.sin(y / 7) * np.cos(x / 5) + 0.1 * ref,
        np.round(rng.standard_normal((64, 40)) * 4).astype(np.float32) / 4,
        2.0 * ref + 1.0,
    ])
    return imgs, ref


@pytest.mark.parametrize("name", ["ssim_score_traced", "ms_ssim_score_traced",
                                  "mutual_information_score_traced"])
def test_scores_match_reference(name):
    imgs, ref = _images()
    want = np.array([float(getattr(ref_an, name)(jnp.asarray(i), jnp.asarray(ref)))
                     for i in imgs])
    got = getattr(port_an, name)(torch.from_numpy(imgs), torch.from_numpy(ref)).numpy()
    assert got.shape == (len(imgs),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if name != "mutual_information_score_traced":  # an image against itself: 1
        same = getattr(port_an, name)(torch.from_numpy(ref), torch.from_numpy(ref))
        assert abs(float(same) - 1.0) < 1e-5


def test_constant_pair_scores_zero():
    c = torch.full((2, 32, 16), 1.5)
    for fn in (port_an.ssim_score_traced, port_an.ms_ssim_score_traced,
               port_an.mutual_information_score_traced):
        assert not bool(fn(c, c[0]).any())


def test_histogram_samples_on_bin_edges():
    """Integer samples 0..64 lie exactly on the 65 edges of linspace(0,
    64, 65): each must land in the bin jnp.histogram2d picks (searchsorted
    right; the last edge in the last bin). Counts equal bin for bin."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 65, (48, 24)).astype(np.float32)
    b = rng.integers(0, 65, (48, 24)).astype(np.float32)
    a[0, 0], a[0, 1], b[0, 0], b[0, 1] = 0, 64, 0, 64  # both ranges 0..64
    want, _, _ = jnp.histogram2d(jnp.asarray(a.ravel()), jnp.asarray(b.ravel()), bins=64)
    bx = port_an._histogram_bins(torch.from_numpy(a.reshape(1, -1)), 64)[0]
    by = port_an._histogram_bins(torch.from_numpy(b.reshape(1, -1)), 64)[0]
    got = np.zeros((64, 64))
    np.add.at(got, ((bx - 1).numpy(), (by - 1).numpy()), 1)
    np.testing.assert_array_equal(got, np.asarray(want))
    mi = port_an.mutual_information_score_traced(torch.from_numpy(a), torch.from_numpy(b))
    ref = ref_an.mutual_information_score_traced(jnp.asarray(a), jnp.asarray(b))
    assert abs(float(mi) - float(ref)) < 1e-6


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

SIM_CALLS = {
    "validate": dict(n=1, twist=29.4, rise=4.75, csym=1, helical_diameter=100.0, ball_radius=6.0,
                     polymer=0, planarity=1.0, ny=64, nx=128, apix=2.0, rng=0),
    "polymer_csym2_tilt": dict(n=5, twist=-1.2, rise=4.75, csym=2, helical_diameter=80.0,
                               ball_radius=4.0, polymer=1, planarity=0.9, ny=64, nx=96,
                               apix=2.5, tilt=3.0, psi=1.0, dy=2.0, rng=7),
}


@pytest.mark.parametrize("call", sorted(SIM_CALLS))
def test_simulate_matches_reference(call):
    kw = SIM_CALLS[call]
    want = np.asarray(ref_simulate(**kw))
    got = simulate_helical_projection(device="cpu", **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the plain grouped solve's options against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solve_case():
    return _case(5, -1)


# (l1, l2) per-candidate coefficient scales, and the fsc half-set mode
SOLVE_OPTIONS = {"l2": (None, 0.05, 0), "l1": (0.02, None, 0), "l1_l2": (0.02, 0.05, 0),
                 "fsc2_half": (None, None, 2), "fsc4_half": (None, None, 4)}


@pytest.mark.parametrize("option", sorted(SOLVE_OPTIONS))
def test_plain_options_match_pallas_kernel_interpret(solve_case, option):
    """solve_group_reference with l1 / l2 columns and without the score, or
    with an fsc half-set's j-dependent z-Gram and the score, against
    solve_group_pallas(l1_col=, l2_col=, with_score=, interpret=True)."""
    from helicon_tpu.denovo3d import projector_grouped as ref_pg
    from helicon_tpu_torch.denovo3d import projector_grouped as port_pg

    l1s, l2s, mode = SOLVE_OPTIONS[option]
    c = solve_case
    R, l3 = c["static"]["R"], c["static"]["l3"]
    scale = np.linspace(0.5, 1.5, R).astype(np.float32)
    l1 = None if l1s is None else scale * l1s
    l2 = None if l2s is None else scale[::-1].copy() * l2s
    args, tens_np = c["args"], c["tens_np"]
    if mode:
        pg, region, rp, m, ch_u, cc_u, pidx, pval, ops_h, ops_c = c["port_tables"]
        w = port_solver._pid_split_masks(pg, mode)[0][0]
        rg = c["xla_common"][0]
        shared = ref_pg.build_group_shared(
            rg, jnp.float32(29.4), jnp.asarray(ch_u), jnp.asarray(cc_u), jnp.asarray(ops_h),
            jnp.asarray(ops_c), dy_pixel=jnp.float32(0.0), interpolation="nn",
            mask=rg.cylindrical_mask(), cellok=rg.cell_valid_mask(), compute_dtype=jnp.float32)
        tens = dict(jax.vmap(lambda r, mm, pi, pv: ref_pg.build_candidate_tensors_grouped(
            shared, rg, jnp.asarray(region), r, jnp.sqrt(mm), pi, pv, pid_mask=w,
        ))(jnp.asarray(rp), jnp.asarray(m), jnp.asarray(pidx), jnp.asarray(pval)))
        tens.pop("ub_raw")
        tens["lb"], tens["ub"] = (jnp.asarray(tens_np[k]) for k in ("lb", "ub"))
        args, _ = grouped_pallas_inputs(shared, tens, rg, R)
        tens_np = {k: np.asarray(v) for k, v in tens.items()}
        # the port builds the same half-set tensors
        sh_p = port_pg.build_group_shared(pg, np.float32(29.4), ch_u, cc_u, ops_h, ops_c,
                                          np.float32(0.0), "nn", pg.cylindrical_mask(),
                                          pg.cell_valid_mask(), torch.float32, "cpu")
        t_p = port_pg.build_candidate_tensors_grouped(sh_p, pg, region, rp, np.sqrt(m), pidx,
                                                      pval, pid_mask=w)
        for k in ("Gz", "rhs", "b_norm"):
            want = tens_np[k]
            np.testing.assert_allclose(t_p[k].numpy(), want, rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(want).max())))
    with_score = l1 is None and l2 is None
    x_w, s = solve_group_pallas(
        args, c["static"], use_bf16=False, interpret=True, with_score=with_score,
        l1_col=None if l1 is None else wide_col(jnp.asarray(l1), R, l3),
        l2_col=None if l2 is None else wide_col(jnp.asarray(l2), R, l3), **ITERS)
    ref_x = np.asarray(x_w).reshape(l3, R, -1).transpose(1, 0, 2)
    inp = gs.group_inputs_from_numpy(c["shared_np"], tens_np)
    assert inp.gz_stride == (inp.d2 if mode else 1)

    def col(v):
        return None if v is None else torch.from_numpy(v)[None]

    x, score = gs.solve_group(inp, **ITERS, l1=col(l1), l2=col(l2), with_score=with_score)
    rel = np.abs(x[0].numpy() - ref_x).max() / max(np.abs(ref_x).max(), 1e-30)
    assert rel < 1e-4, rel
    np.testing.assert_allclose(score[0].numpy(), np.asarray(s)[:, 0], rtol=0, atol=1e-4)
    if not with_score:
        assert not bool(score.any())


def test_retry_resolves_whole_launch_and_keeps_first_nonzero():
    """The retry solves the whole launch each round, at a tenfold smaller
    scale, and each candidate keeps the volume of the first round that left
    it nonzero. A stand-in solve returns the scale where it reaches each
    candidate's threshold and zero above it."""
    base = torch.full((2, 3), 2.0)
    first = torch.tensor([[1.0, 0.1, 0.01], [1.0, 1.0, 1e-3]])
    seen = []

    def solve(inp, *iters, l1=None, l2=None, with_score=True):
        assert l1 is None and not with_score
        seen.append(tuple(l2.shape))
        scale = l2 / base
        x = torch.where(scale <= first * 1.001, scale, 0.0)
        return x[..., None, None].expand(2, 3, 2, 4).clone(), torch.zeros(2, 3)

    x0, _ = solve(None, l2=base, with_score=False)
    x, rounds = port_grid._retry_all_zero(solve, None, x0, None, base, (6, 8, 2))
    assert rounds == 3 and seen[1:] == [(2, 3)] * 3
    np.testing.assert_allclose(x[..., 0, 0].numpy(), first.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# the grouped scorer against the JAX package's grouped paths
# ---------------------------------------------------------------------------

CONFIGS = dict(
    ENVELOPE_CONFIGS,
    default=dict(),
    ms_ssim=dict(score_metric="ms_ssim"),
    composite=dict(score_metric="composite"),
    fsc3=dict(fsc_test=3),
    fsc4=dict(fsc_test=4),
    # an alpha large enough that the first fit is all zero: two retries
    lasso_retry=dict(model="lasso", l1_reg=0.05, reg_per_row=True, positive_constraint=1),
)


@pytest.fixture(scope="module")
def grouped():
    common, rank, n_ops = _grouped_case()
    rg = common[0]
    pg = port_geo.ReconstructionGeometry(**dataclasses.asdict(rg))
    rises = np.asarray([1.0, 1.1, 1.2], np.float32)
    n_copies, n_pairs = ref_geo.estimate_copy_pair_counts(rg, 1.0, 8, rise_pixel_max=1.2)
    return dict(common=common, rank=rank, n_ops=n_ops, pg=pg, rises=rises,
                counts=(n_copies, n_pairs, n_ops))


def _port_scores(g, cfg, region=None, solve=None):
    pcfg = port_solver.SolveConfig(**cfg._asdict())
    region = np.asarray(g["common"][1]) if region is None else region
    return port_grid._grouped_scoring(
        g["pg"], pcfg, np.full(3, 29.4, np.float32), g["rises"], *g["counts"], region,
        np.float32(0.0), {}, CPU, solve=solve)


def _cfg(**kw):
    return ref_solver.SolveConfig(interpolation="nn", cg_iters=6, fista_iters=8, power_iters=2,
                                  separable=True, compute_dtype="float32", **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_grouped_scorer_matches_xla_grouped_path(grouped, name):
    g = grouped
    cfg = _cfg(**CONFIGS[name])
    want = np.asarray(ref_solver._solve_group_impl(
        g["common"][0], cfg, *g["common"][1:], g["rank"], n_ops_u=g["n_ops"],
        fused_ntn=True))[:3]
    got, eff = _port_scores(g, cfg)
    assert np.all(np.isfinite(got))
    assert eff["retry_rounds"] == (2 if name == "lasso_retry" else 0)
    assert eff["score_in_kernel"] == (name in ("default", "fsc", "fsc3", "fsc4"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["lasso_retry", "mutual_information", "elasticnet", "fsc"])
def test_grouped_scorer_matches_pallas_kernel_interpret(grouped, name):
    """With the kernel's power-iteration seed (rhs; a float32 search
    seeds from ones, as the XLA path): 1e-4."""
    g = grouped
    cfg = _cfg(**CONFIGS[name])
    want = np.asarray(ref_solver._solve_group_impl(
        g["common"][0], cfg, *g["common"][1:], g["rank"], n_ops_u=g["n_ops"], use_pallas=True,
        pallas_interpret=True))[:3]
    got, _ = _port_scores(g, cfg, solve=functools.partial(gs.solve_group, power_seed="rhs"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_lreg_seed_and_zero_fits(grouped):
    """A negated image under positivity fits all zero: lreg seeds the
    centre voxel, ridge retries down to the scale floor (eight rounds), and
    both score as the reference does."""
    g = grouped
    region = -np.asarray(g["common"][1])
    common = (g["common"][0], jnp.asarray(region)) + tuple(g["common"][2:])
    for kw, rounds in ((dict(model="lreg"), 0), (dict(model="ridge", l2_reg=0.05), 8)):
        cfg = _cfg(positive_constraint=1, **kw)
        want = np.asarray(ref_solver._solve_group_impl(
            common[0], cfg, *common[1:], g["rank"], n_ops_u=g["n_ops"], fused_ntn=True))[:3]
        got, eff = _port_scores(g, cfg, region=region)
        assert eff["retry_rounds"] == rounds
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_seed_lreg_replaces_only_all_zero_volumes():
    x = torch.zeros((2, 3, 4, 9))
    x[0, 1, 2, 5] = 0.5
    y = port_solver.seed_lreg(x, 2)
    assert torch.equal(y[0, 1], x[0, 1])
    want = np.zeros(36, np.float32)
    want[18] = 1.0
    for g, r in ((0, 0), (0, 2), (1, 0), (1, 1), (1, 2)):
        np.testing.assert_array_equal(y[g, r].reshape(-1).numpy(), want)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_pid_split_masks_match_reference(mode):
    kw = dict(d2=14, l2=32, d3=12, l3=4, rmin=0.0, rmax=5.0, scale2d_to_3d=0.858, csym=1)
    want = ref_solver._pid_split_masks(ref_geo.ReconstructionGeometry(**kw), mode,
                                       jax.random.PRNGKey(0))
    got = port_solver._pid_split_masks(port_geo.ReconstructionGeometry(**kw), mode)
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(gt, np.asarray(w))


def test_pid_split_mode_1_raises():
    """Despite its name, which the test list keeps from when mode 1 raised
    here, this checks that mode 1 matches the reference: its random split
    is JAX's permutation drawn in numpy, equal at an odd pixel count too."""
    kw = dict(d2=4, l2=7, d3=6, l3=2, rmin=0.0, rmax=2.0, scale2d_to_3d=1.0)
    want = ref_solver._pid_split_masks(ref_geo.ReconstructionGeometry(**kw), 1,
                                       jax.random.PRNGKey(0))
    got = port_solver._pid_split_masks(port_geo.ReconstructionGeometry(**kw), 1)
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(gt, np.asarray(w))
    assert got[0].sum() == 14 and got[1].sum() == 14


def test_solve_candidate_fsc_and_regularization_match_reference(grouped):
    """The single-candidate solve (the best-volume re-solve) with fsc
    halves and elasticnet's l1 / l2, against the reference's
    _solve_candidate_impl called without jit (its build unfused, ROADMAP
    C6): volumes rel 1e-4, scores 1e-4."""
    g = grouped
    rg, pg = g["common"][0], g["pg"]
    region = np.asarray(g["common"][1])
    n_copies, n_pairs, n_ops = g["counts"]
    tw, rp = np.float32([29.4]), np.float32([1.1])
    tabs = port_grid._candidate_tables(pg, tw, rp, n_copies, n_pairs, n_ops)
    ch, cc, cv, phc, pv, ops_hc, ops_v, pidx = (t[0] for t in tabs)
    keep = port_geo.compute_sym_dedup_mask(pg, 29.4, 1.1, phc, pv)
    cfg = _cfg(fsc_test=3, model="elasticnet", l1_reg=5e-5, l2_reg=5e-5, reg_per_row=True)
    want = ref_solver._solve_candidate_impl(
        rg, cfg, jnp.asarray(region), jnp.float32(29.4), jnp.float32(1.1), jnp.asarray(ch),
        jnp.asarray(cc), jnp.asarray(cv), jnp.asarray(phc), jnp.asarray(pv),
        pair_ops=tuple(jnp.asarray(a) for a in (ops_hc, ops_v, pidx)),
        sym_keep=jnp.asarray(keep))
    got = port_solver.solve_candidate(
        pg, port_solver.SolveConfig(**cfg._asdict()), region, np.float32(29.4), np.float32(1.1),
        ch, cc, cv, phc, pv, pair_ops=(ops_hc, ops_v, pidx), sym_keep=keep, device="cpu")
    for k in ("rec3d", "rec3d_half1", "rec3d_half2"):
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0
        rel = np.abs(got[k].numpy() - w).max() / np.abs(w).max()
        assert rel < 1e-4, (k, rel)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-4)
    assert abs(float(got["score"]) - float(want["score"])) < 1e-4
