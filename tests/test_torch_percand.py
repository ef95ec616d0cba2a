"""The PyTorch port's per-candidate path against the JAX package: JAX's
random draws that ard reads (bit for bit), B2's matvec entry and its
j-dependent z-Gram, the single-candidate solve with ard and with a tilted
pose, and the routing rule (tests/test_torch_percand_grid.py holds
reconstruct_grid on the per-candidate path).

The JAX side runs eagerly (jax.disable_jit()), as in tests/test_torch_grid.py:
jitted, XLA fuses the nearest-neighbour z positions' arithmetic and moves
samples that sit half-way between two planes (ROADMAP C6)."""

import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.denovo3d import geometry as ref_geo
from helicon_tpu.denovo3d import projector_separable as ref_ps
from helicon_tpu.denovo3d import solver as ref_solver
from helicon_tpu.helix import simulate_helical_projection as ref_simulate
from helicon_tpu_torch import _jax_random as jr
from helicon_tpu_torch.denovo3d import geometry as port_geo
from helicon_tpu_torch.denovo3d import grid as port_grid
from helicon_tpu_torch.denovo3d import projector_separable as port_ps
from helicon_tpu_torch.denovo3d import solver as port_solver

# ---------------------------------------------------------------------------
# JAX's random draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_fold_in_uniform_rademacher_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 7, 11, 2**32 - 1):
        np.testing.assert_array_equal(jr.fold_in(jr.PRNGKey(seed), data),
                                      np.asarray(jax.random.fold_in(key, data)))
    # the ard branch's two probe volumes and its per-step Rademacher probes
    kp = jax.random.split(jax.random.fold_in(key, 7))
    pk = jr.split(jr.fold_in(jr.PRNGKey(seed), 7))
    for a, b in zip(kp, pk):
        want = np.asarray(jax.random.uniform(a, (6, 9, 9), jnp.float32, 1.0, 2.0))
        got = jr.uniform(b, (6, 9, 9), 1.0, 2.0)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for it in (0, 5, 11):
        want = np.asarray(jax.random.rademacher(jax.random.fold_in(key, it), (4, 6, 9, 9),
                                                jnp.float32))
        np.testing.assert_array_equal(jr.rademacher(jr.fold_in(jr.PRNGKey(seed), it),
                                                    (4, 6, 9, 9)), want)
    np.testing.assert_array_equal(jr.uniform(jr.PRNGKey(seed), (1000,)),
                                  np.asarray(jax.random.uniform(key, (1000,))))


# ---------------------------------------------------------------------------
# one candidate: B2's entries, ard, a tilted pose
# ---------------------------------------------------------------------------

GEOM = dict(d2=14, l2=32, d3=12, l3=6, rmin=0.0, rmax=5.0, scale2d_to_3d=0.858, csym=1)
TWIST, RISE = 29.4, 1.1


@pytest.fixture(scope="module")
def one():
    """One candidate's tables and the reference's separable operators."""
    rg = ref_geo.ReconstructionGeometry(**GEOM)
    pg = port_geo.ReconstructionGeometry(**GEOM)
    region = np.asarray(ref_simulate(
        n=1, twist=29.4, rise=4.75, csym=1, helical_diameter=100.0, ball_radius=6.0, polymer=0,
        planarity=1.0, ny=64, nx=128, apix=2.0, rng=0), np.float32)[: rg.d2, : rg.l2]
    n_copies, n_pairs = ref_geo.estimate_copy_pair_counts(rg, RISE, 8)
    n_ops = ref_geo.estimate_n_pair_ops(rg, RISE)
    tabs = port_grid._candidate_tables(pg, np.float32([TWIST]), np.float32([RISE]), n_copies,
                                       n_pairs, n_ops)
    tabs = [t[0] for t in tabs]
    mask, cellok = rg.cylindrical_mask(), rg.cell_valid_mask()
    with jax.disable_jit():
        ref_ops = ref_ps.build_problem_separable(
            rg, jnp.asarray(region), jnp.float32(TWIST), jnp.float32(RISE),
            *(jnp.asarray(t) for t in tabs[:5]), 0.0, "nn", mask, cellok,
            pair_ops=tuple(jnp.asarray(t) for t in tabs[5:]))
    return dict(rg=rg, pg=pg, region=region, tabs=tabs, ref_ops=ref_ops, mask=mask)


def _cfg(**kw):
    base = dict(interpolation="nn", cg_iters=10, fista_iters=16, power_iters=2,
                compute_dtype="float32", separable=True)
    base.update(kw)
    return base


def _port_ops(one):
    return port_ps.build_problem_separable(
        one["pg"], one["region"], np.float32(TWIST), np.float32(RISE), *one["tabs"][:5], 0.0,
        "nn", one["pg"].cylindrical_mask(), one["pg"].cell_valid_mask(),
        pair_ops=tuple(one["tabs"][5:]), device="cpu")


def _port_batch(one, cfg):
    """The candidate as a batch of one (build_problems_separable)."""
    lead = [np.asarray(t)[None] for t in one["tabs"]]
    ops = port_ps.build_problems_separable(
        one["pg"], one["region"], np.float32([TWIST]), np.float32([RISE]), *lead[:5], 0.0,
        "nn", one["pg"].cylindrical_mask(), one["pg"].cell_valid_mask(),
        pair_ops=tuple(lead[5:]), device="cpu")
    return port_solver._Batch(ops, port_solver.SolveConfig(**cfg), one["pg"])


@pytest.mark.parametrize("half", [None, 0, 1], ids=["full", "half1", "half2"])
def test_b2_matvec_entry_matches_normal_operator(one, half):
    """candidate_matvec (l2 = 0), full rows or an fsc half's j-dependent
    z-Gram, against the closures' (PT(P(v) rowv) + ST(S(v))) * mask."""
    ops = _port_ops(one)
    batch = _port_batch(one, _cfg())
    w = None if half is None else torch.as_tensor(
        port_solver._pid_split_masks(one["pg"], 2)[half])
    v = torch.from_numpy(np.random.default_rng(1).random((1, 6, 144)).astype(np.float32))
    got = batch.N0(w)(v)
    rows = batch.rowv[0] if w is None else batch.rowv[0] * w
    vol = v[0].reshape(6, 12, 12)
    want = (ops["PT"](ops["P"](vol) * rows) + ops["ST"](ops["S"](vol))) * ops["mask"]
    scale = float(want.abs().max())
    np.testing.assert_allclose(got[0].numpy(), want.reshape(6, 144).numpy(), atol=1e-5 * scale)


def test_b2_plain_half_solve_matches_reference_full_rows_false(one):
    """B2's plain solve on a 6-dim z-Gram (an fsc half) against the
    reference's _solve_one_weighting(full_rows=False) on the same
    factors: x rel 1e-4, score 1e-4."""
    cfg = ref_solver.SolveConfig(**_cfg(l2_reg=0.05, model="ridge"))
    rops = one["ref_ops"]
    m1 = ref_solver._pid_split_masks(one["rg"], 2, jax.random.PRNGKey(0))[0]
    rowv = rops["row_valid"].astype(jnp.float32) * m1
    mask_f = jnp.asarray(one["mask"], jnp.float32)
    ub = jnp.max(rops["b"][None] * rops["row_valid"])
    with jax.disable_jit():
        xr, sr = ref_solver._solve_one_weighting(rops, rowv, mask_f, cfg, True, ub)
    batch = _port_batch(one, cfg._asdict())
    x, s, _ = port_solver._solve_weighting(
        batch, torch.as_tensor(np.asarray(m1)), torch.tensor([True]),
        torch.tensor([float(ub)]), np.ones(1, np.float32), jr.PRNGKey(0))
    assert batch.on_b2
    xr = np.asarray(xr).reshape(6, -1)
    assert np.abs(x[0].numpy() - xr).max() / np.abs(xr).max() < 1e-4
    assert abs(float(s[0]) - float(sr)) < 1e-4


def _ref_candidate(one, cfg, tilt=0.0, psi=0.0):
    # a tilted pose runs the reference jitted: no sample sits half-way
    # there (C6), and its eager gather solve costs minutes (jitted, the
    # scores agree to 6e-8, the volume to 1e-6)
    tabs = one["tabs"]
    with contextlib.nullcontext() if tilt else jax.disable_jit():
        return ref_solver._solve_candidate_impl(
            one["rg"], ref_solver.SolveConfig(**cfg), jnp.asarray(one["region"]),
            jnp.float32(TWIST), jnp.float32(RISE), *(jnp.asarray(t) for t in tabs[:5]),
            jnp.float32(tilt), jnp.float32(psi), jnp.float32(0.0),
            pair_ops=tuple(jnp.asarray(t) for t in tabs[5:]) if cfg["separable"] else None)


def _port_candidate(one, cfg, tilt=0.0, psi=0.0):
    tabs = one["tabs"]
    return port_solver.solve_candidate(
        one["pg"], port_solver.SolveConfig(**cfg), one["region"], np.float32(TWIST),
        np.float32(RISE), *tabs[:5], tilt, psi, 0.0,
        pair_ops=tuple(tabs[5:]) if cfg["separable"] else None, device="cpu")


@pytest.mark.parametrize("name", ["ard", "tilt", "ard_fsc"])
def test_solve_candidate_matches_reference(one, name):
    """solve_candidate with ard (B2's matvec entry), with tilt 3 deg / psi
    1 deg (the gather projector) and with ard under fsc 3: scores 1e-4;
    volumes rel 1e-4, ard's by correlation: its pruning (a precision
    crossing 1e4) follows float32 sums, so a few voxels flip between any
    two orders of summation (the reference's own jitted and eager runs
    here: 365 and 367 nonzero voxels, 2.7e-2 relative apart, scores
    1.3e-5 apart)."""
    cfg, pose = dict(ard=(_cfg(model="ard"), (0.0, 0.0)),
                     tilt=(_cfg(separable=False), (3.0, 1.0)),
                     ard_fsc=(_cfg(model="ard", fsc_test=3), (0.0, 0.0)))[name]
    want = _ref_candidate(one, cfg, *pose)
    got = _port_candidate(one, cfg, *pose)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-4)
    for k in ("rec3d", "rec3d_half1", "rec3d_half2"):
        w, g = np.asarray(want[k]), got[k].numpy()
        if "ard" in name:
            assert (w == 0).all() == (g == 0).all()
            if not (w == 0).all():
                assert np.corrcoef(w.ravel(), g.ravel())[0, 1] > 0.999, k
        else:
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k


def test_routing_rule_matches_reference(monkeypatch):
    """_use_grouped against the reference's conditions, under each value
    of HELICON_GRID_GROUPED."""
    geom = port_geo.ReconstructionGeometry(**GEOM)
    many, few = np.float32([1.0, 1.0, 2.0, 2.0]), np.float32([1.0, 2.0, 3.0])
    base = port_solver.SolveConfig(**_cfg())
    cases = [
        (base, many, {"-1": True, "0": False, "1": True}),
        (base, few, {"-1": False, "0": False, "1": True}),
        (base._replace(separable=False), many, {"-1": False, "0": False, "1": False}),
        (base._replace(model="ard"), many, {"-1": False, "0": False, "1": False}),
        (base._replace(fsc_test=2, l2_reg=0.1), many, {"-1": False, "0": False, "1": False}),
        (base._replace(fsc_test=2), many, {"-1": True, "0": False, "1": True}),
    ]
    for cfg, tw, want in cases:
        for env, use in want.items():
            monkeypatch.setenv("HELICON_GRID_GROUPED", env)
            assert port_grid._use_grouped(cfg, geom, tw, 10, 5) is use, (cfg, tw, env)
    monkeypatch.setenv("HELICON_GRID_GROUPED", "-1")
    monkeypatch.setenv("HELICON_GROUP_BUDGET_MB", "0")
    assert not port_grid._use_grouped(base, geom, many, 10, 5)
