"""The PyTorch port's pose refinement (helicon_tpu_torch/denovo3d/refine.py)
against the JAX package's refine.py, on the small tilted helix of
tests/test_native_refine.py (48 x 96 px at 2 A/px), with the inputs the
grid search hands the refine stage.

The reference runs one of two routes by its rule (_native_refine_eligible):
its C++ engine for the lsq + cosine default, its JAX loops otherwise. The
port keeps each route's semantics (refine.py's docstring) on its own
solve and gather kernels' plain versions. Bounds: against the engine the
reference's own engine-vs-JAX bounds (tests/test_native_refine.py: poses
5e-3 deg / px, scores 5e-4, float reassociation over an iterative solve);
against the JAX loops poses 1e-3 and scores 1e-4; one Gauss-Newton step
against jax.jacfwd's new pose 1e-4 and r^T r 1e-4 relative. The JAX loops
run jitted with linear interpolation, whose samples do not jump where
XLA's fused multiply-adds move a coordinate (nearest-neighbour ties do:
ROADMAP C6); the engine's route and the Gauss-Newton step run nn too.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import helicon_tpu.denovo3d.refine as ref_refine
from helicon_tpu.denovo3d import build_candidate_grid
from helicon_tpu.denovo3d.grid import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu.helix import simulate_helical_projection
from helicon_tpu.native import load_refine_engine
from helicon_tpu_torch.denovo3d import geometry as port_geometry
from helicon_tpu_torch.denovo3d import refine as port_refine
from helicon_tpu_torch.denovo3d import solver as port_solver

RANGE = dict(tilt=8.0, psi=3.0, dy=1.0, max_iter=3)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The exact inputs the reference's reconstruct_grid hands its refine
    stage (refine_mode="all") on the small tilted helix, with the port's
    geometry and config of the same fields."""
    import os

    os.environ.setdefault("HELICON_NATIVE_CACHE", str(tmp_path_factory.mktemp("native")))
    img = np.squeeze(np.asarray(simulate_helical_projection(
        n=1, twist=30.0, rise=6.0, csym=1, helical_diameter=40.0, ball_radius=5.0, polymer=0,
        planarity=1.0, ny=48, nx=96, apix=2.0, tilt=4.0, rng=0)))
    tw, ri = build_candidate_grid(26.0, 34.0, 2.0, 5.4, 6.6, 0.3, handedness="right")
    captured = {}

    def spy(geom, cfg, region, twists, rises, tables, *a, **k):
        captured.update(geom=geom, cfg=cfg, region=np.asarray(region, np.float32),
                        twists=twists, rises=rises, tables=tuple(np.asarray(t) for t in tables))
        return np.zeros(len(twists), np.float32), np.zeros((len(twists), 3), np.float32)

    orig = ref_refine.refine_all_candidates
    ref_refine.refine_all_candidates = spy
    try:
        ref_reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tilt=0.0, tube_diameter=44.0,
                             cg_iters=8, fista_iters=10, power_iters=2, compute_dtype="float32",
                             batch_size=16, return_best_volume=False, refine_mode="all",
                             refine_tilt_psi_dy_range=RANGE, devices=jax.devices()[:1])
    finally:
        ref_refine.refine_all_candidates = orig
    c = captured
    c["pgeom"] = port_geometry.ReconstructionGeometry(**dataclasses.asdict(c["geom"]))
    return c


def _cfgs(c, **change):
    ref = c["cfg"]._replace(**change)
    return ref, port_solver.SolveConfig(**ref._asdict())


def _sub(c, sl):
    return c["twists"][sl], c["rises"][sl], tuple(t[sl] for t in c["tables"])


def test_engine_is_the_reference_route(problem):
    """The engine compiles here, so the default config takes it."""
    assert load_refine_engine() is not None
    assert ref_refine._native_refine_eligible(problem["cfg"])


@pytest.mark.parametrize("r_range", [
    {}, dict(tilt=2.0), dict(tilt=(-1.0, 3.0), psi=[0.5, 2.0], dy=np.array([-2.0, 1.0])),
    dict(tilt=None, psi=4.0, dy=0.25, max_iter=2),
])
def test_pose_bounds_match_reference(r_range):
    for got, want in zip(port_refine._pose_bounds(r_range), ref_refine._pose_bounds(r_range)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("change", [
    {}, dict(interpolation="linear"), dict(model="ridge", l2_reg=0.1), dict(l1_reg=0.01),
    dict(score_metric="ssim"), dict(thresh_fraction=0.1), dict(fsc_test=2), "native_off",
], ids=["default", "linear", "ridge", "l1", "ssim", "thresh", "fsc", "native_off"])
def test_eligibility_matches_reference(problem, change, monkeypatch):
    if change == "native_off":
        monkeypatch.setenv("HELICON_NATIVE_REFINE", "0")
        change = {}
    ref, port = _cfgs(problem, **change)
    assert port_refine._native_refine_eligible(port) == ref_refine._native_refine_eligible(ref)


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_gn_step_matches_reference(problem, interpolation):
    """One Gauss-Newton step from the port's own solve (nn or linear) at a
    tilted pose: the new pose within 1e-4 and r^T r within 1e-4 relative
    of the reference's jax.jacfwd step."""
    c = problem
    ref_cfg, cfg = _cfgs(c, interpolation=interpolation)
    i = 3
    tw, ri, tabs = _sub(c, slice(i, i + 1))
    params = np.float32([[1.0, 0.5, 0.2]])
    out = port_solver.solve_candidates(c["pgeom"], cfg, c["region"], tw, ri, *tabs,
                                       *params[0], device="cpu")
    x = out["rec3d"]
    got, rtr = port_refine.gn_step(c["pgeom"], c["region"], tw, ri, tabs[:3], x, params)
    want, rtr_ref = ref_refine._gn_step(
        c["geom"], ref_cfg, jnp.asarray(c["region"]), jnp.float32(tw[0]), jnp.float32(ri[0]),
        tuple(jnp.asarray(t[0]) for t in tabs[:3]), tuple(jnp.asarray(t[0]) for t in tabs[3:]),
        jnp.asarray(x[0].numpy()), jnp.asarray(params[0]))
    np.testing.assert_allclose(got[0], np.asarray(want), rtol=0, atol=1e-4)
    assert abs(float(rtr[0]) - float(rtr_ref)) <= 1e-4 * float(rtr_ref)
    assert np.all(np.abs(got[0] - params[0]) > 1e-3)  # the step moved every coordinate


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_refine_all_matches_engine(problem, interpolation):
    """The default config on the engine's route: every candidate refined
    from its clipped start, max_iter steps, the final iterate scored."""
    c = problem
    # linear's plain sampler is the slow one on the CPU: fewer iterations
    few = {} if interpolation == "nn" else dict(cg_iters=5, fista_iters=5)
    ref_cfg, cfg = _cfgs(c, interpolation=interpolation, **few)
    n = 3 if interpolation == "nn" else 2
    tw, ri, tabs = _sub(c, slice(0, n))
    s_ref, p_ref = ref_refine.refine_all_candidates(c["geom"], ref_cfg, c["region"], tw, ri,
                                                    tabs, 0.0, 0.0, 0.0, RANGE)
    s, p = port_refine.refine_all_candidates(c["pgeom"], cfg, c["region"], tw, ri, tabs, 0.0,
                                             0.0, 0.0, RANGE, device="cpu")
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=5e-3)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=5e-4)
    assert np.abs(p).max() > 0.1  # the poses moved


@pytest.mark.parametrize("route", ["native_off", "ridge"])
def test_refine_all_matches_jax_batch(problem, route, monkeypatch):
    """HELICON_NATIVE_REFINE=0 and an ineligible (ridge) config: the
    reference's vmapped _refine_batch, with the engine's semantics on the
    JAX solve. Linear interpolation, two outer iterations of fewer solver
    iterations."""
    c = problem
    few = dict(interpolation="linear", cg_iters=5, fista_iters=5)
    if route == "native_off":
        monkeypatch.setenv("HELICON_NATIVE_REFINE", "0")
        ref_cfg, cfg = _cfgs(c, **few)
    else:
        ref_cfg, cfg = _cfgs(c, model="ridge", l2_reg=0.1, **few)
    rr = dict(RANGE, max_iter=2)
    tw, ri, tabs = _sub(c, slice(4, 6))
    s_ref, p_ref = ref_refine.refine_all_candidates(c["geom"], ref_cfg, c["region"], tw, ri,
                                                    tabs, 0.0, 0.0, 0.0, rr, batch_size=2)
    s, p = port_refine.refine_all_candidates(c["pgeom"], cfg, c["region"], tw, ri, tabs, 0.0,
                                             0.0, 0.0, rr, device="cpu")
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-3)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-4)


# (route, config change, start pose): the engine's route from an in-bounds
# start; the Python loop's from an out-of-bounds start (the unclipped start
# is scored, so the engine is not taken), under HELICON_NATIVE_REFINE=0
# and for an ineligible config (ssim)
TOPK = dict(
    engine=({}, (0.5, -0.5, 0.25)),
    out_of_bounds=(dict(interpolation="linear"), (9.0, 0.0, 0.0)),
    native_off=(dict(interpolation="linear"), (0.0, 0.0, 0.0)),
    ssim=(dict(interpolation="linear", score_metric="ssim"), (0.0, 0.0, 0.0)),
)


@pytest.mark.parametrize("route", sorted(TOPK))
def test_refine_tilt_psi_dy_matches_reference(problem, route, monkeypatch):
    c = problem
    change, start = TOPK[route]
    if route == "native_off":
        monkeypatch.setenv("HELICON_NATIVE_REFINE", "0")
    ref_cfg, cfg = _cfgs(c, **change)
    rr = dict(RANGE, max_iter=2)
    i = 2
    tw, ri, tabs = _sub(c, slice(i, i + 1))
    copies, pairs = tuple(t[0] for t in tabs[:3]), tuple(t[0] for t in tabs[3:])
    want = ref_refine.refine_tilt_psi_dy(c["geom"], ref_cfg, c["region"], float(tw[0]),
                                         float(ri[0]), copies, pairs, *start, rr)
    got = port_refine.refine_tilt_psi_dy(c["pgeom"], cfg, c["region"], float(tw[0]),
                                         float(ri[0]), copies, pairs, *start, rr, device="cpu")
    atol = 5e-3 if route == "engine" else 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_all_negative_region_clamps_upper_bound(problem):
    """ROADMAP C5: under positivity an all-negative region gives ub =
    max(0, max b) = 0 on the engine's route, so every volume is zero, its
    cosine 0, and no step moves the clipped start."""
    c = problem
    ref_cfg, cfg = _cfgs(c, positive_constraint=1)
    region = -np.abs(c["region"]) - 0.1
    tw, ri, tabs = _sub(c, slice(0, 2))
    start = (0.5, 0.25, -0.25)
    s_ref, p_ref = ref_refine.refine_all_candidates(c["geom"], ref_cfg, region, tw, ri, tabs,
                                                    *start, RANGE)
    s, p = port_refine.refine_all_candidates(c["pgeom"], cfg, region, tw, ri, tabs, *start,
                                             RANGE, device="cpu")
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=5e-3)
    np.testing.assert_allclose(p, np.broadcast_to(np.float32(start), p.shape), atol=1e-6)
