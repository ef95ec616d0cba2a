"""reconstruct_grid(cost_analysis=True) in the PyTorch port: GridResult.cost
carries the JAX package's keys (flops, bytes_accessed, batch_size and the
grouped path's analytic_flops_per_candidate) plus source="analytic", the
port having no compiler count. The grouped per-candidate count equals the
JAX package's exactly, on its own search and on the counting function
alone; the bucketed, checkpointed and process-sharded drivers keep their
first sub-call's cost, as the JAX package's do."""

import os
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from _torch_mh_worker import tiny_workload
from helicon_tpu.denovo3d import grid as ref_grid
from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu.helix.simulate import simulate_helical_projection
from helicon_tpu_torch.denovo3d import grid, reconstruct_grid, reconstruct_grid_checkpointed
from helicon_tpu_torch.parallel import multihost

REF_KEYS = {"flops", "bytes_accessed", "batch_size", "analytic_flops_per_candidate"}
# tests/test_parallel.py's grouped grid: 8 twists x 2 rises
TWISTS = np.repeat(np.linspace(20.0, 55.0, 8).astype(np.float32), 2)
RISES = np.tile(np.asarray([5.6, 6.0], np.float32), 8)
KW = dict(apix=2.0, cg_iters=8, fista_iters=6, power_iters=2, batch_size=16,
          return_best_volume=False, compute_dtype="float32")


@pytest.fixture(scope="module")
def image():
    return np.squeeze(np.asarray(simulate_helical_projection(
        n=1, twist=30.0, rise=6.0, csym=1, helical_diameter=40.0, ball_radius=5.0,
        polymer=0, planarity=1.0, ny=48, nx=96, apix=2.0, rng=0)))


def _check_cost(cost):
    assert REF_KEYS <= set(cost) and cost["source"] == "analytic"
    assert cost["flops"] == cost["batch_size"] * cost["analytic_flops_per_candidate"] > 0
    assert cost["bytes_accessed"] > 0


def test_grouped_count_equals_reference(image):
    """The grouped search's cost against the JAX package's on the same
    grid: the per-candidate count exactly, the batch (one group's R) and
    the keys."""
    old = os.environ.get("HELICON_GRID_GROUPED")
    os.environ["HELICON_GRID_GROUPED"] = "1"
    try:
        ref = ref_reconstruct_grid(image, twists=TWISTS, rises=RISES, cost_analysis=True,
                                   devices=jax.devices()[:1], **KW)
    finally:
        if old is None:
            os.environ.pop("HELICON_GRID_GROUPED", None)
        else:
            os.environ["HELICON_GRID_GROUPED"] = old
    port = reconstruct_grid(image, twists=TWISTS, rises=RISES, cost_analysis=True,
                            device="cpu", **KW)
    assert port.effective["path"] == ref.effective["path"] == "grouped"
    _check_cost(port.cost)
    if ref.cost is not None:
        want = ref.cost["analytic_flops_per_candidate"]
        assert set(ref.cost) <= set(port.cost)
        assert port.cost["batch_size"] == ref.cost["batch_size"]
    else:  # the reference's compiler count is best effort
        cfg = types.SimpleNamespace(cg_iters=8, fista_iters=6, power_iters=2)
        want = ref_grid._grouped_analytic_flops(port.geom, cfg, port.effective["C_u"],
                                                port.effective["n_ops"])
    assert port.cost["analytic_flops_per_candidate"] == want
    # the search without the count: the same scores, no cost
    plain = reconstruct_grid(image, twists=TWISTS, rises=RISES, device="cpu", **KW)
    assert plain.cost is None
    np.testing.assert_array_equal(plain.scores, port.scores)


@pytest.mark.parametrize("case", range(4))
def test_count_function_equals_reference(case):
    """_grouped_analytic_flops against the JAX package's on seeded
    geometries and budgets, exactly."""
    g = np.random.default_rng(case)
    geom = types.SimpleNamespace(d2=int(g.integers(8, 80)), d3=int(g.integers(8, 80)),
                                 l3=int(g.integers(2, 40)))
    cfg = types.SimpleNamespace(cg_iters=int(g.integers(1, 200)),
                                fista_iters=int(g.integers(0, 100)),
                                power_iters=int(g.integers(0, 10)))
    C_u, n_ops = int(g.integers(1, 400)), int(g.integers(1, 12))
    assert (grid._grouped_analytic_flops(geom, cfg, C_u, n_ops)
            == ref_grid._grouped_analytic_flops(geom, cfg, C_u, n_ops))


@pytest.mark.parametrize("tilt", [0.0, 3.0])
def test_per_candidate_cost(image, tilt):
    """One twist a candidate goes per candidate: the cost of one launch of
    the path's batch, on B2's separable factors at tilt 0 and on the
    gather projector at tilt 3."""
    tw, ri = np.float32([25.0, 30.0, 35.0]), np.float32([6.0, 6.0, 6.0])
    res = reconstruct_grid(image, twists=tw, rises=ri, cost_analysis=True, device="cpu",
                           tilt=tilt, **dict(KW, cg_iters=4, fista_iters=2, batch_size=2))
    assert res.effective["path"] == "percand"
    _check_cost(res.cost)
    assert res.cost["batch_size"] == res.effective["batch_size"] == 2


def _spy(monkeypatch):
    """grid.reconstruct_grid wrapped: the list of every call's result, in
    the order the calls return."""
    real, out = grid.reconstruct_grid, []

    def spied(*a, **k):
        r = real(*a, **k)
        out.append(r)
        return r

    monkeypatch.setattr(grid, "reconstruct_grid", spied)
    return real, out


def test_bucketed_driver_keeps_the_first_bucket_cost(monkeypatch):
    image, tw, ri, kw = tiny_workload(bucketed=True)
    real, calls = _spy(monkeypatch)
    res = real(image, twists=tw, rises=ri, cost_analysis=True, **kw)
    assert res.effective["n_buckets"] == 2
    _check_cost(res.cost)
    assert res.cost is calls[0].cost


def test_checkpointed_driver_keeps_the_first_chunk_cost(monkeypatch, tmp_path):
    image, tw, ri, kw = tiny_workload(bucketed=False)
    _, calls = _spy(monkeypatch)
    res = reconstruct_grid_checkpointed(image, twists=tw, rises=ri, cost_analysis=True,
                                        checkpoint_path=str(tmp_path / "ck.npz"), chunk=3,
                                        **kw)
    assert res.effective["chunks_run"] == 3
    _check_cost(res.cost)
    assert res.cost is calls[0].cost


def test_process_sharded_driver_keeps_the_first_cost(monkeypatch):
    """The process-sharded path in one process (the exchange an identity):
    the cost of its first pass's first sub-call."""
    monkeypatch.setattr(multihost, "is_distributed", lambda: True)
    monkeypatch.setattr(multihost, "_world", lambda: (1, 0))
    monkeypatch.setattr(multihost, "_card_processes", lambda device: 1)
    monkeypatch.setattr(multihost, "_psum_exchange",
                        lambda c, clock=None: np.array(c, np.float32))
    image, tw, ri, kw = tiny_workload(bucketed=True)
    _, calls = _spy(monkeypatch)
    res = multihost.multihost_reconstruct_grid(image, twists=tw, rises=ri,
                                               cost_analysis=True, **kw)
    _check_cost(res.cost)
    assert res.cost is calls[0].cost


def test_refine_all_runs_the_fixed_pose_pass_under_cost_analysis(image):
    """refine_mode "all" skips the fixed-pose pass, unless cost_analysis
    asks for its count (as the JAX package)."""
    kw = dict(KW, cg_iters=3, fista_iters=2, twists=np.float32([30.0, 30.0]),
              rises=np.float32([5.8, 6.0]), target_apix2d=4.0, device="cpu",
              refine_tilt_psi_dy_range=dict(dy=1.0), refine_mode="all")
    res = reconstruct_grid(image, cost_analysis=True, **kw)
    assert res.effective["path"] == "grouped"
    _check_cost(res.cost)
    assert res.refined_params is not None and len(res.refined_params) == 2
