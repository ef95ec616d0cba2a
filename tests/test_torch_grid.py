"""The PyTorch port's grid search end to end against the JAX package, on
the committed amyloid class average (the golden of
tests/test_denovo3d_pipeline.py::test_golden_amyloid_class_average_recovers_params).

The JAX side runs under jax.disable_jit(). Jitted, XLA evaluates the
nearest-neighbour z positions (s*i - h*rise + l3//2) with fused
multiply-adds, which moves samples that sit exactly half-way between two
z planes; on this golden that changes the scores by up to 6.4e-4, while
the unfused arithmetic, float64 and the port agree to 2e-5. The ranking
(top-5) is the same either way.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu_torch.denovo3d import build_candidate_grid, reconstruct_grid

ROOT = pathlib.Path(__file__).resolve().parent.parent
AMYLOID = ROOT / "tests" / "data" / "class_avg_amyloid.npy"
GOLDEN = dict(apix=2.0, tube_diameter=110.0, cg_iters=10, fista_iters=16, power_iters=2,
              compute_dtype="float32", return_best_volume=True)


@pytest.fixture(scope="module")
def amyloid():
    return np.load(AMYLOID)


@pytest.fixture(scope="module")
def golden(amyloid):
    tw, ri = build_candidate_grid(1.0, 3.0, 0.25, 4.45, 5.06, 0.15, handedness="left")
    port = reconstruct_grid(amyloid, twists=tw, rises=ri, device="cpu", **GOLDEN)
    with jax.disable_jit():
        ref = ref_reconstruct_grid(amyloid, twists=tw, rises=ri, batch_size=32,
                                   devices=jax.devices()[:1], **GOLDEN)
    return port, ref


def test_golden_top1(golden):
    port, _ = golden
    assert len(port.scores) == 45
    assert tuple(port.top(1)[0][:2]) == (2.0, 4.75), port.top(5)


def test_golden_scores_match_reference(golden):
    port, ref = golden
    assert dataclasses.astuple(port.geom) == dataclasses.astuple(ref.geom)
    np.testing.assert_allclose(port.scores, ref.scores, atol=1e-4)
    np.testing.assert_array_equal(np.argsort(-port.scores)[:5], np.argsort(-ref.scores)[:5])


def test_golden_best_volume_matches_reference(golden):
    port, ref = golden
    assert port.best_index == ref.best_index
    assert port.best_volume.shape == ref.best_volume.shape == port.geom.volume_shape
    rel = np.abs(port.best_volume - ref.best_volume).max() / np.abs(ref.best_volume).max()
    assert rel < 1e-4, rel


def test_estimated_tube_diameter(amyloid):
    """tube_diameter=-1: the geometry comes from the helix estimator. (The
    golden's iteration budget: with CG converged this far, the two power
    iteration seeds, rhs here and ones in the JAX package's XLA path, give
    the same scores to well under 1e-4.)"""
    kw = dict(GOLDEN, twists=np.asarray([2.0, 2.0], np.float32),
              rises=np.asarray([4.6, 4.75], np.float32), tube_diameter=-1,
              return_best_volume=False)
    port = reconstruct_grid(amyloid, device="cpu", **kw)
    with jax.disable_jit():
        ref = ref_reconstruct_grid(amyloid, devices=jax.devices()[:1], **kw)
    assert dataclasses.astuple(port.geom) == dataclasses.astuple(ref.geom)
    np.testing.assert_allclose(port.scores, ref.scores, atol=1e-4)


# the solver envelope: one model, the lreg seed's model, a 2D metric, fsc
ENVELOPE = dict(elasticnet=dict(algorithm=dict(model="elasticnet")),
                lreg=dict(algorithm=dict(model="lreg")),
                ssim=dict(score_metric="ssim"),
                fsc2=dict(fsc_test=2))


@pytest.mark.parametrize("name", sorted(ENVELOPE))
def test_envelope_matches_reference(amyloid, name):
    """reconstruct_grid under the solver envelope on a 2-candidate grid:
    scores within 1e-4, the best index and the best volume (rel 1e-4)."""
    kw = dict(GOLDEN, twists=np.float32([2.0, 2.0]), rises=np.float32([4.75, 4.9]),
              **ENVELOPE[name])
    port = reconstruct_grid(amyloid, device="cpu", **kw)
    with jax.disable_jit():
        ref = ref_reconstruct_grid(amyloid, batch_size=32, devices=jax.devices()[:1], **kw)
    np.testing.assert_allclose(port.scores, ref.scores, atol=1e-4)
    assert port.best_index == ref.best_index
    rel = np.abs(port.best_volume - ref.best_volume).max() / np.abs(ref.best_volume).max()
    assert rel < 1e-4, rel


OUT_OF_SLICE = dict(
    # tilt, psi, ard, ridge, ssim, fsc and thresh are ported (tilt, psi,
    # ard and fsc with l1/l2 on the per-candidate path: tests/
    # test_torch_percand.py); each case keeps its name on a combination
    # that still raises: with refinement (ROADMAP A8), fsc with a 2D metric
    # or thresh on the grouped path (A6.6b), several devices (A10)
    tilt=dict(tilt=2.0, refine_tilt_psi_dy_range=dict(tilt=5.0)),
    psi=dict(psi=1.0, refine_tilt_psi_dy_range=dict(psi=2.0), refine_mode="all"),
    refine=dict(refine_tilt_psi_dy_range=dict(tilt=5.0, psi=2.0, dy=1.0)),
    ridge=dict(algorithm=dict(model="ridge", alpha=0.1), fsc_test=2,
               refine_tilt_psi_dy_range=dict(dy=1.0)),
    ssim=dict(score_metric="ssim", fsc_test=2),
    thresh=dict(thresh_fraction=0.1, fsc_test=3),
    ard=dict(algorithm=dict(model="ard"), devices=["cuda:0", "cuda:1"]),
    fsc_lreg=dict(algorithm=dict(model="lreg"), fsc_test=2),
    devices=dict(devices=["cuda:0", "cuda:1"]),
    cost_analysis=dict(cost_analysis=True),
)


@pytest.mark.parametrize("name", sorted(OUT_OF_SLICE))
def test_out_of_slice_arguments_raise(amyloid, name):
    kw = dict(apix=2.0, twists=np.asarray([2.0, 2.0], np.float32),
              rises=np.asarray([4.6, 4.75], np.float32), tube_diameter=110.0, device="cpu")
    kw.update(OUT_OF_SLICE[name])
    with pytest.raises(NotImplementedError):
        reconstruct_grid(amyloid, **kw)


def _record():
    calls = []
    return calls, lambda done, n, scores: calls.append((done, n, scores.copy()))


# the arguments that raised until the port took the prep options, the
# search drivers and fsc mode 1; each runs on the 2-candidate amyloid grid
# against the reference (image: the amyloid, or its transpose)
PORTED = dict(
    low_pass=dict(low_pass=10.0),
    denoise=dict(denoise="nl_mean"),
    # a vertical filament, transposed back by the CLI's default
    transpose=dict(transpose=-1, image="transposed"),
    horizontalize=dict(horizontalize=1),
    fsc=dict(fsc_test=1),
    bucketing=dict(rises=np.asarray([4.0, 8.0], np.float32)),
    progress=dict(progress_callback="record"),
    # stops before the first launch: every score -inf, no best volume
    abort=dict(should_abort=lambda: True),
)


@pytest.mark.parametrize("name", sorted(PORTED))
def test_formerly_out_of_slice_matches_reference(amyloid, name, monkeypatch):
    if name == "bucketing":
        # the reference's calls of one candidate per twist on its grouped
        # XLA path: its per-candidate path gives the same scores (its
        # tests/test_grouped_solver.py, 2e-5) at seven times the eager run
        # time
        monkeypatch.setenv("HELICON_GRID_GROUPED", "1")
    kw = dict(GOLDEN, twists=np.asarray([2.0, 2.0], np.float32),
              rises=np.asarray([4.6, 4.75], np.float32))
    kw.update(PORTED[name])
    image = amyloid.T.copy() if kw.pop("image", None) == "transposed" else amyloid
    calls = {}
    if kw.get("progress_callback") == "record":
        (calls["port"], kw["progress_callback"]), (calls["ref"], ref_cb) = _record(), _record()
    port = reconstruct_grid(image, device="cpu", **kw)
    if calls:
        kw["progress_callback"] = ref_cb
    with jax.disable_jit():
        ref = ref_reconstruct_grid(image, batch_size=32, devices=jax.devices()[:1], **kw)
    if name == "abort":
        assert np.isneginf(port.scores).all() and np.isneginf(ref.scores).all()
        assert port.best_volume is None and ref.best_volume is None
        return
    np.testing.assert_allclose(port.scores, ref.scores, atol=1e-4)
    assert port.best_index == ref.best_index
    assert dataclasses.astuple(port.geom) == dataclasses.astuple(ref.geom)
    rel = np.abs(port.best_volume - ref.best_volume).max() / np.abs(ref.best_volume).max()
    # horizontalize: the two Nelder-Mead searches follow float values and
    # stop apart within their xtol (4.4e-5 deg, 2.7e-4 px here), which
    # moves this volume by 1.8e-4 relative; the scores hold at 1e-4
    assert rel < (1e-3 if name == "horizontalize" else 1e-4), rel
    if calls:
        assert [c[:2] for c in calls["port"]] == [c[:2] for c in calls["ref"]] == [(2, 2)]
        np.testing.assert_array_equal(calls["port"][-1][2], port.scores)
    if name == "bucketing":
        assert port.effective["n_buckets"] == 2


def test_tf32_off_during_search_and_restored_after():
    from helicon_tpu_torch.denovo3d.grid import _tf32_off

    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    seen = []
    try:
        for f in flags:
            f.allow_tf32 = True
        _tf32_off(lambda: seen.append([f.allow_tf32 for f in flags]))()
        assert seen == [[False, False]]
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, on in zip(flags, saved):
            f.allow_tf32 = on


def test_port_imports_no_jax():
    code = ("import helicon_tpu_torch.denovo3d, helicon_tpu_torch.denovo3d.candidate_solve, "
            "helicon_tpu_torch.denovo3d.checkpoint, helicon_tpu_torch.helix.orient, "
            "helicon_tpu_torch.core.analysis, helicon_tpu_torch.core.denoise, "
            "helicon_tpu_torch.core.filters, helicon_tpu_torch._jax_random, "
            "helicon_tpu_torch.utils.exceptions, sys; "
            "assert 'jax' not in sys.modules and 'helicon_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
