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
    # tilt, psi, ard, ridge, ssim, fsc, thresh and refinement are ported
    # (the refine rows: tests/test_torch_refine.py's
    # test_refine_rows_match_reference; fsc with lreg, a 2D metric or thresh
    # on the grouped path: test_grouped_fsc_options_match_reference); each
    # case keeps its name on a combination that still raises: several
    # devices (ROADMAP A10b), cost_analysis (A5c)
    ard=dict(algorithm=dict(model="ard"), devices=["cuda:0", "cuda:1"]),
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


# fsc on the grouped path with the options the kernel does not score: the
# three cases that raised until then, and fsc modes 1 and 4 on the same
# path (lreg: the reference's routing rule sends fsc under l1 / l2, so
# elasticnet's, per candidate; tests/test_torch_percand_grid.py holds it)
GROUPED_FSC = dict(
    ssim=dict(score_metric="ssim", fsc_test=2),
    thresh=dict(thresh_fraction=0.1, fsc_test=3),
    fsc_lreg=dict(algorithm=dict(model="lreg"), fsc_test=2),
    fsc1_lreg=dict(algorithm=dict(model="lreg"), fsc_test=1),
    fsc4_lreg=dict(algorithm=dict(model="lreg"), fsc_test=4),
)
# the best volume is the full set's solve, whatever the fsc mode (the
# reference's are bit-identical for modes 1, 2 and 4): the reference
# re-solves it once, in fsc_lreg's run, for the three lreg cases
SHARED_BEST_VOLUME = dict(fsc1_lreg="fsc_lreg", fsc4_lreg="fsc_lreg")


@pytest.fixture(scope="module")
def grouped_fsc_reference(amyloid):
    """The reference's eager reconstruct_grid on the 2-candidate grid, once
    per (option, return_best_volume)."""
    runs = {}

    def run(name, best_volume=True):
        if (name, best_volume) not in runs:
            kw = dict(GOLDEN, twists=np.asarray([2.0, 2.0], np.float32),
                      rises=np.asarray([4.6, 4.75], np.float32), **GROUPED_FSC[name])
            kw["return_best_volume"] = best_volume
            with jax.disable_jit():
                runs[name, best_volume] = ref_reconstruct_grid(
                    amyloid, batch_size=32, devices=jax.devices()[:1], **kw)
        return runs[name, best_volume]

    return run


@pytest.mark.parametrize("name", sorted(GROUPED_FSC))
def test_grouped_fsc_options_match_reference(amyloid, name, grouped_fsc_reference):
    """fsc with lreg, a 2D metric or thresh on the grouped path (three B1
    solves a launch, each half scored in torch) on the 2-candidate grid:
    scores within 1e-4, the best index and the best volume (rel 1e-4)."""
    kw = dict(GOLDEN, twists=np.asarray([2.0, 2.0], np.float32),
              rises=np.asarray([4.6, 4.75], np.float32), **GROUPED_FSC[name])
    port = reconstruct_grid(amyloid, device="cpu", **kw)
    assert port.effective["path"] == "grouped"
    assert not port.effective["score_in_kernel"]
    shared = SHARED_BEST_VOLUME.get(name)
    ref = grouped_fsc_reference(name, best_volume=shared is None)
    np.testing.assert_allclose(port.scores, ref.scores, atol=1e-4)
    assert port.best_index == ref.best_index
    if shared is not None:
        ref = grouped_fsc_reference(shared)
        assert ref.best_index == port.best_index
    rel = np.abs(port.best_volume - ref.best_volume).max() / np.abs(ref.best_volume).max()
    assert rel < 1e-4, rel


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
            "helicon_tpu_torch.denovo3d.checkpoint, helicon_tpu_torch.denovo3d.refine, "
            "helicon_tpu_torch.denovo3d.gather_kernels, helicon_tpu_torch.helix.orient, "
            "helicon_tpu_torch.core.analysis, helicon_tpu_torch.core.denoise, "
            "helicon_tpu_torch.core.filters, helicon_tpu_torch._jax_random, "
            "helicon_tpu_torch.utils.exceptions, helicon_tpu_torch.utils.logging, "
            "helicon_tpu_torch.io.mrc, helicon_tpu_torch.parallel, "
            "helicon_tpu_torch.parallel.multihost, helicon_tpu_torch.commands.helicon, "
            "helicon_tpu_torch.commands.denovo3d_cli, helicon_tpu_torch.core.alignment, "
            "helicon_tpu_torch.core.rotation, helicon_tpu_torch.core.transforms, "
            "helicon_tpu_torch.webApps.denovo3D, helicon_tpu_torch.webApps.denovo3D.workflow, "
            "helicon_tpu_torch.webApps.denovo3D.solver_linear_regression, "
            "helicon_tpu_torch.webApps.denovo3D.pipeline, helicon_tpu_torch.webApps.denovo3D.utils, "
            "helicon_tpu_torch.commands.proc3d, helicon_tpu_torch.commands.trueFSC, "
            "helicon_tpu_torch.ops.proc3d, helicon_tpu_torch.core.mask3d, "
            "helicon_tpu_torch.core.czt, helicon_tpu_torch.core.curvelet, "
            "helicon_tpu_torch.angular, helicon_tpu_torch.euler, helicon_tpu_torch.gauss, "
            "helicon_tpu_torch.point_group, helicon_tpu_torch.helix, "
            "helicon_tpu_torch.helix.indexing, helicon_tpu_torch.helix.lattice, "
            "helicon_tpu_torch.helix.pitch, helicon_tpu_torch.core.ctf, "
            "helicon_tpu_torch.core.xcorr, helicon_tpu_torch.core.ptycho, "
            "helicon_tpu_torch.core.interp, helicon_tpu_torch.utils.tensors, "
            "helicon_tpu_torch.utils.system, helicon_tpu_torch.utils.collections, "
            "helicon_tpu_torch.utils.path_utils, helicon_tpu_torch.io.star, "
            "helicon_tpu_torch.io.cs, helicon_tpu_torch.io.csdat, helicon_tpu_torch.io.epu, "
            "helicon_tpu_torch.io.groups, helicon_tpu_torch.io.metadata, "
            "helicon_tpu_torch.ops.images2star, helicon_tpu_torch.ops.images2star.parm, "
            "helicon_tpu_torch.ops.images2star.select, helicon_tpu_torch.ops.images2star.sort, "
            "helicon_tpu_torch.ops.images2star.dedup, "
            "helicon_tpu_torch.ops.images2star.helixops, "
            "helicon_tpu_torch.ops.images2star.optics, "
            "helicon_tpu_torch.ops.images2star.stacks, "
            "helicon_tpu_torch.ops.images2star.heavy, "
            "helicon_tpu_torch.commands.images2star, sys; "
            "assert 'jax' not in sys.modules and 'helicon_tpu' not in sys.modules "
            "and 'helicon' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
