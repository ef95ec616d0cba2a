"""The PyTorch port's grid search end to end against the JAX package, on
the committed amyloid class average: the estimated tube diameter, the
solver envelope, the arguments that raised until they were ported, TF32
and the port's imports. The golden of
tests/test_denovo3d_pipeline.py::test_golden_amyloid_class_average_recovers_params
is in tests/test_torch_grid_golden.py, fsc on the grouped path in
tests/test_torch_grid_fsc.py and the formerly out-of-slice arguments in
tests/test_torch_grid_ported.py; they share this file's AMYLOID and
GOLDEN.

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
from helicon_tpu_torch.denovo3d import reconstruct_grid

ROOT = pathlib.Path(__file__).resolve().parent.parent
AMYLOID = ROOT / "tests" / "data" / "class_avg_amyloid.npy"
GOLDEN = dict(apix=2.0, tube_diameter=110.0, cg_iters=10, fista_iters=16, power_iters=2,
              compute_dtype="float32", return_best_volume=True)


@pytest.fixture(scope="module")
def amyloid():
    return np.load(AMYLOID)


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
    # the arguments that raised until several devices (ROADMAP A10b) and
    # cost_analysis (A5c's count) were ported; each case keeps its name and
    # now holds the working behaviour: ard on two shards equals one device,
    # a card this machine lacks still raises, cost_analysis fills the cost
    ard=dict(algorithm=dict(model="ard"), devices=["cpu", "cpu"]),
    devices=dict(devices=["cpu", "cuda:7"]),
    cost_analysis=dict(cost_analysis=True),
)


@pytest.mark.parametrize("name", sorted(OUT_OF_SLICE))
def test_out_of_slice_arguments_raise(amyloid, name):
    kw = dict(apix=2.0, twists=np.asarray([2.0, 2.0], np.float32),
              rises=np.asarray([4.6, 4.75], np.float32), tube_diameter=110.0, device="cpu",
              cg_iters=4, fista_iters=4, power_iters=2, return_best_volume=False,
              target_apix2d=6.0)
    if name == "devices":
        if torch.cuda.is_available() and torch.cuda.device_count() > 7:
            pytest.skip("this machine has eight cards")
        with pytest.raises(ValueError, match="CUDA device"):
            reconstruct_grid(amyloid, **kw, **OUT_OF_SLICE[name])
        return
    res = reconstruct_grid(amyloid, **kw, **OUT_OF_SLICE[name])
    if name == "ard":
        one = reconstruct_grid(amyloid, **kw, algorithm=dict(model="ard"))
        assert res.effective["path"] == "percand" and res.effective["n_devices"] == 2
        np.testing.assert_array_equal(res.scores, one.scores)
    else:
        assert res.cost["source"] == "analytic" and res.cost["flops"] > 0
        assert res.cost["batch_size"] == res.effective["R"]


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
            "helicon_tpu_torch.commands.images2star, helicon_tpu_torch.utils.cache, "
            "helicon_tpu_torch.webApps.whereIsMyClass, "
            "helicon_tpu_torch.webApps.whereIsMyClass.compute, "
            "helicon_tpu_torch.commands.HOM_containerC, "
            "helicon_tpu_torch.commands.symmetry_mismatch, "
            "helicon_tpu_torch.commands.cryosparc, helicon_tpu_torch.ops.cryosparc, "
            "helicon_tpu_torch.ops.cryosparc.exposure_ops, "
            "helicon_tpu_torch.ops.cryosparc.extract, helicon_tpu_torch.io.dataset, "
            "helicon_tpu_torch.clustering, helicon_tpu_torch.utils.shiny, "
            "helicon_tpu_torch.commands.helicon, helicon_tpu_torch.commands._launchers, "
            "helicon_tpu_torch.commands.denovo3D, helicon_tpu_torch.commands.whereIsMyClass, "
            "helicon_tpu_torch.commands.hill, helicon_tpu_torch.commands.map2seq, sys; "
            "assert 'jax' not in sys.modules and 'helicon_tpu' not in sys.modules "
            "and 'helicon' not in sys.modules and 'sklearn' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
