"""fsc on the port's grouped path with the options its kernel does not
score (lreg, a 2D metric, thresh; fsc modes 1, 2 and 4) against the JAX
package run under jax.disable_jit() on the 2-candidate amyloid grid, the
reference's runs shared through the module fixture
``grouped_fsc_reference``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu_torch.denovo3d import reconstruct_grid
from test_torch_grid import AMYLOID, GOLDEN


@pytest.fixture(scope="module")
def amyloid():
    return np.load(AMYLOID)


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
