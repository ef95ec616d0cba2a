"""The PyTorch port's grid search on the golden of
tests/test_denovo3d_pipeline.py::test_golden_amyloid_class_average_recovers_params
(45 candidates on the committed amyloid class average) against the JAX
package run under jax.disable_jit() (tests/test_torch_grid.py says why):
the top-1, the scores and the best volume, from one run of each package
shared through the module fixture ``golden``.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu_torch.denovo3d import build_candidate_grid, reconstruct_grid
from test_torch_grid import AMYLOID, GOLDEN


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
