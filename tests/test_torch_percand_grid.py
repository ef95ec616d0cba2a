"""The PyTorch port's reconstruct_grid on the per-candidate path against
the JAX package (forced with HELICON_GRID_GROUPED=0, and taken by the
reference's own rule) for lsq, tilt 3 deg, ard and elasticnet with fsc:
scores within 1e-4 and the same top-1 (tests/test_torch_percand.py holds
the single-candidate solve and B2's entries).

The JAX side runs eagerly (jax.disable_jit()), as in tests/test_torch_grid.py:
jitted, XLA fuses the nearest-neighbour z positions' arithmetic and moves
samples that sit half-way between two planes (ROADMAP C6). The tilted
configuration runs it jitted: at tilt 3 deg no sample sits half-way, and
its eager gather solves cost minutes (jitted, the scores agree to
1.1e-6)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu.helix import simulate_helical_projection as ref_simulate
from helicon_tpu_torch.denovo3d import reconstruct_grid

GRID_KW = dict(apix=2.0, tube_diameter=44.0, reconstruct_length_rise=3.0, sym_oversample=2,
               cg_iters=10, fista_iters=16, power_iters=2, compute_dtype="float32",
               return_best_volume=True)


@pytest.fixture(scope="module")
def image():
    return np.array(ref_simulate(
        n=1, twist=30.0, rise=6.0, csym=1, helical_diameter=40.0, ball_radius=5.0, polymer=0,
        planarity=1.0, ny=48, nx=96, apix=2.0, rng=0), np.float32)


# twists off 30 deg (C11's half-way ties), two rises each
GRID = dict(twists=np.float32([29.5, 29.5, 31.0, 31.0]), rises=np.float32([5.8, 6.2, 5.8, 6.2]))
CONFIGS = dict(
    lsq=dict(),
    tilt=dict(tilt=3.0),
    ard=dict(algorithm=dict(model="ard")),
    elasticnet_fsc=dict(algorithm=dict(model="elasticnet"), fsc_test=2),
)


def _both(image, monkeypatch, env, **kw):
    if env is not None:
        monkeypatch.setenv("HELICON_GRID_GROUPED", env)
    port = reconstruct_grid(image, device="cpu", **kw)
    with contextlib.nullcontext() if kw.get("tilt") else jax.disable_jit():
        ref = ref_reconstruct_grid(image, devices=jax.devices()[:1], **kw)
    return port, ref


def _assert_matches(port, ref, ard=False):
    """Scores 1e-4, the same top-1 and geometry; the best volume rel 1e-4,
    or for ard by correlation (test_solve_candidate_matches_reference)."""
    np.testing.assert_allclose(port.scores, ref.scores, atol=1e-4)
    assert port.best_index == ref.best_index
    assert dataclasses.astuple(port.geom) == dataclasses.astuple(ref.geom)
    p, r = port.best_volume, ref.best_volume
    if ard:
        assert np.corrcoef(p.ravel(), r.ravel())[0, 1] > 0.999
    else:
        assert np.abs(p - r).max() <= 1e-4 * np.abs(r).max()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_percand_grid_matches_reference(image, monkeypatch, name):
    port, ref = _both(image, monkeypatch, "0", **GRID_KW, **GRID, **CONFIGS[name])
    assert port.effective["path"] == ref.effective["path"] == "percand"
    _assert_matches(port, ref, ard=name == "ard")


def test_one_candidate_per_twist_goes_per_candidate(image, monkeypatch):
    """The reference's rule without HELICON_GRID_GROUPED: fewer than two
    candidates per twist take the per-candidate path."""
    monkeypatch.delenv("HELICON_GRID_GROUPED", raising=False)
    grid = dict(twists=np.float32([29.5, 31.0, 33.0]), rises=np.float32([6.0, 6.0, 6.0]))
    port, ref = _both(image, monkeypatch, None, **GRID_KW, **grid)
    assert port.effective["path"] == ref.effective["path"] == "percand"
    _assert_matches(port, ref)
    assert port.effective["b2_launches"] == 0  # CPU tensors run B2's plain version
