"""The arguments of reconstruct_grid that raised until the port took the
prep options, the search drivers and fsc mode 1, each on the 2-candidate
amyloid grid (or its transpose) against the JAX package run under
jax.disable_jit().
"""

import dataclasses

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
