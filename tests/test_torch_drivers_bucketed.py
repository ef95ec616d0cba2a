"""The PyTorch port's rise bucketing against the JAX package on the
bucketed tiny workload (tests/_mh_worker.py): the bucketed search, its
progress and abort, and the checkpointed search against the one-shot one.
The tests share one port run and one eager reference run through the
module fixture ``tiny_bucketed``; the helpers and the rest of the search
drivers' tests are in tests/test_torch_drivers.py.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.denovo3d import grid as ref_grid
from helicon_tpu_torch.denovo3d import reconstruct_grid_checkpointed
from test_torch_drivers import _port, _ref, _tiny


@pytest.fixture(scope="module")
def tiny_bucketed():
    image, tw, ri, kw = _tiny(bucketed=True)
    return _port(image, tw, ri, **kw), _ref(image, tw, ri, **kw), ri


def test_bucketed_tiny_workload_matches_reference(tiny_bucketed):
    port, ref, ri = tiny_bucketed
    np.testing.assert_allclose(port.scores, ref.scores, rtol=0, atol=1e-4)
    assert port.best_index == ref.best_index
    assert port.effective["n_buckets"] == len(ref_grid._rise_buckets(ri, 1.6)) == 2


def test_bucketed_progress_and_abort(tiny_bucketed):
    image, tw, ri, kw = _tiny(bucketed=True)
    seen = []
    res = _port(image, tw, ri, progress_callback=lambda d, n, s: seen.append((d, n)), **kw)
    done = [d for d, _ in seen]
    assert done == sorted(done) and seen[-1] == (6, 6) and all(n == 6 for _, n in seen)
    np.testing.assert_array_equal(res.scores, tiny_bucketed[0].scores)
    # an abort inside the first bucket: partial scores, no second pass
    calls = []
    res = _port(image, tw, ri, should_abort=lambda: calls.append(1) or len(calls) > 2,
                **dict(kw, return_best_volume=True))
    assert res.effective["aborted"] and res.best_volume is None
    second = ref_grid._rise_buckets(ri, 1.6)[1]
    assert np.isneginf(res.scores[second]).all() and 0 < np.isfinite(res.scores).sum() < 6


@pytest.mark.parametrize("bucketed,chunk", [(False, 3), (True, 2)])
def test_checkpointed_matches_oneshot(bucketed, chunk, tmp_path, tiny_bucketed):
    image, tw, ri, kw = _tiny(bucketed)
    one = tiny_bucketed[0] if bucketed else _port(image, tw, ri, **kw)
    got = reconstruct_grid_checkpointed(image, twists=tw, rises=ri, chunk=chunk, device="cpu",
                                        checkpoint_path=str(tmp_path / "c.npz"), **kw)
    np.testing.assert_allclose(got.scores, one.scores, rtol=0, atol=2e-5)
    assert got.best_index == one.best_index
    assert got.effective["checkpointed"]
    assert got.effective["n_buckets"] == (2 if bucketed else 1)
    if not bucketed:
        assert got.effective["chunks_run"] == -(-len(tw) // chunk)
