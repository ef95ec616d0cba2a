"""The PyTorch port's incremental mode and checkpoint shards against the
JAX package on the tiny workload (tests/_mh_worker.py): progress without
a batch size, the progress protocol, an abort after the first launch, and
shards that resume across packages. The tests share one eager reference
run as the web app calls it through the module fixture ``tiny_reference``;
the helpers and the rest of the search drivers' tests are in
tests/test_torch_drivers.py.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu_torch.denovo3d import reconstruct_grid_checkpointed
from test_torch_drivers import _port, _ref, _ref_checkpointed, _tiny


@pytest.fixture(scope="module")
def tiny_reference():
    """The reference on the tiny workload as the web app calls it: no
    batch_size, a progress callback. R = 3 as at batch_size 4, so the
    scores are those of either call. Returns (result, [(done, n)])."""
    image, tw, ri, kw = _tiny()
    seen = []
    res = _ref(image, tw, ri, progress_callback=lambda d, n, s: seen.append((d, n)),
               **dict(kw, batch_size=None))
    return res, seen


def test_progress_without_batch_size_matches_reference(tiny_reference):
    """With no batch_size a launch holds the reference's automatic batch
    (the whole grid of 7 here: two groups of R = 3), so progress arrives
    when the reference's does."""
    ref, ref_seen = tiny_reference
    image, tw, ri, kw = _tiny()
    seen = []
    res = _port(image, tw, ri, progress_callback=lambda d, n, s: seen.append((d, n)),
                **dict(kw, batch_size=None))
    assert res.effective["R"] == 3 and res.effective["groups_per_launch"] == 2
    assert seen == ref_seen == [(6, 7), (7, 7)]
    np.testing.assert_allclose(res.scores, ref.scores, rtol=0, atol=1e-4)


def test_progress_protocol(tiny_reference):
    """batch_size 4 at R = 3: one group per launch, a progress call after
    each, unscored candidates at -inf in every snapshot."""
    image, tw, ri, kw = _tiny()
    seen = []
    res = _port(image, tw, ri, progress_callback=lambda d, n, s: seen.append((d, n, s.copy())),
                **kw)
    assert res.effective["R"] == 3 and res.effective["groups_per_launch"] == 1
    assert [(d, n) for d, n, _ in seen] == [(3, 7), (6, 7), (7, 7)]
    for d, _, s in seen:
        assert np.isfinite(s).sum() == d and np.isneginf(s).sum() == 7 - d
    np.testing.assert_array_equal(seen[-1][2], res.scores)
    np.testing.assert_allclose(res.scores, tiny_reference[0].scores, rtol=0, atol=1e-4)


def test_abort_after_first_launch_matches_reference(tiny_reference):
    """Both packages launch two groups of three when no batch_size is given:
    an abort after the first launch leaves the same candidate at -inf, and
    no best volume."""
    image, tw, ri, kw = _tiny()
    kw = dict(kw, return_best_volume=True, batch_size=None)

    def abort_after(k):
        calls = []
        return lambda: calls.append(1) or len(calls) > k

    port = _port(image, tw, ri, should_abort=abort_after(1), **kw)
    ref = _ref(image, tw, ri, should_abort=abort_after(1), **kw)
    assert port.best_volume is None and ref.best_volume is None
    assert port.effective["aborted"]
    np.testing.assert_array_equal(np.isneginf(port.scores), np.isneginf(ref.scores))
    assert np.isfinite(port.scores).sum() == 6
    done = np.isfinite(port.scores)
    np.testing.assert_allclose(port.scores[done], tiny_reference[0].scores[done], rtol=0,
                               atol=1e-4)


def test_shards_resume_across_packages(tmp_path, tiny_reference):
    """A shard the reference wrote resumes in the port, and one the port
    wrote resumes in the reference: each scores only the missing chunk."""
    image, tw, ri, kw = _tiny()
    kw = dict(kw, chunk=4)

    def stop_after_first():
        calls = []
        return lambda: calls.append(1) or len(calls) > 1

    ck = str(tmp_path / "from_ref.npz")
    _ref_checkpointed(image, tw, ri, checkpoint_path=ck, should_abort=stop_after_first(), **kw)
    got = reconstruct_grid_checkpointed(image, twists=tw, rises=ri, checkpoint_path=ck,
                                        device="cpu", **kw)
    assert got.effective["chunks_run"] == 1
    np.testing.assert_allclose(got.scores, tiny_reference[0].scores, rtol=0, atol=1e-4)

    ck = str(tmp_path / "from_port.npz")
    reconstruct_grid_checkpointed(image, twists=tw, rises=ri, checkpoint_path=ck, device="cpu",
                                  should_abort=stop_after_first(), **kw)
    got = _ref_checkpointed(image, tw, ri, checkpoint_path=ck, **kw)
    assert got.effective["chunks_run"] == 1
    np.testing.assert_allclose(got.scores, tiny_reference[0].scores, rtol=0, atol=1e-4)
