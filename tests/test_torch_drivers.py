"""The PyTorch port's search drivers against the JAX package: the rise
bucketing and its re-scoring pass, incremental progress and abort,
densify_padding, the checkpointed search, the bucket helpers, the copy of
the exceptions module and the numpy copy of JAX's permutation.

The JAX searches run under jax.disable_jit() with one device, as in
tests/test_torch_grid.py, on the small two-process multi-host workload of
tests/_mh_worker.py; tests/test_torch_wide_rise.py holds the wide-rise
grid. An eager JAX search costs seconds per twist group, so the tests
share one reference run per workload through module fixtures.
"""

import inspect

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from _mh_worker import tiny_workload
from helicon_tpu.denovo3d import checkpoint as ref_checkpoint
from helicon_tpu.denovo3d import grid as ref_grid
from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu.utils import exceptions as ref_exceptions
from helicon_tpu_torch import _jax_random
from helicon_tpu_torch.denovo3d import checkpoint as port_checkpoint
from helicon_tpu_torch.denovo3d import grid as port_grid
from helicon_tpu_torch.denovo3d import reconstruct_grid, reconstruct_grid_checkpointed
from helicon_tpu_torch.utils import exceptions as port_exceptions

def _ref(image, tw, ri, **kw):
    with jax.disable_jit():
        return ref_reconstruct_grid(image, twists=tw, rises=ri, devices=jax.devices()[:1], **kw)


def _ref_checkpointed(image, tw, ri, **kw):
    with jax.disable_jit():
        return ref_checkpoint.reconstruct_grid_checkpointed(
            image, twists=tw, rises=ri, devices=jax.devices()[:1], **kw)


def _port(image, tw, ri, **kw):
    return reconstruct_grid(image, twists=tw, rises=ri, device="cpu", **kw)


def _tiny(bucketed=False):
    image, tw, ri, kw = tiny_workload(bucketed)
    return np.array(image, np.float32), tw, ri, kw


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 10, 1625, 1626, 5000, 14336])
def test_permutation_matches_jax(n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n))
    np.testing.assert_array_equal(_jax_random.permutation(_jax_random.PRNGKey(0), n), want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_split_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    pk = _jax_random.PRNGKey(seed)
    np.testing.assert_array_equal(pk, np.asarray(key))
    np.testing.assert_array_equal(_jax_random.split(pk, 3), np.asarray(jax.random.split(key, 3)))
    np.testing.assert_array_equal(_jax_random.random_bits(pk, 37),
                                  np.asarray(jax.random.bits(key, (37,))))
    np.testing.assert_array_equal(_jax_random.permutation(pk, 300),
                                  np.asarray(jax.random.permutation(key, 300)))


def test_exceptions_copy_matches_reference():
    assert port_exceptions.__all__ == ref_exceptions.__all__
    for name in ref_exceptions.__all__:
        p, r = getattr(port_exceptions, name), getattr(ref_exceptions, name)
        assert [c.__name__ for c in p.__mro__] == [c.__name__ for c in r.__mro__]
        assert p.__doc__ == r.__doc__


@pytest.mark.parametrize("ratio", [1.3, 1.6, 3.0])
def test_bucket_helpers_match_reference(ratio):
    rng = np.random.default_rng(int(ratio * 10))
    rises = rng.choice(np.arange(2.0, 10.25, 0.25), 200).astype(np.float32)
    scores = rng.standard_normal(200).astype(np.float32)
    want = ref_grid._rise_buckets(rises, ratio)
    got = port_grid._rise_buckets(rises, ratio)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for r in (rises, rises[rises < 3.0]):
        for g, w in zip(port_grid.global_rise_buckets(r, ratio),
                        ref_grid.global_rise_buckets(r, ratio)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port_grid.crossbucket_selection(got, scores),
                                  ref_grid.crossbucket_selection(want, scores))


def test_twist_groups_split_evenly():
    """A twist of 70 rises splits as the reference's XLA path does: two
    groups of 35, not 64 + a padded 64."""
    from helicon_tpu_torch.denovo3d.geometry import ReconstructionGeometry

    geom = ReconstructionGeometry(d2=14, l2=32, d3=12, l3=4, rmin=0.0, rmax=5.0,
                                  scale2d_to_3d=1.0)
    rp = np.linspace(1.0, 1.5, 70).astype(np.float32)
    groups, R, _ = port_grid._twist_groups(np.full(70, 2.0, np.float32), rp, geom, {}, 8,
                                           None, False)
    assert R == 35 and [len(g) for _, g, _ in groups] == [35, 35]
    groups, R, _ = port_grid._twist_groups(np.full(70, 2.0, np.float32), rp, geom, {}, 8,
                                           16, False)
    assert R == 14 and [len(g) for _, g, _ in groups] == [14] * 5


# ---------------------------------------------------------------------------
# rise bucketing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_bucketed():
    image, tw, ri, kw = _tiny(bucketed=True)
    return _port(image, tw, ri, **kw), _ref(image, tw, ri, **kw), ri


def test_bucketed_tiny_workload_matches_reference(tiny_bucketed):
    port, ref, ri = tiny_bucketed
    np.testing.assert_allclose(port.scores, ref.scores, rtol=0, atol=1e-4)
    assert port.best_index == ref.best_index
    assert port.effective["n_buckets"] == len(ref_grid._rise_buckets(ri, 1.6)) == 2


N_A, N_B = 3, 14  # bucket sizes: B > 10, so the re-scoring pass leaves out 4 of B
INFLATION = 2.0  # the longer bucket geometry's bias on bucket B's scores


@pytest.fixture()
def fake_scorer(monkeypatch):
    """reconstruct_grid replaced by an oracle: candidate i (its twist) scores
    i / 100 at per-candidate geometry; a bucket's first-pass call (several
    rises) or a pinned chunk adds INFLATION to bucket B."""
    calls = []

    def fake(image, apix, twists, rises, geometry_rise_range=None, **kw):
        twists, rises = np.asarray(twists, np.float32), np.asarray(rises, np.float32)
        coarse = geometry_rise_range is not None or len(np.unique(rises)) > 1
        s = twists / 100 + (np.where(rises > 5.0, INFLATION, 0.0) if coarse else 0.0)
        calls.append(dict(n=len(twists), coarse=coarse, volume=kw.get("return_best_volume")))
        return port_grid.GridResult(twists=twists, rises=rises, scores=s.astype(np.float32),
                                    geom=None, target_apix2d=4.0, target_apix3d=8.0,
                                    effective=dict(aborted=False))

    monkeypatch.setattr(port_grid, "reconstruct_grid", fake)
    return calls


def _inflated_grid():
    return (np.arange(N_A + N_B, dtype=np.float32),
            np.float32([2.0] * N_A + [8.0, 8.5] * (N_B // 2)))


def test_bucketed_winner_only_from_rescored(fake_scorer):
    tw, ri = _inflated_grid()
    res = port_grid._reconstruct_grid_bucketed(np.zeros((8, 8), np.float32), 2.0, tw, ri, 1.6,
                                               {}, True, None, None)
    # four candidates of B keep their inflated bucket scores, the raw argmax...
    assert int(np.argmax(res.scores)) in range(N_A, N_A + 4)
    # ...but the winner is the best re-scored candidate, and its volume is solved
    assert res.best_index == N_A + N_B - 1
    assert [c["n"] for c in fake_scorer if c["volume"]] == [1]


def test_checkpointed_winner_only_from_rescored(fake_scorer, tmp_path):
    tw, ri = _inflated_grid()
    res = reconstruct_grid_checkpointed(np.zeros((8, 8), np.float32), 2.0, tw, ri,
                                        checkpoint_path=str(tmp_path / "ck.npz"), chunk=4,
                                        return_best_volume=False)
    assert int(np.argmax(res.scores)) in range(N_A, N_A + 4)
    assert res.best_index == N_A + N_B - 1


# ---------------------------------------------------------------------------
# densify_padding
# ---------------------------------------------------------------------------

def _densify_grid():
    """Two buckets; in each, one twist has a rise less than the other, so
    its padded slot becomes the midpoint of its largest rise gap; a third
    twist's rises are all equal and keep the repeat padding."""
    tw = np.float32([25.0] * 3 + [29.4] * 2 + [33.0] * 2 + [25.0] * 3 + [29.4] * 2)
    ri = np.float32([3.0, 3.2, 3.4, 3.0, 3.4, 3.2, 3.2, 5.0, 5.5, 6.0, 5.0, 6.0])
    return tw, ri


def test_densify_extras_match_reference():
    image, _, _, kw = _tiny()
    kw = dict(kw, densify_padding=True)
    tw, ri = _densify_grid()
    port = _port(image, tw, ri, **kw)
    assert port.effective["n_buckets"] == 2
    # the reference's first pass, bucket by bucket, at the bucket geometry
    want = {k: [] for k in ("twists", "rises", "scores")}
    for idx in ref_grid._rise_buckets(ri, 1.6):
        rr = (float(ri[idx].min()), float(ri[idx].max()))
        ref = _ref(image, tw[idx], ri[idx], geometry_rise_range=rr, **kw)
        one = _port(image, tw[idx], ri[idx], geometry_rise_range=rr, **kw)
        np.testing.assert_allclose(one.scores, ref.scores, rtol=0, atol=1e-4)
        for k in want:
            want[k].append(ref.extras[k])
    want = {k: np.concatenate(v) for k, v in want.items()}
    np.testing.assert_array_equal(port.extras["twists"], want["twists"])
    np.testing.assert_array_equal(port.extras["rises"], want["rises"])
    np.testing.assert_array_equal(port.extras["twists"], np.float32([29.4, 29.4]))
    np.testing.assert_allclose(port.extras["rises"], [3.2, 5.5], rtol=1e-6)
    np.testing.assert_allclose(port.extras["scores"], want["scores"], rtol=0, atol=1e-4)
    # the requested candidates' scores do not depend on the extras
    plain = _port(image, tw, ri, **dict(kw, densify_padding=False))
    np.testing.assert_allclose(port.scores, plain.scores, rtol=0, atol=1e-6)
    assert plain.extras is None


# ---------------------------------------------------------------------------
# incremental mode
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the checkpointed search
# ---------------------------------------------------------------------------

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


def test_checkpoint_defaults_to_the_card():
    sig = inspect.signature(reconstruct_grid)
    assert sig.parameters["device"].default == "cuda"
    assert "device" not in inspect.signature(reconstruct_grid_checkpointed).parameters


def test_checkpoint_abort_then_resume(tmp_path):
    image, tw, ri, kw = _tiny()
    ck = str(tmp_path / "r.npz")
    calls = []
    partial = reconstruct_grid_checkpointed(
        image, twists=tw, rises=ri, checkpoint_path=ck, chunk=2, device="cpu",
        should_abort=lambda: calls.append(1) or len(calls) > 2, **kw)
    assert partial.effective["aborted"] and partial.effective["chunks_run"] == 2
    assert partial.best_index == -1 and partial.best_volume is None
    done = np.isfinite(partial.scores)
    assert done.sum() == 4 and np.isneginf(partial.scores[~done]).all()
    np.testing.assert_array_equal(np.isnan(np.load(ck)["scores"]), ~done)
    got = reconstruct_grid_checkpointed(image, twists=tw, rises=ri, checkpoint_path=ck,
                                        chunk=2, device="cpu", **kw)
    assert got.effective["chunks_run"] == 2
    np.testing.assert_array_equal(got.scores[done], partial.scores[done])
    again = reconstruct_grid_checkpointed(image, twists=tw, rises=ri, checkpoint_path=ck,
                                          chunk=2, device="cpu", **kw)
    assert again.effective["chunks_run"] == 0
    np.testing.assert_array_equal(again.scores, got.scores)


def test_checkpoint_grid_mismatch_raises(tmp_path):
    image, tw, ri, kw = _tiny()
    ck = str(tmp_path / "m.npz")
    reconstruct_grid_checkpointed(image, twists=tw[:2], rises=ri[:2], checkpoint_path=ck,
                                  chunk=2, device="cpu", **kw)
    with pytest.raises(port_exceptions.HeliconError, match="different candidate grid"):
        reconstruct_grid_checkpointed(image, twists=tw, rises=ri, checkpoint_path=ck, chunk=2,
                                      device="cpu", **kw)
    np.savez(ck, version=2, twists=tw, rises=ri)
    with pytest.raises(port_exceptions.HeliconError, match="unknown version"):
        port_checkpoint._load_state(ck, tw, ri)


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
