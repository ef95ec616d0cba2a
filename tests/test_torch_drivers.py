"""The PyTorch port's search drivers against the JAX package: the rise
bucketing's re-scoring pass (also with pose refinement), densify_padding,
the checkpointed search's resume and checks, the bucket helpers, the copy
of the exceptions module and the numpy copy of JAX's permutation. The
bucketed tiny workload's tests are in tests/test_torch_drivers_bucketed.py
and incremental progress, abort and the shards in
tests/test_torch_drivers_reference.py; both import this file's helpers.

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


class _Stop(Exception):
    pass


def _first_groups(module, n_groups):
    """A stand-in for module._group_tables that records the first n_groups
    calls' (rises with the densify extras, R) and then stops the search."""
    calls = []
    real = module._group_tables

    def spy(geom, twist, rises_pixel, n_copies, n_pairs, n_ops, C_u, R_pad, copy_cache):
        calls.append((float(twist), np.asarray(rises_pixel, np.float32).copy(), int(R_pad)))
        if len(calls) == n_groups:
            raise _Stop
        return real(geom, twist, rises_pixel, n_copies, n_pairs, n_ops, C_u, R_pad, copy_cache)

    return calls, spy


def test_group_size_capped_by_automatic_batch(monkeypatch):
    """With batch_size=None the reference caps the twist-group size R by its
    automatic batch (its grid.py:753 and :1256-1268); at the production
    geometry of bench.py's large workload (d3 = 64, l3 = 18, 1.75 A/px) that
    batch binds, and the port's R, groups and densify extras equal the
    reference's. Twists of 32 and 27 rises: both packages stop the search at
    its third group, before any solve (bf16 operators, as the bench's: in
    float32 one group's operators exceed the grouped path's budget)."""
    from helicon_tpu_torch.helix import simulate_helical_projection

    image = simulate_helical_projection(n=1, twist=29.4, rise=4.75, csym=1,
                                        helical_diameter=100.0, ball_radius=4.0, polymer=0,
                                        planarity=1.0, ny=256, nx=512, apix=1.0, rng=0,
                                        device="cpu")
    image = np.asarray(image, np.float32)
    rises = np.float32(4.0 + 0.0323 * np.arange(32))
    tw = np.float32([0.5] * 27 + [0.55] * 32)
    ri = np.concatenate([rises[:27], rises])
    kw = dict(apix=1.0, target_apix2d=1.75, target_apix3d=1.75, tube_diameter=110.0,
              reconstruct_length_rise=6.0, interpolation="linear", cg_iters=2, fista_iters=2,
              power_iters=1, compute_dtype="bfloat16", return_best_volume=False,
              densify_padding=True, batch_size=None)
    got, spy = _first_groups(port_grid, 3)
    monkeypatch.setattr(port_grid, "_group_tables", spy)
    with pytest.raises(_Stop):
        reconstruct_grid(image, twists=tw, rises=ri, device="cpu", **kw)
    want, spy = _first_groups(ref_grid, 3)
    monkeypatch.setattr(ref_grid, "_group_tables", spy)
    with pytest.raises(_Stop):
        ref_reconstruct_grid(image, twists=tw, rises=ri, devices=jax.devices()[:1], **kw)
    R = want[0][2]
    assert R < 27  # the automatic batch binds: uncapped, R would be 32
    assert {c[2] for c in got} == {c[2] for c in want} == {R}
    # the reference builds its group tables on a producer thread, which may
    # get ahead of the stop: match the groups by twist and first rise
    want = {(c[0], float(c[1][0])): c[1] for c in want}
    assert len(got) == 3
    for t, rises_g, _ in got:
        np.testing.assert_array_equal(rises_g, want[(t, float(rises_g[0]))])
    # the twist of 27 rises ends in a short group, densified in both
    assert any(len(r) > len(set(r.tolist()) & set(ri.tolist())) for _, r, _ in got)


# ---------------------------------------------------------------------------
# rise bucketing
# ---------------------------------------------------------------------------

def test_bucketed_search_merges_refined_poses(monkeypatch, tmp_path_factory):
    """Pose refinement on the bucketed search: two rise buckets, each
    refining its top candidate; the second pass runs without refinement;
    the winner is refined again alone, its pose merged. The second pass's
    calls of one candidate per twist take the grouped route in both
    packages (HELICON_GRID_GROUPED=1; the eager per-candidate path of the
    reference costs seven times as much, with the same scores:
    tests/test_torch_grid.py). The bounds of tests/test_torch_refine_grid.py.
    The reference runs jitted here: eager, its refinement's gather solves
    dispatch ~740,000 primitives one at a time (~14 min); jitted it
    agrees within these bounds (scores 1.4e-4 apart, the poses equal)."""
    from test_torch_refine_grid import RANGE, _same_refined

    monkeypatch.setenv("HELICON_GRID_GROUPED", "1")
    monkeypatch.setenv("HELICON_NATIVE_CACHE", str(tmp_path_factory.getbasetemp() / "native"))
    image, tw, ri, kw = _tiny(bucketed=True)
    kw = dict(kw, refine_tilt_psi_dy_range=dict(RANGE, max_iter=1), return_best_volume=True)
    # three candidates, rises 3.0, 3.2 and 5.6 A: two buckets
    tw, ri = tw[[0, 2, 4]], ri[[0, 2, 4]]
    port = _port(image, tw, ri, **kw)
    ref = ref_reconstruct_grid(image, twists=tw, rises=ri, devices=jax.devices()[:1], **kw)
    assert port.effective["n_buckets"] == 2
    _same_refined(port, ref)
    np.testing.assert_allclose(port.scores, ref.scores, rtol=0, atol=5e-4)
    assert port.best_index == ref.best_index
    assert port.best_index in port.refined_params
    rel = np.abs(port.best_volume - ref.best_volume).max() / np.abs(ref.best_volume).max()
    assert rel < 1e-4, rel


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
# the checkpointed search
# ---------------------------------------------------------------------------

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


