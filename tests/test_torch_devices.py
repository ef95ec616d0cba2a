"""Several devices in one process (helicon_tpu_torch/parallel/__init__.py and
reconstruct_grid(devices=[...])) on the CPU, where an entry repeated is
that many shards on one device.

The grids are the JAX package's own multi-device ones
(tests/test_parallel.py: a simulated 48 x 96 image, 8 twists x 2 rises on
the grouped path, 8 x 1 per candidate). Sharded over two and eight CPU
shards the port's scores equal its one-device run bit for bit; they agree
with the JAX package's run on its eight virtual CPU devices
(tests/conftest.py) within that test's 2e-5, with the same winner. The JAX
side runs jitted there (shard_map), so both sides use linear
interpolation: jitted, XLA moves the nearest-neighbour samples that sit
half-way between two z planes (ROADMAP C6), while linear interpolation
agrees to float32 rounding.

The launch guard (every C entry called with its tensors' card current,
under the counts' lock) is checked with a stand-in library, as the CPU has
no card.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from helicon_tpu import parallel as ref_parallel
from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu.helix.simulate import simulate_helical_projection
from helicon_tpu_torch import parallel
from helicon_tpu_torch.denovo3d import reconstruct_grid

KW = dict(apix=2.0, cg_iters=8, fista_iters=6, return_best_volume=False,
          compute_dtype="float32")
# tests/test_parallel.py's grids: (twists, rises, batch_size)
GRIDS = dict(
    grouped=(np.repeat(np.linspace(20.0, 55.0, 8).astype(np.float32), 2),
             np.tile(np.asarray([5.6, 6.0], np.float32), 8), 16),
    percand=(np.linspace(20.0, 55.0, 8).astype(np.float32), np.full(8, 6.0, np.float32), 8),
)


@pytest.fixture(scope="module")
def image():
    return np.squeeze(np.asarray(simulate_helical_projection(
        n=1, twist=30.0, rise=6.0, csym=1, helical_diameter=40.0, ball_radius=5.0,
        polymer=0, planarity=1.0, ny=48, nx=96, apix=2.0, rng=0)))


def _grid(name, **kw):
    tw, ri, batch = GRIDS[name]
    return dict(KW, twists=tw, rises=ri, batch_size=batch, **kw)


@pytest.fixture(scope="module")
def one_device(image):
    """The port's one-device run of each grid, nn and linear."""
    return {(name, interp): reconstruct_grid(image, device="cpu",
                                             **_grid(name, interpolation=interp))
            for name in GRIDS for interp in ("nn", "linear")}


@pytest.mark.parametrize("interp", ["nn", "linear"])
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shards_equal_one_device(image, one_device, name, n, interp):
    """n CPU shards: the scores of the one-device run bit for bit, each
    shard a contiguous slice of the twist groups (of the candidates)."""
    one = one_device[(name, interp)]
    res = reconstruct_grid(image, devices=["cpu"] * n, **_grid(name, interpolation=interp))
    assert res.effective["path"] == one.effective["path"] == name
    assert res.effective["n_devices"] == n
    np.testing.assert_array_equal(res.scores, one.scores)
    assert res.best_index == one.best_index
    shards = res.effective["shards"]
    key = "groups" if name == "grouped" else "candidates"
    total = one.effective["n_groups"] if name == "grouped" else len(one.scores)
    assert [s[key] for s in shards] == [len(a) for a in np.array_split(np.arange(total), n)]


@pytest.fixture(scope="module")
def reference_runs(image):
    """The JAX package's runs on its eight virtual CPU devices, as
    tests/test_parallel.py makes them (the grouped path forced, the
    per-candidate path chunked), in linear interpolation."""
    import os

    out = {}
    for name, env in (("grouped", ("HELICON_GRID_GROUPED", "1")),
                      ("percand", ("HELICON_GRID_INNER", "2"))):
        old = os.environ.get(env[0])
        os.environ[env[0]] = env[1]
        try:
            out[name] = ref_reconstruct_grid(image, devices=jax.devices(),
                                             **_grid(name, interpolation="linear"))
        finally:
            if old is None:
                os.environ.pop(env[0], None)
            else:
                os.environ[env[0]] = old
    return out


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_eight_shards_match_reference_devices(image, reference_runs, name):
    """Eight CPU shards against the JAX package on eight devices: scores
    within 2e-5, the same winner."""
    ref = reference_runs[name]
    assert len(jax.devices()) == 8 and ref.effective["path"] == name
    res = reconstruct_grid(image, devices=["cpu"] * 8, **_grid(name, interpolation="linear"))
    np.testing.assert_allclose(res.scores, np.asarray(ref.scores), rtol=0, atol=2e-5)
    assert res.best_index == int(np.argmax(ref.scores))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_incremental_over_two_shards(image, one_device, name):
    """Incremental mode on two shards: the one-device scores, progress
    rising to n_cand with every shard's scores so far (nothing scored
    holds -inf), should_abort polled before every launch of both shards."""
    one = one_device[(name, "nn")]
    seen, polls = [], []

    def progress(done, n, scores):
        seen.append((done, n, int(np.isfinite(scores).sum())))

    def should_abort():
        polls.append(threading.get_ident())
        return False

    kw = _grid(name, interpolation="nn")
    kw["batch_size"] = 2  # several launches a shard
    res = reconstruct_grid(image, devices=["cpu", "cpu"], progress_callback=progress,
                           should_abort=should_abort, **kw)
    n = len(one.scores)
    np.testing.assert_array_equal(res.scores, one.scores)
    assert [d for d, _, _ in seen] == sorted(d for d, _, _ in seen)
    assert seen[-1][0] == n and all(m == n for _, m, _ in seen)
    assert all(done == finite for done, _, finite in seen)
    launches = (res.effective["n_groups"] if name == "grouped"
                else res.effective["n_launches"])
    assert len(polls) == launches == len(seen) and len(set(polls)) == 2


def test_abort_stops_every_shard(image):
    """should_abort true from its third poll: both shards stop, the result
    is marked aborted and what was not scored holds -inf."""
    polls = []

    def should_abort():
        polls.append(1)
        return len(polls) > 2

    kw = _grid("grouped", interpolation="nn")
    kw["batch_size"] = 2
    res = reconstruct_grid(image, devices=["cpu", "cpu"], should_abort=should_abort, **kw)
    assert res.effective["aborted"]
    assert 0 < int(np.isfinite(res.scores).sum()) < len(res.scores)


def test_distributed_reconstruct_grid(image, one_device):
    """The entry point on the given devices equals reconstruct_grid; with
    none it takes every visible card, and raises here, without one."""
    res = parallel.distributed_reconstruct_grid(image, twists=GRIDS["grouped"][0],
                                                rises=GRIDS["grouped"][1],
                                                devices=["cpu", "cpu", "cpu"],
                                                **{k: v for k, v in _grid("grouped").items()
                                                   if k not in ("twists", "rises")},
                                                interpolation="nn")
    np.testing.assert_array_equal(res.scores, one_device[("grouped", "nn")].scores)
    assert res.effective["n_devices"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.distributed_reconstruct_grid(image, twists=GRIDS["grouped"][0],
                                                  rises=GRIDS["grouped"][1], **KW)


@pytest.mark.parametrize("entry", ["cuda:7", 7, torch.device("cuda", 7)])
def test_a_missing_card_raises(image, entry):
    """A card the machine lacks raises before any work; nothing falls back
    to the CPU."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 7:
        pytest.skip("this machine has eight cards")
    with pytest.raises(ValueError, match="CUDA device"):
        reconstruct_grid(image, devices=["cpu", entry], **_grid("grouped"))


def test_pad_to_multiple_matches_reference():
    x = np.arange(30).reshape(10, 3)
    for m in range(1, 17):
        for axis in (0, 1):
            np.testing.assert_array_equal(parallel.pad_to_multiple(x, m, axis),
                                          ref_parallel.pad_to_multiple(x, m, axis))


@pytest.mark.parametrize("n", range(1, 17))
def test_image_candidate_mesh_matches_reference(n):
    """The (images, candidates) factorisation of n devices is the
    reference's (its mesh is built on as many of the eight virtual devices
    as it has, and on its rule past eight)."""
    mesh = parallel.image_candidate_mesh(["cpu"] * n)
    shape = (len(mesh), len(mesh[0]))
    if n <= len(jax.devices()):
        want = ref_parallel.image_candidate_mesh(jax.devices()[:n]).devices.shape
    else:
        ni = 1
        while ni * 2 <= int(np.sqrt(n)) and n % (ni * 2) == 0:
            ni *= 2
        want = (ni, n // ni)
    assert shape == want
    assert sum(len(row) for row in mesh) == n
    explicit = parallel.image_candidate_mesh(["cpu"] * n, n_image_shards=n)
    assert (len(explicit), len(explicit[0])) == (n, 1)


def test_shard_batch_and_candidate_sharding():
    """Leading axes split into contiguous shards in order, one per device,
    a tuple, a dict and one array alike."""
    a, b = np.arange(10), np.arange(20).reshape(10, 2)
    parts = parallel.shard_batch((a, b), ["cpu"] * 3)
    assert [len(p[0]) for p in parts] == [4, 3, 3]
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts]).numpy(), b)
    parts = parallel.shard_batch(dict(a=a), ["cpu"] * 4)
    np.testing.assert_array_equal(torch.cat([p["a"] for p in parts]).numpy(), a)
    assert len(parallel.shard_batch(torch.arange(5), ["cpu"] * 2)[1]) == 2
    assert [(s.start, s.stop) for s, _ in parallel.candidate_sharding(5, ["cpu"] * 3)] == [
        (0, 2), (2, 4), (4, 5)]
    with pytest.raises(ValueError):
        parallel.shard_batch((a, b[:3]), ["cpu"])


class _FakeLib:
    """A stand-in kernel library: each entry records the current card."""

    def __init__(self, current):
        self.current, self.calls = current, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, self.current[0]))
            return 0
        return entry


@pytest.fixture
def fake_cards(monkeypatch):
    """torch.cuda.device, the current-card query and the stream queries
    replaced: a context that makes its card current, so that a C call can
    report the card it ran under on the CPU."""
    import contextlib

    current = [0]

    @contextlib.contextmanager
    def device(d):
        saved = current[0]
        current[0] = torch.device(d).index
        try:
            yield
        finally:
            current[0] = saved

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current[0], raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0, raising=False)
    return current


def test_launches_run_on_their_tensors_card(monkeypatch, fake_cards):
    """_build.Launcher and gather_kernels._run call the C entry with the
    tensors' card current, whatever card the caller has current, and the
    counts stay exact with threads launching at once."""
    from helicon_tpu_torch import _build
    from helicon_tpu_torch.denovo3d import gather_kernels

    lib = _FakeLib(fake_cards)
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    counts = dict(n=0)

    def count(k):
        # a read, a switch point, a write: unlocked, threads lose updates
        n = counts["n"]
        time.sleep(0)
        counts["n"] = n + k

    fake_cards[0] = 0
    _build.Launcher(torch.device("cuda", 3), count)("hts_cg_step", None, 1, kernels=2)
    gather_kernels._run(torch.device("cuda", 5), lib.hgp_empty)
    _build.Launcher(torch.device("cuda", 0), count)("hts_cg_step", None, 1)
    gather_kernels._run(torch.device("cuda", 0), lib.hgp_empty)
    assert lib.calls == [("hts_cg_step", 3), ("hgp_empty", 5), ("hts_cg_step", 0),
                         ("hgp_empty", 0)]
    assert fake_cards[0] == 0 and counts["n"] == 3

    def hammer(card):
        run = _build.Launcher(torch.device("cuda", card), count)
        for _ in range(300):
            run("hts_normalize", None, None, 1, 1)

    # more threads than cores, switching often: a lost update would show
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(c % 4,)) for c in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert counts["n"] == 3 + 32 * 300
