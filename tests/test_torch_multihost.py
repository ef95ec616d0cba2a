"""The port's process-sharded grid (helicon_tpu_torch/parallel/multihost.py)
on the CPU: process_candidate_slice against the JAX package's, and two and
three gloo processes (tests/_torch_mh_worker.py, spawned as
tests/test_parallel.py spawns its workers) against the one-process port run
on the same grid: the gathered scores within 1e-5, the same best index, the
refined poses within 5e-3.

refine_mode "all" is held against the JAX package's reconstruct_grid too,
eager on one device as in tests/test_torch_refine_grid.py (its bounds:
refined scores 5e-4, poses 5e-3). The bucketed workload's one-process port
run is held against the JAX package's in tests/test_torch_drivers.py
(test_bucketed_tiny_workload_matches_reference); an eager JAX run of it
here would take 77 s, of its top-k refinement 325 s (this sandbox's CPU),
and jitted, nn and linear, the JAX package moves its scores by 1.4e-4 to
4.2e-4 (ROADMAP C6).

The two-process cases share one spawn: the worker runs them one after the
other in one process group, while the test process makes each case's
one-process run (and the JAX run of "all") once per module.
"""

import functools
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from _torch_mh_worker import CASES, case_workload, tiny_workload
from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu.parallel import multihost as ref_multihost
from helicon_tpu_torch.denovo3d import reconstruct_grid
from helicon_tpu_torch.parallel import multihost

WORKER = pathlib.Path(__file__).parent / "_torch_mh_worker.py"


@pytest.mark.parametrize("n", [0, 1, 5, 6, 7, 100])
@pytest.mark.parametrize("n_proc", [1, 2, 3, 4])
def test_process_candidate_slice_matches_reference(n, n_proc):
    for pid in range(n_proc):
        assert (multihost.process_candidate_slice(n, n_proc, pid)
                == ref_multihost.process_candidate_slice(n, n_proc, pid))


def test_shard_names_match_reference():
    for path in ("run.ckpt.npz", "run.ckpt"):
        assert (multihost._shard_checkpoint_path(path, 3)
                == ref_multihost._shard_checkpoint_path(path, 3))


def test_one_process_is_the_plain_search():
    """Without a process group: nothing to join, rank 0 writes, and the
    search is reconstruct_grid itself."""
    multihost.initialize()
    assert not multihost.is_distributed() and multihost.is_writer()
    image, tw, ri, kw = tiny_workload()
    got = multihost.multihost_reconstruct_grid(image, twists=tw[:2], rises=ri[:2], **kw)
    want = reconstruct_grid(image, twists=tw[:2], rises=ri[:2], **kw)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_processes_share_a_card():
    """A process sizes its launches from its share of its card's free
    memory: the processes whose device ids (a card's UUID) equal its own.
    Two ranks torchrun puts on one card share it; ranks that each see a card
    of their own (CUDA_VISIBLE_DEVICES per rank, so every LOCAL_RANK maps
    to cuda:0) do not; and the CPU's id is its host's."""
    own = [f"cuda:GPU-{r}" for r in range(8)]
    assert [multihost.processes_sharing(own, r) for r in range(8)] == [1] * 8
    two = ["cuda:GPU-0", "cuda:GPU-0", "cuda:GPU-1"]
    assert [multihost.processes_sharing(two, r) for r in range(3)] == [2, 2, 1]
    host = multihost._device_id(torch.device("cpu"))
    assert host == f"{socket.gethostname()}:cpu"


def _spawn(n_proc, cases, extra=(), expect_rc=0, meanwhile=lambda: None):
    """Run the worker's cases in n_proc processes joined over gloo on
    localhost, calling meanwhile() while they run; returns the results of
    those that wrote one, and meanwhile's."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(n_proc), LOCAL_WORLD_SIZE=str(n_proc), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as td:
        outs = [os.path.join(td, f"r{i}.json") for i in range(n_proc)]
        procs = [subprocess.Popen([sys.executable, str(WORKER), outs[i], ",".join(cases), *extra],
                                  env=dict(base, RANK=str(i), LOCAL_RANK=str(i)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for i in range(n_proc)]
        other = meanwhile()
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == expect_rc, (p.returncode, log[-3000:])
        return [json.load(open(o)) for o in outs if os.path.exists(o)], other


@functools.lru_cache(maxsize=None)
def _one_process(case):
    """The one-process port run of a case, once per module."""
    image, tw, ri, kw = case_workload(case)
    return reconstruct_grid(image, twists=tw, rises=ri, **kw)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The JAX package's run of a case, eager on one device, once per
    module."""
    image, tw, ri, kw = case_workload(case)
    kw = {k: v for k, v in kw.items() if k != "device"}
    with jax.disable_jit():
        return ref_reconstruct_grid(image, twists=tw, rises=ri, devices=jax.devices()[:1], **kw)


@pytest.fixture(scope="module", autouse=True)
def _native_cache(tmp_path_factory):
    """The JAX package's refinement engine builds into the test's tree."""
    old = os.environ.get("HELICON_NATIVE_CACHE")
    os.environ["HELICON_NATIVE_CACHE"] = str(tmp_path_factory.getbasetemp() / "native")
    yield
    if old is None:
        del os.environ["HELICON_NATIVE_CACHE"]
    else:
        os.environ["HELICON_NATIVE_CACHE"] = old


# the cases held against the JAX package here
ANCHORED = ("all",)


def _both(cases):
    """Every case's one-process port run, and JAX run where anchored."""
    for c in cases:
        _one_process(c)
        if c in ANCHORED:
            _reference(c)


def _same_as_one_process(res, case, n_proc):
    want = _one_process(case)
    assert len(res) == n_proc
    for r in res:
        r = r[case]
        np.testing.assert_allclose(r["scores"], want.scores, rtol=0, atol=1e-5)
        assert r["best_index"] == want.best_index
        assert r["effective"]["n_processes"] == n_proc
        # the CPU processes share their host's memory
        assert r["effective"]["card_processes"] == n_proc
        refined = {int(k): v for k, v in r["refined"].items()}
        assert sorted(refined) == sorted(want.refined_params or {})
        for k, v in refined.items():
            np.testing.assert_allclose(v, want.refined_params[k], rtol=0, atol=5e-3)
        if case in ANCHORED:
            _same_as_reference(r, _reference(case))


def _same_as_reference(r, ref):
    """A process's gathered result against the JAX package's run: the same
    best index and refined candidates, poses within 5e-3, refined scores
    within 5e-4 and the others within 1e-4."""
    assert r["best_index"] == ref.best_index
    refined = {int(k): v for k, v in r["refined"].items()}
    assert sorted(refined) == sorted(ref.refined_params or {})
    for k, v in refined.items():
        np.testing.assert_allclose(v, ref.refined_params[k], rtol=0, atol=5e-3)
    tol = np.where(np.isin(np.arange(len(ref.scores)), list(refined)), 5e-4, 1e-4)
    assert np.all(np.abs(np.asarray(r["scores"]) - np.asarray(ref.scores)) <= tol)


@pytest.fixture(scope="module")
def two_processes():
    """One spawn of two processes for every case, the one-process and JAX
    runs made meanwhile."""
    return _spawn(2, sorted(CASES), meanwhile=lambda: _both(sorted(CASES)))[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_processes_match_one(name, two_processes):
    """Two rise buckets (the global partition, the exchange, the
    cross-bucket pass), the deferred per-bucket top-k refinement, and
    refine_mode "all" inside the sharded pass (in linear interpolation)."""
    _same_as_one_process(two_processes, name, 2)
    assert two_processes[0][name]["effective"]["n_buckets"] == (2 if CASES[name][0] else 1)


def test_three_processes_match_one():
    """An odd count: unbalanced slices, and rank 2 owns fewer re-scoring
    and refinement tasks."""
    res, _ = _spawn(3, ["topk"], meanwhile=lambda: _both(["topk"]))
    _same_as_one_process(res, "topk", 3)


def test_checkpointed_run_stopped_and_resumed(tmp_path):
    """Each rank stops after its first chunk (before any exchange), its
    shard holds that chunk; the same command resumes, recomputing only the
    missing chunks, and gives the one-process result."""
    base = str(tmp_path / "run.ckpt.npz")
    args = (f"ckpt={base}", "chunk=1")
    assert _spawn(2, ["bucketed"], (*args, "die=1"), expect_rc=17)[0] == []
    done = [int(np.sum(~np.isnan(np.load(tmp_path / f"run.ckpt.p{r}.npz")["scores"])))
            for r in (0, 1)]
    assert done == [1, 1]
    res, _ = _spawn(2, ["bucketed"], args, meanwhile=lambda: _both(["bucketed"]))
    _same_as_one_process(res, "bucketed", 2)
    # the bucket slices hold 4 + 2 candidates in chunks of one: six in all,
    # two of them saved before the stop
    assert sum(r["bucketed"]["effective"]["chunks_run"] for r in res) == 6 - sum(done)
    assert all(r["bucketed"]["effective"]["checkpointed"] for r in res)
