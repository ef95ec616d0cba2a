"""Process-sharded candidate grids over ``torch.distributed``.

Counterpart of ``helicon_tpu/parallel/multihost.py``. Per-candidate solves
never communicate, so several processes (one per card, or several on one
card, on one host or many) split the candidate axis:

  1. :func:`initialize` joins the processes into one gloo group, from the
     variables ``torchrun`` sets (RANK, WORLD_SIZE, MASTER_ADDR,
     MASTER_PORT, LOCAL_RANK).
  2. Every process enumerates the full (twist, rise) grid, partitions it
     into the rise buckets a one-process run would use (each bucket's call
     pins the bucket's global rise range with ``geometry_rise_range``, so a
     process's slice never shifts the geometry), takes its contiguous slice
     of each bucket and scores it with the ordinary ``reconstruct_grid`` on
     its own card.
  3. The per-candidate scores (a few KB) cross processes in one
     ``all_reduce`` per exchange (:func:`_psum_exchange`); with refinement
     also the refined pose triples. No operator, image or volume does.

gloo, not NCCL: what crosses is a few KB on the host, and gloo carries it
between any processes, two on one card included, which NCCL refuses.

Top-k refinement keeps the one-process semantics: the fixed-pose pass runs
without refinement, the scores are exchanged, and the global per-bucket
top-k (the same on every process) is refined by its round-robin owner and
exchanged again. refine_mode "all" refines every candidate inside the
sharded pass.
"""

from __future__ import annotations

import logging
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "shutdown",
    "is_distributed",
    "is_writer",
    "process_candidate_slice",
    "multihost_reconstruct_grid",
]


def initialize() -> None:
    """``torch.distributed.init_process_group("gloo")`` from the launcher's
    variables, as ``torchrun`` sets them: WORLD_SIZE, RANK, MASTER_ADDR and
    MASTER_PORT (the ``env://`` rendezvous). Without a launcher (no
    WORLD_SIZE) it does nothing: one process needs no group; nor in a
    process whose group is already initialized."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dist.init_process_group("gloo", init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))


def shutdown() -> None:
    """Leave the process group together: a barrier, then its destruction,
    so that no process exits while gloo's threads still serve a peer (an
    exit with the group alive can abort the interpreter). Nothing without
    a group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_writer() -> bool:
    """Should this process write shared output files? Rank 0 owns them
    (every process holds the same full ranking)."""
    return not is_distributed() or dist.get_rank() == 0


def _world() -> tuple:
    """(number of processes, this process's rank)."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def process_candidate_slice(n: int, num_processes: int | None = None,
                            process_id: int | None = None) -> slice:
    """Contiguous balanced slice of an n-long candidate axis for this
    process (contiguous, so that a slice shares the rise buckets and twist
    groups of the one-process run)."""
    n_proc, pid = _world()
    if num_processes is None:
        num_processes = n_proc
    if process_id is None:
        process_id = pid
    base, rem = divmod(n, num_processes)
    start = process_id * base + min(process_id, rem)
    stop = start + base + (1 if process_id < rem else 0)
    return slice(start, stop)


def _psum_exchange(contrib: np.ndarray, clock: dict | None = None) -> np.ndarray:
    """One exchange of disjoint per-process contributions: every process
    passes a full-shape array that is zero wherever it does not own the
    entry, and one all_reduce(SUM) of it as a CPU float32 tensor rebuilds
    the whole (disjoint ownership: the sum is a scatter, exact). ``clock``
    gains the exchange's seconds and count."""
    t0 = time.perf_counter()
    t = torch.from_numpy(np.array(contrib, np.float32))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    if clock is not None:
        clock["exchange_s"] = clock.get("exchange_s", 0.0) + time.perf_counter() - t0
        clock["exchanges"] = clock.get("exchanges", 0) + 1
    return t.numpy()


def _shard_checkpoint_path(path: str, pid: int) -> str:
    """Per-process checkpoint shard name: ``run.ckpt.npz`` ->
    ``run.ckpt.p0.npz`` (each process persists only its own slice)."""
    if path.endswith(".npz"):
        return f"{path[:-4]}.p{pid}.npz"
    return f"{path}.p{pid}"


def local_device(device):
    """The caller's device, or for "cuda" without an index the card of
    LOCAL_RANK (0 without a launcher; modulo the cards this process sees).
    No card: raises."""
    d = torch.device(device)
    if d.type != "cuda" or d.index is not None:
        return d
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("multihost_reconstruct_grid: no CUDA device (pass device='cpu' "
                           "to run on the CPU)")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % n)


def _device_id(device: torch.device) -> str:
    """The device's identity across processes: a card's UUID, or the host's
    name for the CPU (its memory is the host's)."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_properties(device).uuid}"
    return f"{socket.gethostname()}:{device.type}"


def processes_sharing(ids, pid: int) -> int:
    """How many processes' device ids equal process pid's: the processes
    that size their launches from the same card's free memory."""
    return sum(1 for i in ids if i == ids[pid])


def _card_processes(device: torch.device) -> int:
    """The processes of the group on this process's card, from one
    all_gather of every process's device id: two ranks that torchrun puts
    on one card (LOCAL_RANK modulo the cards) share it, and ranks that
    each see a card of their own (CUDA_VISIBLE_DEVICES per rank) do not."""
    n_proc, pid = _world()
    ids = [None] * n_proc
    dist.all_gather_object(ids, _device_id(device))
    return processes_sharing(ids, pid)


def multihost_reconstruct_grid(
    image, apix, twists, rises,
    checkpoint_path: str | None = None, checkpoint_chunk: int = 1024,
    die_after_chunks: int | None = None, device="cuda",
    **kwargs,
):
    """Process-sharded candidate grid: each process scores its slice of
    every (globally determined) rise bucket on its own device; the scores
    are exchanged with one all_reduce per pass. Without a process group it
    is ``reconstruct_grid`` (``reconstruct_grid_checkpointed`` with a
    checkpoint path).

    ``device``: "cuda" (default) puts each process on the card of its
    LOCAL_RANK; another device is used as given (the tests pass "cpu").
    The processes on one card size their launches from an equal share of
    its free memory (``card_processes`` of ``reconstruct_grid``).
    checkpoint_path: each process saves its own coarse-pass slice to
    ``<path>.p<rank>.npz`` after every ``checkpoint_chunk`` candidates (the
    checkpointed search's format); a rerun of the same command recomputes
    only each shard's missing candidates, then the exchanges and merge
    stages run. die_after_chunks is a test hook: the process exits (code
    17) after that many chunks, before any collective.

    The result equals a one-process ``reconstruct_grid`` on the full grid:
    the same rise buckets and bucket geometry, the global per-bucket top-k
    for refinement, the same cross-bucket re-scoring pass. progress_callback
    and should_abort are not forwarded (partial -inf fills cannot ride a
    sum), and densify_padding is dropped with a warning. Every process gets
    the full score vector (and refined poses); best_volume only the process
    that re-solves the winner. ``effective`` gains n_processes,
    card_processes, n_buckets, scored (the candidates this process scored
    in the passes), exchange_s and exchanges (and checkpointed /
    chunks_run)."""
    from ..denovo3d import grid
    from ..denovo3d.grid import GridResult, crossbucket_selection, global_rise_buckets

    twists = np.asarray(twists, np.float32)
    rises = np.asarray(rises, np.float32)
    n = len(twists)
    if not is_distributed():
        if checkpoint_path is not None:
            from ..denovo3d import reconstruct_grid_checkpointed

            return reconstruct_grid_checkpointed(
                image, apix, twists, rises, checkpoint_path=checkpoint_path,
                chunk=checkpoint_chunk, device=device, **kwargs)
        return grid.reconstruct_grid(image, apix, twists, rises, device=device, **kwargs)

    n_proc, pid = _world()
    device = local_device(device)
    card_processes = _card_processes(device)
    ratio = float(kwargs.get("rise_bucket_ratio", 1.6))
    refine_range = kwargs.get("refine_tilt_psi_dy_range")
    refine_mode = kwargs.get("refine_mode", "topk")
    return_best_volume = kwargs.get("return_best_volume", True)
    clock: dict = {}

    # the global bucket partition: every process computes the one a
    # one-process run would use
    buckets = global_rise_buckets(rises, ratio)

    defer_refine = refine_range is not None and refine_mode != "all"
    local_kw = dict(kwargs)
    for k in ("return_best_volume", "progress_callback", "should_abort", "devices"):
        local_kw.pop(k, None)
    local_kw["return_best_volume"] = False
    local_kw["card_processes"] = card_processes
    if local_kw.pop("densify_padding", False):
        # each process would densify its own slice's padding, and nothing
        # exchanges extras: dropping the flag beats rank-local extras
        logging.getLogger("helicon").warning(
            "denovo3d: densify_padding is not supported under multi-process "
            "execution — ignored (no extras will be produced)")
    if defer_refine:
        local_kw["refine_tilt_psi_dy_range"] = None

    def run(cand_idx, rise_range, **overrides):
        return grid.reconstruct_grid(image, apix, twists[cand_idx], rises[cand_idx],
                                     geometry_rise_range=rise_range, device=device,
                                     **dict(local_kw, **overrides))

    def bucket_range(idx):
        return float(np.min(rises[idx])), float(np.max(rises[idx]))

    # pass 1: fixed-pose scoring, sharded within each bucket; with a
    # checkpoint, this process's scored entries come from its shard (NaN:
    # not its own or not scored yet) and only the missing ones are scored,
    # a chunk at a time with a save after each
    contrib = np.zeros(n, np.float32)
    pose_c = np.zeros((n, 3), np.float32)
    pose_m = np.zeros(n, np.float32)
    local_sub = None
    cost = None  # this process's first sub-call's, as the reference's
    chunks_run = 0
    scored = 0  # candidates this process scored, in every pass
    shard = None
    if checkpoint_path is not None:
        from ..denovo3d.checkpoint import _atomic_save, _load_state

        shard = _shard_checkpoint_path(checkpoint_path, pid)
        # (the trailing densify extras are unused: densify_padding is dropped)
        ck_scores, ck_pose, ck_mask, _ = _load_state(shard, twists, rises)

    for idx in buckets:
        rr = bucket_range(idx)
        mine = idx[process_candidate_slice(len(idx), n_proc, pid)]
        if not len(mine):
            continue
        if shard is None:
            parts = [mine]
        else:
            done = mine[~np.isnan(ck_scores[mine])]
            contrib[done] = ck_scores[done]
            pose_c[done] = ck_pose[done]
            pose_m[done] = ck_mask[done].astype(np.float32)
            todo = mine[np.isnan(ck_scores[mine])]
            step = max(1, int(checkpoint_chunk))
            parts = [todo[s : s + step] for s in range(0, len(todo), step)]
        for part in parts:
            if not len(part):
                continue
            sub = run(part, rr)
            scored += len(part)
            contrib[part] = np.asarray(sub.scores, np.float32)
            if sub.refined_params:  # refine_mode "all": every candidate
                for k, v in sub.refined_params.items():
                    pose_c[part[k]] = np.asarray(v, np.float32)
                    pose_m[part[k]] = 1.0
            local_sub = sub
            if cost is None:
                cost = sub.cost
            chunks_run += 1
            if shard is not None:
                ck_scores[part] = contrib[part]
                ck_pose[part] = pose_c[part]
                ck_mask[part] = pose_m[part] > 0
                _atomic_save(shard, version=1, twists=twists, rises=rises, scores=ck_scores,
                             pose=ck_pose, pose_mask=ck_mask)
                if die_after_chunks is not None and chunks_run >= die_after_chunks:
                    # test hook: a mid-grid kill before any collective, so
                    # that no peer waits in the exchange
                    os._exit(17)
    scores = _psum_exchange(contrib, clock)

    refined: dict = {}
    if refine_mode == "all" and refine_range is not None:
        pose_all = _psum_exchange(pose_c, clock)
        mask_all = _psum_exchange(pose_m, clock) > 0
        refined = {int(i): tuple(map(float, pose_all[i])) for i in np.where(mask_all)[0]}

    # deferred top-k refinement: the global per-bucket top-k, each
    # candidate refined by its round-robin owner at its bucket's geometry
    if defer_refine:
        top_k = max(1, int(kwargs.get("refine_top_k", 1)))
        tasks = []  # (bucket index, candidate index)
        for b, idx in enumerate(buckets):
            top = idx[np.argsort(-scores[idx])[: min(top_k, len(idx))]]
            tasks.extend((b, int(c)) for c in top)
        r_s = np.zeros(n, np.float32)
        r_m = np.zeros(n, np.float32)
        r_p = np.zeros((n, 3), np.float32)
        for j, (b, c) in enumerate(tasks):
            if j % n_proc != pid:
                continue
            sub = run(np.asarray([c]), bucket_range(buckets[b]),
                      refine_tilt_psi_dy_range=refine_range, refine_top_k=1, batch_size=None)
            scored += 1
            r_s[c] = float(sub.scores[0])
            r_m[c] = 1.0
            if sub.refined_params:
                r_p[c] = np.asarray(sub.refined_params[0], np.float32)
        got_s = _psum_exchange(r_s, clock)
        got_m = _psum_exchange(r_m, clock) > 0
        got_p = _psum_exchange(r_p, clock)
        scores[got_m] = got_s[got_m]
        refined = {int(i): tuple(map(float, got_p[i])) for i in np.where(got_m)[0]}

    # the cross-bucket pass: bucket scores compare only within a bucket, so
    # each bucket's top 10 % is re-scored at per-candidate geometry, as the
    # one-process bucketed search does, sharded over the distinct rises,
    # without refinement (it ran in the buckets)
    sel = None
    if len(buckets) > 1:
        sel = crossbucket_selection(buckets, scores)
        r_s = np.zeros(n, np.float32)
        r_m = np.zeros(n, np.float32)
        for j, r in enumerate(np.unique(rises[sel])):
            if j % n_proc != pid:
                continue
            m = sel[rises[sel] == r]
            r_s[m] = np.asarray(run(m, None, refine_tilt_psi_dy_range=None).scores, np.float32)
            scored += len(m)
            r_m[m] = 1.0
        got_s = _psum_exchange(r_s, clock)
        got_m = _psum_exchange(r_m, clock) > 0
        scores[got_m] = got_s[got_m]

    # the winner as the bucketed search picks it: with several buckets,
    # only among the re-scored candidates
    if not n:
        best = -1
    elif sel is not None and len(sel):
        best = int(sel[int(np.argmax(scores[sel]))])
    else:
        best = int(np.argmax(scores))
    owner = best % n_proc if best >= 0 else -1
    best_volume = None
    win = None
    if return_best_volume and best >= 0 and pid == owner:
        # one bucket: the grid's global geometry (the one-shot call's);
        # several: the winner's own geometry (the bucketed winner call);
        # refinement, if asked, runs again on this one candidate
        win_rr = bucket_range(np.arange(n)) if len(buckets) == 1 else None
        win = run(np.asarray([best]), win_rr, return_best_volume=True, batch_size=None,
                  refine_tilt_psi_dy_range=refine_range)
        best_volume = win.best_volume

    ref_sub = win if win is not None else local_sub
    if ref_sub is None and n:
        # this rank scored nothing (an empty slice, or a fully resumed
        # shard) and did not re-solve the winner: one single-candidate
        # solve supplies the geometry metadata (scores untouched)
        local_sub = ref_sub = run(buckets[0][:1], bucket_range(buckets[0]), batch_size=None,
                                  refine_tilt_psi_dy_range=None)
    return GridResult(
        twists=twists,
        rises=rises,
        scores=scores,
        geom=ref_sub.geom if ref_sub is not None else None,
        target_apix2d=ref_sub.target_apix2d if ref_sub is not None else -1.0,
        target_apix3d=ref_sub.target_apix3d if ref_sub is not None else -1.0,
        best_index=best,
        best_volume=best_volume,
        refined_params=refined or None,
        cost=cost,
        effective=dict(
            (local_sub.effective or {}) if local_sub is not None else {},
            n_processes=n_proc, card_processes=card_processes, n_buckets=len(buckets),
            scored=scored, **clock,
            **(dict(checkpointed=True, chunks_run=chunks_run) if shard is not None else {}),
        ),
    )
