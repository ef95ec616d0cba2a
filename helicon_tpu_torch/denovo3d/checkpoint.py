"""Checkpoint and resume for long grid searches.

Counterpart of ``helicon_tpu/denovo3d/checkpoint.py``:
:func:`reconstruct_grid_checkpointed` scores the grid in chunks, saves the
coarse score vector after every chunk (an atomic write-then-rename .npz),
and on a re-run recomputes only the missing candidates. The shard format
is the reference's (version 1, with the optional densify ``extra_*``
keys), so a shard written by either package resumes in the other.

Chunked scoring reproduces the one-shot run because every chunk is scored
against the global rise-bucket partition (``grid.global_rise_buckets``)
with ``geometry_rise_range`` pinned to its bucket's range: a chunk's own
rise extremes never shift the geometry. After the coarse pass, the merge
stages run as in the one-shot bucketed search: the deferred top-k pose
refinement at bucket geometry (refine_mode "topk"), the cross-bucket
re-scoring pass at per-candidate geometry, then the winner's re-solve.
They are a small share of the work, so only the coarse pass is
checkpointed; refine_mode "all" refines inside every chunk, and the
refined poses go into the shard beside the scores, as the reference
writes them.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

__all__ = ["reconstruct_grid_checkpointed"]

_STATE_VERSION = 1


def _atomic_save(path: str, **arrays) -> None:
    """np.savez to a temporary file in the same directory, then rename: a
    crash mid-write never corrupts the previous checkpoint."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_state(path, twists, rises):
    """(scores with NaN for unscored, pose, pose_mask, (extra twists,
    rises, scores)) from an existing checkpoint, or fresh arrays. A
    checkpoint of another version or written for another grid raises
    HeliconError instead of mixing scores."""
    from ..utils.exceptions import HeliconError

    n = len(twists)
    empty = np.zeros(0, np.float32)
    if not os.path.exists(path):
        return (np.full(n, np.nan, np.float32), np.zeros((n, 3), np.float32),
                np.zeros(n, bool), (empty, empty, empty))
    z = np.load(path)
    if int(z.get("version", -1)) != _STATE_VERSION:
        raise HeliconError(f"checkpoint {path}: unknown version {z.get('version')}")
    if len(z["twists"]) != n or not (
        np.array_equal(z["twists"], twists) and np.array_equal(z["rises"], rises)
    ):
        raise HeliconError(
            f"checkpoint {path} was written for a different candidate "
            "grid — delete it (or change --checkpoint) to start fresh"
        )
    extras = tuple(np.array(z[k], np.float32) if k in z.files else empty
                   for k in ("extra_twists", "extra_rises", "extra_scores"))
    return (np.array(z["scores"], np.float32), np.array(z["pose"], np.float32),
            np.array(z["pose_mask"], bool), extras)


def reconstruct_grid_checkpointed(
    image,
    apix,
    twists,
    rises,
    checkpoint_path: str,
    chunk: int = 1024,
    should_abort=None,
    progress_callback=None,
    **kwargs,
):
    """Resumable ``reconstruct_grid``: the same result, interruptible.

    Scores land in ``checkpoint_path`` (.npz) after every ``chunk``
    candidates; a stopped run resumes from the last completed chunk on the
    next call with the same arguments. ``should_abort`` (polled between
    chunks) stops after the current chunk: the result then holds -inf for
    unscored candidates (NaN on disk, so that a resume knows what is
    missing), best_index -1 and no best volume. ``progress_callback(done,
    total, scores)`` runs after every chunk. Every reconstruct_grid keyword
    is accepted (``device`` defaults to the card there). Refinement as in
    the one-shot call: refine_mode "topk" refines each bucket's top-k after
    the coarse pass, "all" every candidate inside its chunk, its pose
    saved with its score."""
    from . import grid
    from .grid import GridResult, _rescore_and_pick, global_rise_buckets

    twists = np.asarray(twists, np.float32)
    rises = np.asarray(rises, np.float32)
    n = len(twists)
    buckets = global_rise_buckets(rises, float(kwargs.get("rise_bucket_ratio", 1.6)))
    scores, pose, pose_mask, loaded = _load_state(checkpoint_path, twists, rises)
    return_best_volume = kwargs.pop("return_best_volume", True)
    refine_range = kwargs.get("refine_tilt_psi_dy_range")
    defer_refine = bool(refine_range) and kwargs.get("refine_mode", "topk") != "all"
    sub_kw = dict(kwargs, return_best_volume=False)
    if defer_refine:
        sub_kw["refine_tilt_psi_dy_range"] = None

    def run(cand_idx, rise_range, **overrides):
        return grid.reconstruct_grid(image, apix, twists[cand_idx], rises[cand_idx],
                                     geometry_rise_range=rise_range,
                                     **dict(sub_kw, **overrides))

    # densify extras (rises in Angstrom): the shard's, then each new chunk's
    extra_parts = [loaded] if len(loaded[0]) else []

    def extras_arrays():
        if not extra_parts:
            return (np.zeros(0, np.float32),) * 3
        return tuple(np.concatenate(c) for c in zip(*extra_parts))

    def save():
        et, er, es = extras_arrays()
        _atomic_save(checkpoint_path, version=_STATE_VERSION, twists=twists, rises=rises,
                     scores=scores, pose=pose, pose_mask=pose_mask, extra_twists=et,
                     extra_rises=er, extra_scores=es)

    aborted = False
    chunks_run = 0
    local_sub = None
    step = max(1, int(chunk))
    for idx in buckets:
        rr = (float(np.min(rises[idx])), float(np.max(rises[idx])))
        todo = idx[np.isnan(scores[idx])]
        for s in range(0, len(todo), step):
            if should_abort is not None and should_abort():
                aborted = True
                break
            m = todo[s : s + step]
            local_sub = run(m, rr)
            scores[m] = local_sub.scores
            if local_sub.extras:
                extra_parts.append(tuple(local_sub.extras[k]
                                         for k in ("twists", "rises", "scores")))
            for i, v in (local_sub.refined_params or {}).items():  # refine_mode "all"
                pose[m[i]] = v
                pose_mask[m[i]] = True
            chunks_run += 1
            save()
            if progress_callback is not None:
                progress_callback(int(np.count_nonzero(~np.isnan(scores))), n, scores)
        if aborted:
            break

    et, er, es = extras_arrays()
    extras = dict(twists=et, rises=er, scores=es) if len(et) else None

    def refined():
        return {int(i): tuple(map(float, pose[i])) for i in np.where(pose_mask)[0]} or None

    if aborted or np.isnan(scores).any():
        # partial coarse scores: no merge stages, no winner re-solve
        return GridResult(
            twists=twists, rises=rises,
            scores=np.where(np.isnan(scores), -np.inf, scores).astype(np.float32),
            extras=extras,
            geom=local_sub.geom if local_sub is not None else None,
            target_apix2d=local_sub.target_apix2d if local_sub is not None else -1.0,
            target_apix3d=local_sub.target_apix3d if local_sub is not None else -1.0,
            best_index=-1,
            refined_params=refined(),
            effective=dict(local_sub.effective if local_sub is not None else {},
                           checkpointed=True, chunks_run=chunks_run, aborted=True),
        )

    # the merge stages change only the in-memory scores and poses: the file
    # keeps the coarse pass, so a re-run derives the same selection from it
    if defer_refine:
        # each bucket's top-k refined alone at the bucket's geometry
        k = max(1, int(kwargs.get("refine_top_k", 1)))
        for idx in buckets:
            rr = (float(np.min(rises[idx])), float(np.max(rises[idx])))
            for c in idx[np.argsort(-scores[idx])[: min(k, len(idx))]]:
                sub = run(np.asarray([c]), rr, refine_tilt_psi_dy_range=refine_range,
                          refine_top_k=1, batch_size=None, densify_padding=False)
                scores[c] = sub.scores[0]
                if sub.refined_params:
                    pose[c] = sub.refined_params[0]
                    pose_mask[c] = True
    if len(buckets) > 1:
        best, _, _ = _rescore_and_pick(
            lambda m: run(m, None, refine_tilt_psi_dy_range=None, densify_padding=False),
            buckets, rises, scores)
    else:
        best = int(np.argmax(scores)) if n else -1
    win = None
    if return_best_volume and best >= 0:
        # one bucket: the winner at the grid's geometry; bucketed: at its own
        win_rr = (float(np.min(rises)), float(np.max(rises))) if len(buckets) == 1 else None
        win = run(np.asarray([best]), win_rr, return_best_volume=True, batch_size=None,
                  refine_tilt_psi_dy_range=refine_range, densify_padding=False)
    ref_sub = win if win is not None else local_sub
    if ref_sub is None and n:
        # a fully resumed run without a winner re-solve: one single-candidate
        # call supplies the geometry the result reports (scores untouched)
        idx0 = buckets[0]
        local_sub = ref_sub = run(idx0[:1], (float(np.min(rises[idx0])),
                                             float(np.max(rises[idx0]))),
                                  batch_size=None, refine_tilt_psi_dy_range=None,
                                  densify_padding=False)
    return GridResult(
        twists=twists, rises=rises, scores=scores,
        geom=ref_sub.geom if ref_sub is not None else None,
        target_apix2d=ref_sub.target_apix2d if ref_sub is not None else -1.0,
        target_apix3d=ref_sub.target_apix3d if ref_sub is not None else -1.0,
        best_index=best,
        best_volume=win.best_volume if win is not None else None,
        refined_params=refined(),
        effective=dict(local_sub.effective if local_sub is not None else {},
                       checkpointed=True, chunks_run=chunks_run, n_buckets=len(buckets)),
        extras=extras,
    )
