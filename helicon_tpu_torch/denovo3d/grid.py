"""Candidate-grid driver: the (twist, rise) search on one class average.

Counterpart of ``helicon_tpu/denovo3d/grid.py``, with its two scoring
paths and its rule between them (``_use_grouped``). On the twist-grouped
path, candidates that share a twist form groups of R (the reference's
even split); each group's stacked operand A_top is built once and the
group's solves and scores run together (``group_solve``, kernel B1). G
groups go to the device per launch, G sized from a memory budget. The
per-candidate path (``_percand_scoring``) solves batches of k candidates
of one table shape (``solver.solve_candidates``: kernel B2 on the
separable operators, the gather projector for tilt or psi != 0). The best
candidate's volume is then re-solved alone in float32. A rise range wider
than ``rise_bucket_ratio`` runs one search per rise bucket, then re-scores
each bucket's best at per-candidate geometry
(``_reconstruct_grid_bucketed``).

The port covers any (tilt, psi) with nearest-neighbour or linear
interpolation on one device, the image prep options, the models lsq,
lreg, ridge, lasso, elasticnet (l1 / l2 and the alpha-decay retry) and
ard, every score metric, thresh_fraction, fsc modes 1-4 (on the grouped
path three B1 solves a launch, scored in the kernel for lsq + cosine, as
the reference's kernel, and in torch for lreg, a 2D metric or thresh, as
its grouped XLA path),
incremental progress and abort, densify_padding and pose refinement
(refine_mode "topk" and "all"); cost_analysis and several devices raise
NotImplementedError naming the ROADMAP item that will port them.
The host tables (``_candidate_tables``, ``_group_tables``,
``_copy_block``) and the bucket helpers are copies of the reference's
numpy code; ``tests/test_torch_geometry.py`` and
``tests/test_torch_drivers.py`` pin them.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import os
import time

import numpy as np
import torch

from ..angular import set_to_periodic_range
from ..core.filters import down_scale
from ..utils.precision import tf32_off as _tf32_off
from .geometry import (
    ReconstructionGeometry,
    estimate_copy_pair_counts,
    estimate_n_pair_ops,
    select_copies,
    select_pair_ops,
)
from .pipeline import _pixel_geometry, auto_sym_oversample, derive_task_geometry, prepare_data
from .solver import (
    SolveConfig,
    check_in_slice,
    regularization_from_algorithm,
    solve_candidate,
    solve_candidates,
)

__all__ = ["build_candidate_grid", "reconstruct_grid", "GridResult", "global_rise_buckets",
           "crossbucket_selection"]


def build_candidate_grid(
    twist_min: float,
    twist_max: float,
    twist_step: float,
    rise_min: float,
    rise_max: float,
    rise_step: float,
    handedness: str = "both",
    tube_length: float = math.inf,
):
    """(twist, rise) candidate list with the reference's filters:
    degenerate twist/rise and rise >= tube_length/2 dropped; handedness
    forcing for single-twist searches. Returns float32 arrays."""
    if handedness.startswith("left") and twist_max == twist_min:
        twists = [-abs(twist_max)]
    elif handedness.startswith("right") and twist_max == twist_min:
        twists = [abs(twist_max)]
    elif twist_min < twist_max:
        twists = np.arange(twist_min, twist_max + twist_step / 2, twist_step)
    else:
        twists = [twist_min]
    if rise_min < rise_max:
        rises = np.arange(rise_min, rise_max + rise_step / 2, rise_step)
    else:
        rises = [rise_min]

    out_t, out_r = [], []
    for t in twists:
        t = round(set_to_periodic_range(float(t), min=-180, max=180), 6)
        for r in rises:
            if abs(t) < 0.01 or abs(r) < 0.01 or abs(r) >= tube_length / 2:
                continue
            out_t.append(t)
            out_r.append(float(r))
    return np.asarray(out_t, np.float32), np.asarray(out_r, np.float32)


@dataclasses.dataclass
class GridResult:
    twists: np.ndarray
    rises: np.ndarray
    scores: np.ndarray
    geom: ReconstructionGeometry
    target_apix2d: float
    target_apix3d: float
    best_index: int = -1
    best_volume: np.ndarray | None = None
    refined_params: dict | None = None
    cost: dict | None = None
    # the dispatch actually in effect (path, R, groups per launch, ...)
    effective: dict | None = None
    extras: dict | None = None

    def top(self, n: int = 10):
        """(twist, rise, score) rows of the n best candidates."""
        order = np.argsort(-self.scores)[:n]
        return np.stack(
            [self.twists[order], self.rises[order], self.scores[order]], axis=1
        )


def _candidate_tables(
    geom, twists, rises, n_copies, n_pairs, n_ops, copy_cache=None
):
    """Host-side per-candidate symmetry copy/pair/op tables (padded)."""
    n = len(twists)
    ch = np.zeros((n, n_copies), np.int32)
    cc = np.zeros((n, n_copies), np.int32)
    cv = np.zeros((n, n_copies), bool)
    phc = np.zeros((n, n_pairs, 4), np.int32)
    pv = np.zeros((n, n_pairs), bool)
    ops_hc = np.zeros((n, n_ops, 2), np.int32)
    ops_v = np.zeros((n, n_ops), bool)
    pair_idx = np.zeros((n, n_pairs, 2), np.int32)
    if copy_cache is None:
        copy_cache = {}
    for i in range(n):
        r = float(rises[i])
        if r not in copy_cache:
            copy_cache[r] = select_copies(geom, r, n_copies)
        ch[i], cc[i], cv[i] = copy_cache[r]
        ops_hc[i], ops_v[i], pair_idx[i], pv[i] = select_pair_ops(
            geom, float(twists[i]), r, n_pairs, n_ops
        )
        o = ops_hc[i]
        phc[i, :, 0:2] = o[pair_idx[i, :, 0]]
        phc[i, :, 2:4] = o[pair_idx[i, :, 1]]
    return ch, cc, cv, phc, pv, ops_hc, ops_v, pair_idx


def _group_tables(
    geom, twist, rises_pixel, n_copies, n_pairs, n_ops, C_u, R_pad, copy_cache
):
    """Canonical-copy multiplicity + canonical pair tables for one
    twist-group. Returns (rises[R_pad], m[R_pad, C_u], ch_u[C_u],
    cc_u[C_u], pair_idx[R_pad, n_pairs, 2], pairs_valid[R_pad, n_pairs],
    rank[R_pad, C_u]); groups smaller than R_pad repeat their last
    candidate (scores discarded by the caller)."""
    from .geometry import _pair_table

    R = len(rises_pixel)
    csym = geom.csym
    hmax_p = (n_ops // csym - 1) // 2
    rises_pad, m, ch_u, cc_u, rank = _copy_block(
        geom, tuple(float(r) for r in rises_pixel),
        n_copies, C_u, R_pad, copy_cache,
    )
    pidx = np.zeros((R_pad, n_pairs, 2), np.int32)
    pval = np.zeros((R_pad, n_pairs), bool)
    prev_hm = None
    for ri, r in enumerate(rises_pixel):
        # the pair table depends on rise only through hmax
        hm = geom.hsym_max_pairs(float(r))
        if hm == prev_hm:
            pidx[ri] = pidx[ri - 1]
            pval[ri] = pval[ri - 1]
            continue
        prev_hm = hm
        t = _pair_table(float(twist), float(r), csym, geom.l3)[:n_pairs]
        if len(t):
            k1 = (t[:, 0] + hmax_p) * csym + t[:, 1]
            k2 = (t[:, 2] + hmax_p) * csym + t[:, 3]
            assert k1.min() >= 0 and k1.max() < n_ops, "op table too small"
            assert k2.min() >= 0 and k2.max() < n_ops, "op table too small"
            pidx[ri, : len(t), 0] = k1
            pidx[ri, : len(t), 1] = k2
            pval[ri, : len(t)] = True
    for ri in range(R, R_pad):
        pidx[ri] = pidx[R - 1]
        pval[ri] = pval[R - 1]
    return rises_pad, m, ch_u, cc_u, pidx, pval, rank


_COPY_BLOCK_CACHE: collections.OrderedDict = collections.OrderedDict()


def _copy_block(geom, rises_key, n_copies, C_u, R_pad, copy_cache):
    """Rise-only half of the group tables, cached on the rise tuple (copy
    selection is twist-independent, so every group of a Cartesian grid
    shares one block). Returned arrays are read-only."""
    key = (geom, rises_key, n_copies, C_u, R_pad)
    hit = _COPY_BLOCK_CACHE.get(key)
    if hit is not None:
        _COPY_BLOCK_CACHE.move_to_end(key)
        return hit
    R = len(rises_key)
    sels = []
    for r in rises_key:
        if r not in copy_cache:
            copy_cache[r] = select_copies(geom, r, n_copies)
        sels.append(copy_cache[r])
    # canonical union copy table, ordered by (|h|, h, c)
    union = set()
    for ch, cc, cv in sels:
        union.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    keys = sorted(union, key=lambda x: (abs(x[0]), x[0], x[1]))
    assert len(keys) <= C_u, (len(keys), C_u)
    col = {k: i for i, k in enumerate(keys)}
    ch_u = np.zeros(C_u, np.int32)
    cc_u = np.zeros(C_u, np.int32)
    for (h, c), i in col.items():
        ch_u[i], cc_u[i] = h, c
    m = np.zeros((R_pad, C_u), np.float32)
    rank = np.full((R_pad, C_u), -1, np.int32)
    for ri, (ch, cc, cv) in enumerate(sels):
        for pos, (h, c) in enumerate(zip(ch[cv].tolist(), cc[cv].tolist())):
            m[ri, col[(h, c)]] += 1.0  # Halton repeats -> multiplicity
            rank[ri, col[(h, c)]] = pos  # overwritten -> LAST position
    for ri in range(R, R_pad):
        m[ri] = m[R - 1]
        rank[ri] = rank[R - 1]
    rises_pad = np.concatenate(
        [np.asarray(rises_key, np.float32),
         np.full(R_pad - R, rises_key[-1], np.float32)]
    )
    out = (rises_pad, m, ch_u, cc_u, rank)
    for a in out:
        a.flags.writeable = False
    while len(_COPY_BLOCK_CACHE) >= 256:
        _COPY_BLOCK_CACHE.popitem(last=False)
    _COPY_BLOCK_CACHE[key] = out
    return out


def _group_bytes(geom, C_u: int, n_ops: int, R: int, cdt, fsc: bool = False) -> int:
    """Device bytes one group holds during a launch: A_top, the two
    (R*l3, rows) product buffers and the per-candidate tensors; with fsc
    also the two half-set solves' j-dependent z-Grams (d2 times Gz) and
    their rhs."""
    d3sq, l3 = geom.d3 * geom.d3, geom.l3
    rows = C_u * geom.d2 + n_ops * d3sq
    item = torch.empty((), dtype=cdt).element_size()
    M = R * l3
    gz = R * C_u * l3 * l3 * 4
    return (
        rows * d3sq * item
        + M * rows * (4 + item)
        + 2 * R * n_ops * l3 * d3sq * 4
        + gz
        + 8 * M * d3sq * 4
        + (2 * (gz * geom.d2 + M * d3sq * 4) if fsc else 0)
    )


def _groups_per_launch(per_group: int, n_groups: int, device: torch.device,
                       card_processes: int = 1) -> int:
    """G: half the card's free memory (1 GiB on the host), shared by the
    card_processes processes that size their launches on this card at once,
    over one group's bytes, at least 1 and at most the number of groups."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = free // 2 // max(1, int(card_processes))
    else:
        budget = 1 << 30
    return max(1, min(n_groups, budget // max(1, per_group)))


def _dispatch_candidates(geom, n_copies: int, n_ops: int, n_cand: int) -> int:
    """The reference's automatic batch size on one device (its
    grid.py:1256-1268): the candidates one call dispatches when the caller
    names no batch_size, from a budget of 9e9 bytes over its per-candidate
    operator estimate, clamped to [8, 1024] and to the grid. The port
    sizes its launches from free memory instead; it takes this, as the
    reference does, as the cap on the twist-group size R (so that the
    padding and the densify extras are the reference's) and as the
    progress and abort granularity of incremental mode, the web app's
    call."""
    d3sq = geom.d3 * geom.d3
    per_cand = 5.0 * n_copies * geom.d2 * d3sq + 3.0 * n_ops * d3sq * d3sq
    return max(1, min(n_cand, max(8, min(1024, int(9e9 / max(per_cand, 1.0))))))


def _retry_all_zero(solve, inp, x, l1, l2, iters):
    """The alpha-decay retry of the reference (solver.py:842-862) on the
    grouped solve: solver.retry_all_zero over whole-launch solves, the l1 /
    l2 columns scaled. Returns (x, rounds)."""
    from .solver import retry_all_zero

    def col(c, scale):
        return None if c is None else c * float(scale)

    return retry_all_zero(
        lambda scale: solve(inp, *iters, l1=col(l1, scale), l2=col(l2, scale),
                            with_score=False)[0], x, 2)


def _score_group(cfg, geom, ctx, wsum, rp, m, rank, x, b, w=None):
    """Score one solved group in torch (the reference's score_one,
    solver.py:880-912): the sqrt(m)-weighted reprojection of x (R, l3,
    d3^2) masked by the binary rows, the thresh clip, then the cosine and,
    for a 2D metric, the reprojection image by the group's copy ranks and
    1/sqrt(m). With w (1, l2, d2), an fsc half's pixel-id mask, both row
    masks take it, as the reference's half solves score (solver.py:667).
    Returns (cosines (R,), images (R, l2, d2) or None): the 2D metrics run
    once over a launch's images (solver._image_scores)."""
    from .projector_grouped import reproject_grouped
    from .solver import _cosine, _image_of

    sqrt_m = torch.sqrt(m)
    pred, rowv_bin, rowv_w = reproject_grouped(dict(ctx, Wsum=wsum), geom, rp, sqrt_m, x)
    if w is not None:
        rowv_bin, rowv_w = rowv_bin * w, rowv_w * w
    pred = pred * rowv_bin
    if cfg.thresh_fraction >= 0:
        pred = torch.clamp_min(pred, 0.0)
    cos = _cosine(pred, b * rowv_w)
    if cfg.score_metric == "cosine":
        return cos, None
    inv_w = torch.where(sqrt_m > 0, 1.0 / sqrt_m.clamp_min(1e-30), 0.0)
    return cos, _image_of(pred, rowv_w, rank, inv_w)


def _twist_groups(twists, rise_pixels, geom, copy_cache, n_copies, batch_size,
                  densify_padding):
    """The reference's split of the candidates into twist groups of R
    (its grid.py:746-815): R from a cap of max(16, min(64, 1024 // l3)),
    capped by the largest twist's candidate count and batch_size (the
    caller's, or the automatic one: _grouped_scoring passes it), then an
    even split of that count. With densify_padding the
    padded slots of a group whose rises differ become real candidates, the
    midpoints of its largest rise gaps taken in turn. Returns (groups
    [(twist, candidate indices, extra rise pixels or None)], R, C_u the
    width of the canonical copy table, the union over every rise)."""
    raw_groups = [(float(t), np.where(twists == t)[0]) for t in np.unique(twists)]
    max_size = max(len(g) for _, g in raw_groups)

    def union(rises, u):
        for r in rises:
            r = float(r)
            if r not in copy_cache:
                copy_cache[r] = select_copies(geom, r, n_copies)
            ch, cc, cv = copy_cache[r]
            u.update(zip(ch[cv].tolist(), cc[cv].tolist()))
        return u

    u_all = union(np.unique(rise_pixels), set())
    cap = max(16, min(64, 1024 // max(1, geom.l3)))
    cap = min(cap, max_size, batch_size or cap)
    R = -(-max_size // -(-max_size // max(1, cap)))
    groups = [(t, g[s : s + R], None) for t, g in raw_groups for s in range(0, len(g), R)]
    if densify_padding:
        dens = []
        for t, g, _ in groups:
            k, ext = R - len(g), None
            vals = list(np.unique(rise_pixels[g].astype(np.float64)))
            if k > 0 and len(vals) >= 2:
                new = []
                for _ in range(k):
                    j = int(np.argmax(np.diff(vals)))
                    mid = 0.5 * (vals[j] + vals[j + 1])
                    new.append(mid)
                    vals.insert(j + 1, mid)
                ext = np.asarray(new, np.float32)
            dens.append((t, g, ext))
        groups = dens
        for _, _, ext in groups:
            if ext is not None:
                union(ext, u_all)
    return groups, R, len(u_all)


def _grouped_scoring(
    geom, cfg, twists, rise_pixels, n_copies, n_pairs, n_ops, region,
    dy_pixel, copy_cache, device, solve=None, batch_size=None,
    progress_callback=None, should_abort=None, densify_padding=False, card_processes=1,
):
    """Score every candidate, G twist groups per solve launch (the
    counterpart of the reference's _solve_group_pallas). ``solve`` is the
    grouped solve (by default group_solve.solve_group with the reference's
    power seed, ``POWER_SEED``; validate_grouped_on_gpu passes the kernel
    and the plain version, each with its own default seed).

    Incremental mode (progress_callback or should_abort given): unscored
    candidates hold -inf, should_abort() is polled before each launch
    (True stops the search), progress_callback(done, n_cand, scores) runs
    after each, and a launch holds at most batch_size // R groups, where
    batch_size is the caller's or, when None, the reference's automatic
    one (_dispatch_candidates). Returns (scores (n,) float32 numpy,
    effective dispatch dict, with ``aborted`` and, under densify_padding,
    ``extras``: the padded slots' twists, rise pixels and scores)."""
    from .group_solve import GroupInputs, group_inputs, solve_group
    from .projector_grouped import build_candidate_tensors_grouped, build_group_shared
    from .solver import _image_scores, _pid_split_masks, seed_lreg

    solve = solve or functools.partial(solve_group, power_seed=POWER_SEED)
    n_cand = len(twists)
    incremental = progress_callback is not None or should_abort is not None
    # the reference caps R by the caller's batch or its automatic one
    auto_batch = batch_size or _dispatch_candidates(geom, n_copies, n_ops, n_cand)
    groups, R, C_u = _twist_groups(twists, rise_pixels, geom, copy_cache, n_copies,
                                   auto_batch, densify_padding)
    cdt = getattr(torch, cfg.compute_dtype)
    fsc_masks = _pid_split_masks(geom, cfg.fsc_test) if cfg.fsc_test else None
    G = _groups_per_launch(_group_bytes(geom, C_u, n_ops, R, cdt, fsc_masks is not None),
                           len(groups), device, card_processes)
    per_launch = None
    if incremental:
        per_launch = auto_batch
        G = min(G, max(1, per_launch // R))
    regularized = cfg.l1_reg > 0 or cfg.l2_reg > 0
    # the kernel's cosine holds for the plain lsq solve; everything else
    # scores the returned volumes in torch
    score_in_kernel = (cfg.score_metric == "cosine" and cfg.thresh_fraction < 0
                       and not regularized and cfg.model != "lreg")
    iters = (cfg.cg_iters, cfg.fista_iters, cfg.power_iters)

    # canonical op enumeration: k = (h + hmax) * csym + c
    hmax_p = (n_ops // geom.csym - 1) // 2
    ops_h = np.repeat(np.arange(-hmax_p, hmax_p + 1), geom.csym).astype(np.int32)
    ops_c = np.tile(np.arange(geom.csym), 2 * hmax_p + 1).astype(np.int32)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # every host table goes to the device once per launch: a copy from
    # pageable memory waits for the device, so one per group would
    # serialise the builds with the device
    ops_h, ops_c = to_dev(ops_h), to_dev(ops_c)
    mask, cellok = to_dev(geom.cylindrical_mask()), geom.cell_valid_mask()
    region_t = to_dev(np.asarray(region, np.float32))
    b2d = region_t.T
    row_scale = np.float32(geom.d2 * geom.l2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    scores = np.full(n_cand, -np.inf if incremental else 0.0, np.float32)
    extra_rows = []
    build_s = solve_s = score_s = 0.0
    rounds = done = 0
    aborted = False
    for start in range(0, len(groups), G):
        if should_abort is not None and should_abort():
            aborted = True
            break
        t0 = time.perf_counter()
        batch = groups[start : start + G]
        tabs = [
            _group_tables(geom, t, rise_pixels[g] if ext is None
                          else np.concatenate([rise_pixels[g], ext]),
                          n_copies, n_pairs, n_ops, C_u, R, copy_cache)
            for t, g, ext in batch
        ]
        rp, m, ch_u, cc_u, pidx, pval, rank = (to_dev(np.stack(c)) for c in zip(*tabs))
        twist = to_dev(np.asarray([t for t, _, _ in batch], np.float32))
        positive = to_dev(np.stack([
            _positive(cfg, tab[0], t, geom.l3) for (t, _, _), tab in zip(batch, tabs)
        ]))
        inp, halves, ctx = None, None, []
        for gi in range(len(batch)):
            shared = build_group_shared(
                geom, twist[gi], ch_u[gi], cc_u[gi], ops_h, ops_c, dy_pixel,
                cfg.interpolation, mask, cellok, cdt, device,
            )
            args = (shared, geom, region_t, rp[gi], torch.sqrt(m[gi]), pidx[gi], pval[gi])
            tens = build_candidate_tensors_grouped(*args)
            tens["lb"], tens["ub"] = _box_bounds(positive[gi], tens["ub_raw"])
            one = group_inputs(shared, tens)
            if inp is None:
                inp = GroupInputs.empty(len(batch), one)
            inp.put(gi, one)
            if fsc_masks is not None:
                # the half-set solves differ from the full one only in the
                # j-dependent z-Gram, the rhs and |b|
                for h, w in enumerate(fsc_masks):
                    th = build_candidate_tensors_grouped(*args, pid_mask=w[0])
                    th["lb"], th["ub"] = tens["lb"], tens["ub"]
                    oh = group_inputs(shared, th)
                    if halves is None:
                        halves = [{k: torch.empty((len(batch),) + getattr(oh, k).shape[1:],
                                                  device=device) for k in ("gz", "rhs", "bn")}
                                  for _ in fsc_masks]
                    for k in ("gz", "rhs", "bn"):
                        halves[h][k][gi].copy_(getattr(oh, k)[0])
                    del th, oh
            if not score_in_kernel:
                ctx.append({k: shared[k] for k in ("copies_h_u", "xy_any", "linear")})
            del shared, tens, one
        sync()
        t1 = time.perf_counter()
        x_halves = []
        if fsc_masks is not None and score_in_kernel:
            _, s = solve(inp, *iters)
            s1, s2 = (solve(dataclasses.replace(inp, **hv), *iters)[1] for hv in halves)
            s = s / 2 + (s1 + s2) / 4
        else:
            l1 = l2 = None
            if regularized:
                reg = (torch.clamp_min(m.sum(dim=2), 1.0) * float(row_scale)
                       if cfg.reg_per_row else torch.ones(m.shape[:2], device=device))
                l1 = reg * float(np.float32(cfg.l1_reg)) if cfg.l1_reg else None
                l2 = reg * float(np.float32(cfg.l2_reg)) if cfg.l2_reg else None
            x, s = solve(inp, *iters, l1=l1, l2=l2, with_score=score_in_kernel)
            if regularized:
                x, r = _retry_all_zero(solve, inp, x, l1, l2, iters)
                rounds = max(rounds, r)
            elif cfg.model == "lreg":
                x = seed_lreg(x, 2)
            if fsc_masks is not None:
                # the halves of an unregularized model, scored in torch:
                # plain solves without the lreg seed, as the reference's
                # (its solver.py:644-668); the routing rule keeps l1 / l2
                # with fsc off this path
                x_halves = [solve(dataclasses.replace(inp, **hv), *iters, with_score=False)[0]
                            for hv in halves]
        sync()
        t2 = time.perf_counter()
        if not score_in_kernel:
            nd = C_u * geom.d2

            def score_launch(x, w=None):
                cos, img = zip(*(
                    _score_group(cfg, geom, ctx[gi], inp.a_top[gi, :nd].reshape(C_u, geom.d2, -1),
                                 rp[gi], m[gi], rank[gi], x[gi], b2d, w)
                    for gi in range(len(batch))
                ))
                s = torch.stack(cos)
                if cfg.score_metric != "cosine":
                    s = _image_scores(cfg.score_metric, s.flatten(), torch.cat(img), b2d)
                    s = s.reshape(len(batch), -1)
                return s

            s = score_launch(x)
            if x_halves:
                s1, s2 = (score_launch(xh, to_dev(w)) for xh, w in zip(x_halves, fsc_masks))
                s = s / 2 + (s1 + s2) / 4
            sync()
        s_np = s.cpu().numpy()  # (len(batch), R)
        build_s += t1 - t0
        solve_s += t2 - t1
        score_s += time.perf_counter() - t2
        del inp, halves, x_halves
        for i, (t, g, ext) in enumerate(batch):
            scores[g] = s_np[i, : len(g)]
            done += len(g)
            if ext is not None:
                extra_rows.extend((t, float(r), float(s_np[i, len(g) + j]))
                                  for j, r in enumerate(ext))
        if progress_callback is not None:
            progress_callback(done, n_cand, scores)
    effective = dict(
        path="grouped", R=int(R), groups_per_launch=int(G), n_groups=len(groups),
        C_u=int(C_u), n_ops=int(n_ops), compute_dtype=cfg.compute_dtype,
        d3=int(geom.d3), l3=int(geom.l3),
        pad_fraction=round(1.0 - n_cand / (len(groups) * R), 4),
        densified=sum(len(e) for _, _, e in groups if e is not None), aborted=aborted,
        # incremental mode's candidates per launch (None: memory-sized)
        launch_candidates=per_launch,
        score_in_kernel=score_in_kernel,
        # the alpha-decay retry's extra rounds of solves (0: none needed)
        retry_rounds=int(rounds),
        # host seconds of the operator builds, the solves and the torch
        # scoring, each ended by a device synchronisation
        build_s=build_s, solve_s=solve_s, score_s=score_s,
    )
    if extra_rows:
        t, r, sc = (np.asarray(c, np.float32) for c in zip(*extra_rows))
        effective["extras"] = dict(twists=t, rise_pixels=r, scores=sc)
    return scores, effective


def _group_operator_bytes(geom, n_copies: int, n_ops: int, cfg) -> int:
    """The reference's estimate of one group's operator bytes (its
    grid.py:539-551): A_top with the float32 build and the cast copies it
    is stacked from."""
    item = 2 if cfg.compute_dtype in ("bfloat16", "float16") else 4
    rows = n_copies * geom.d2 + n_ops * geom.d3 * geom.d3
    return rows * geom.d3 * geom.d3 * (4 + 2 * item)


def _group_budget_bytes() -> int:
    """The per-group operator budget, HELICON_GROUP_BUDGET_MB (default
    1536 MB), as the reference reads it."""
    return int(os.environ.get("HELICON_GROUP_BUDGET_MB", "1536")) * 1024 * 1024


# Where the grouped search starts B1's power iteration: from ones, as the
# reference's XLA grouped solve (its solver.py:294), which every search off
# a TPU runs (the reference seeds from rhs only inside its TPU kernel). At a
# short power budget the seed moves the FISTA step and the scores (ROADMAP
# C15); B1's own default stays rhs, the kernel's.
POWER_SEED = "ones"


def _use_grouped(cfg, geom, twists, n_copies: int, n_ops: int) -> bool:
    """The reference's choice of scoring path (its grid.py:1298-1340): the
    twist-grouped path takes separable poses without ard and without fsc
    under l1 / l2, when the grid has at least two candidates per twist and
    one group's operators fit the budget; everything else goes per
    candidate. HELICON_GRID_GROUPED: -1 (default) that rule, 0 always per
    candidate, 1 grouped wherever the configuration allows, whatever the
    number of candidates per twist."""
    env = int(os.environ.get("HELICON_GRID_GROUPED", "-1"))
    use = (env != 0 and cfg.separable and cfg.model != "ard"
           and not (cfg.fsc_test and (cfg.l1_reg or cfg.l2_reg)))
    if use and env == -1:
        use = len(twists) >= 2 * len(np.unique(twists))
    return use and _group_operator_bytes(geom, n_copies, n_ops, cfg) <= _group_budget_bytes()


def _candidate_bytes(geom, cfg, n_copies: int, n_pairs: int, n_ops: int) -> int:
    """Device bytes one candidate holds during a per-candidate launch. On
    the separable operators: B2's operand [W2; Mxy] twice (once itself,
    whose views the dense factors are; once for the build's float32
    chunks, which hold at most projector_separable.BUILD_CHUNK_BYTES), the
    pair validity twice, the products' (l3, rows) buffers, the z-factors
    and, with fsc, a half's j-dependent z-Gram. On the gather projector: a
    few of the rays' (C, l2, d2) tensors (predictions, residuals,
    validity), the symmetry pairs' taps and the solve's volumes."""
    d3sq, l3, d2 = geom.d3 * geom.d3, geom.l3, geom.d2
    taps = 8 if cfg.interpolation.startswith("linear") else 1
    if not cfg.separable:
        return (8 * n_copies * geom.l2 * d2 * 4 + 2 * n_pairs * l3 * d3sq * taps * 12
                + 16 * l3 * d3sq * 4)
    item = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)).element_size()
    rows = n_copies * d2 + n_ops * d3sq
    return (2 * rows * d3sq * item + 2 * n_pairs * l3 * d3sq * 4 + l3 * rows * (4 + item)
            + n_copies * geom.l2 * l3 * 4 + 12 * l3 * d3sq * 4
            + (n_copies * l3 * l3 * d2 * 4 if cfg.fsc_test else 0))


def _percand_scoring(
    geom, cfg, twists, rise_pixels, n_copies, n_pairs, n_ops, region, pose, copy_cache,
    device, batch_size=None, progress_callback=None, should_abort=None, card_processes=1,
):
    """Score every candidate in launches of k (the counterpart of the
    reference's _percand_scoring): each launch builds its candidates' padded
    tables (_candidate_tables) and solves them together
    (solver.solve_candidates: B2 on the separable operators, the gather
    projector for a pose (tilt, psi) != 0; pose = (tilt, psi, dy_pixel)).
    k is half the free memory over _candidate_bytes, capped by batch_size;
    in incremental mode (progress_callback or should_abort given) it is
    the caller's batch_size or the reference's automatic one
    (_dispatch_candidates), unscored candidates hold -inf, should_abort()
    is polled before each launch and progress_callback(done, n_cand,
    scores) runs after each. Returns (scores (n,) float32 numpy, effective
    dispatch dict)."""
    from . import candidate_solve

    n_cand = len(twists)
    incremental = progress_callback is not None or should_abort is not None
    tilt, psi, dy_pixel = pose
    per_launch = None
    if incremental:
        k = per_launch = batch_size or _dispatch_candidates(geom, n_copies, n_ops, n_cand)
    else:
        per = _candidate_bytes(geom, cfg, n_copies, n_pairs, n_ops)
        k = _groups_per_launch(per, n_cand, device, card_processes)
        k = min(k, batch_size or k)
    k = max(1, min(k, n_cand))
    b2_before = sum(candidate_solve.launches.values())
    scores = np.full(n_cand, -np.inf if incremental else 0.0, np.float32)
    times: dict = {}
    aborted = False
    for start in range(0, n_cand, k):
        if should_abort is not None and should_abort():
            aborted = True
            break
        sl = slice(start, min(start + k, n_cand))
        ch, cc, cv, phc, pv, ops_hc, ops_v, pair_idx = _candidate_tables(
            geom, twists[sl], rise_pixels[sl], n_copies, n_pairs, n_ops, copy_cache
        )
        out = solve_candidates(
            geom, cfg, region, twists[sl], rise_pixels[sl], ch, cc, cv, phc, pv, tilt, psi,
            dy_pixel, pair_ops=(ops_hc, ops_v, pair_idx) if cfg.separable else None,
            device=device, times=times,
        )
        scores[sl] = out["score"].cpu().numpy()
        if progress_callback is not None:
            progress_callback(sl.stop, n_cand, scores)
    effective = dict(
        path="percand", batch_size=int(k), n_launches=-(-n_cand // k),
        n_copies=int(n_copies), n_pairs=int(n_pairs), n_ops=int(n_ops),
        # the gather projector computes in float32, as the reference's
        compute_dtype=cfg.compute_dtype if cfg.separable else "float32",
        d3=int(geom.d3), l3=int(geom.l3), separable=bool(cfg.separable), aborted=aborted,
        # incremental mode's candidates per launch (None: memory-sized)
        launch_candidates=per_launch,
        # the alpha-decay retry's extra rounds of solves (0: none needed)
        retry_rounds=int(times.get("retry_rounds", 0)),
        # host seconds of the operator builds, the solves and the torch
        # scoring, each ended by a device synchronisation
        build_s=times.get("build_s", 0.0), solve_s=times.get("solve_s", 0.0),
        score_s=times.get("score_s", 0.0),
        # B2's kernel launches (solves and ard's matvecs) on CUDA tensors
        b2_launches=sum(candidate_solve.launches.values()) - b2_before,
    )
    return scores, effective


def _positive(cfg, rises_pixel, twist, l3) -> np.ndarray:
    """Per-candidate positivity: the explicit flag, or auto when the
    pitch exceeds twice the volume length."""
    if cfg.positive_constraint > 0:
        return np.ones(len(rises_pixel), bool)
    if cfg.positive_constraint < 0:
        pitch = np.round(
            np.asarray(rises_pixel, np.float32) * np.float32(360.0)
            / np.abs(np.float32(twist))
        )
        return pitch > 2 * l3
    return np.zeros(len(rises_pixel), bool)


def _box_bounds(positive, ub_raw):
    """(lb, ub) per candidate: [0, max b] where positive, else unbounded."""
    pos = torch.as_tensor(positive, device=ub_raw.device)
    lb = torch.where(pos, 0.0, -torch.inf).to(torch.float32)
    ub = torch.where(pos, ub_raw, torch.inf).to(torch.float32)
    return lb, ub


def _raise_out_of_slice(cost_analysis, devices) -> None:
    """NotImplementedError for every argument the port does not cover yet."""
    checks = [
        ("cost_analysis", bool(cost_analysis), "A5c"),
        ("more than one device", devices is not None and len(devices) > 1, "A10b"),
    ]
    for name, on, item in checks:
        if on:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP {item})")


@_tf32_off
def reconstruct_grid(
    image,
    apix: float,
    twists,
    rises,
    csym: int = 1,
    tilt: float = 0.0,
    psi: float = 0.0,
    dy: float = 0.0,
    low_pass: float = -1,
    transpose: int = 0,
    horizontalize: int = 0,
    denoise: str = "",
    target_apix2d: float = -1,
    target_apix3d: float = -1,
    tube_diameter: float = -1,
    tube_diameter_inner: float = 0.0,
    tube_length: float = -1,
    reconstruct_length_rise: float = 3.0,
    thresh_fraction: float = -1,
    positive_constraint: int = -1,
    sym_oversample: int = -1,
    interpolation: str = "nn",
    algorithm: dict | None = None,
    score_metric: str = "cosine",
    fsc_test: int = 0,
    refine_tilt_psi_dy_range: dict | None = None,
    refine_top_k: int = 1,
    refine_mode: str = "topk",
    cg_iters: int = 120,
    fista_iters: int = 60,
    power_iters: int = 8,
    compute_dtype: str = "auto",
    batch_size: int | None = None,
    devices=None,
    return_best_volume: bool = True,
    progress_callback=None,
    should_abort=None,
    cost_analysis: bool = False,
    rise_bucket_ratio: float = 1.6,
    geometry_rise_range: tuple | None = None,
    densify_padding: bool = False,
    device="cuda",
    card_processes: int = 1,
) -> GridResult:
    """Score every (twist, rise) candidate for one class-average image.

    The reference's signature, plus ``device`` (default "cuda"; the CPU
    runs the kernels' plain versions). compute_dtype "auto" is bfloat16
    for the group operators on the card and float32 on the CPU; the
    best-volume re-solve always runs in float32 (TF32 off). The image
    prep runs on ``device``. A rise range wider than rise_bucket_ratio
    splits into rise buckets (_reconstruct_grid_bucketed) unless
    geometry_rise_range pins the geometry. The port sizes its launches
    from half the device's free memory, a card_processes-th of it where
    that many processes share the card and size theirs at once (the
    process-sharded search passes it); ``batch_size`` (else the reference's
    automatic batch size) caps the group size R and, in incremental mode
    (progress_callback / should_abort), the candidates per launch. The
    scoring path follows the reference's rule (``_use_grouped``, with its
    HELICON_GRID_GROUPED): grids with fewer than two candidates per twist,
    a pose with tilt or psi != 0, ard and fsc under l1 / l2 go per
    candidate, in launches sized the same way. ``refine_tilt_psi_dy_range``
    refines the pose (``_refine``, ``refine.py``): refine_mode "topk" the
    refine_top_k best candidates, "all" every candidate (without the
    fixed-pose pass unless incremental); ``refined_params`` holds the
    refined (tilt, psi, dy pixels) by candidate index, and the best volume
    is solved at its candidate's refined pose.
    """
    algorithm = algorithm or dict(model="lsq")
    device = torch.device(device)
    _raise_out_of_slice(cost_analysis, devices)
    twists = np.asarray(twists, np.float32)
    rises = np.asarray(rises, np.float32)
    if twists.shape != rises.shape or twists.ndim != 1:
        raise ValueError("twists and rises must be 1D arrays of equal length")
    n_cand = len(twists)
    if n_cand == 0:
        raise ValueError(
            "no (twist, rise) candidates to score — check the grid "
            "ranges/filters (build_candidate_grid drops |twist| < 0.01, "
            "|rise| < 0.01 and rise >= tube_length/2)"
        )
    if geometry_rise_range is None and rise_bucket_ratio > 1 and float(
        np.max(rises)
    ) > rise_bucket_ratio * max(float(np.min(rises)), 1e-6):
        # every argument but those the bucket driver owns (the candidates,
        # the progress and abort plumbing, return_best_volume, the ratio)
        fwd = dict(
            csym=csym, tilt=tilt, psi=psi, dy=dy, low_pass=low_pass,
            transpose=transpose, horizontalize=horizontalize, denoise=denoise,
            target_apix2d=target_apix2d, target_apix3d=target_apix3d,
            tube_diameter=tube_diameter, tube_diameter_inner=tube_diameter_inner,
            tube_length=tube_length, reconstruct_length_rise=reconstruct_length_rise,
            thresh_fraction=thresh_fraction, positive_constraint=positive_constraint,
            sym_oversample=sym_oversample, interpolation=interpolation,
            algorithm=algorithm, score_metric=score_metric, fsc_test=fsc_test,
            refine_tilt_psi_dy_range=refine_tilt_psi_dy_range, refine_top_k=refine_top_k,
            refine_mode=refine_mode, cg_iters=cg_iters, fista_iters=fista_iters,
            power_iters=power_iters, compute_dtype=compute_dtype, batch_size=batch_size,
            devices=devices, cost_analysis=cost_analysis,
            densify_padding=densify_padding, device=device, card_processes=card_processes,
        )
        return _reconstruct_grid_bucketed(
            image, apix, twists, rises, rise_bucket_ratio, fwd,
            return_best_volume, progress_callback, should_abort,
        )
    model = algorithm.get("model", "lsq")
    l1, l2r = regularization_from_algorithm(algorithm, 1)
    if compute_dtype in ("auto", ""):
        compute_dtype = "bfloat16" if device.type != "cpu" else "float32"
    cfg = SolveConfig(
        interpolation=interpolation,
        model=model,
        cg_iters=cg_iters,
        fista_iters=fista_iters,
        power_iters=power_iters,
        fsc_test=int(fsc_test),
        score_metric=score_metric,
        thresh_fraction=float(thresh_fraction),
        positive_constraint=int(positive_constraint),
        l1_reg=float(l1),
        l2_reg=float(l2r),
        reg_per_row=model in ("lasso", "elasticnet"),
        separable=(tilt == 0.0 and psi == 0.0),
        compute_dtype=compute_dtype,
        ard_prior=float(algorithm.get("alpha", 1e-6)),
    )
    check_in_slice(cfg)

    data = prepare_data(image, apix, denoise, low_pass, transpose, horizontalize, device=device)
    ny0, nx0 = data.shape
    estimated_diameter = None
    if tube_diameter < 0:
        from ..core.analysis import estimate_helix_rotation_center_diameter

        _, _, estimated_diameter = estimate_helix_rotation_center_diameter(data.cpu().numpy())

    if geometry_rise_range is not None:
        g_rise_lo, g_rise_hi = map(float, geometry_rise_range)
    else:
        g_rise_lo, g_rise_hi = float(np.min(rises)), float(np.max(rises))
    rise_ref = g_rise_hi
    g = derive_task_geometry(
        (ny0, nx0),
        apix,
        rise_ref,
        (g_rise_lo, g_rise_hi),
        (-abs(tilt), abs(tilt)),
        tube_length,
        tube_diameter,
        tube_diameter_inner,
        reconstruct_length_rise * rise_ref,
        target_apix2d,
        target_apix3d,
        estimated_diameter,
    )
    target_apix2d = g["target_apix2d"]
    data = down_scale(data, target_apix2d, apix).cpu().numpy()
    ny, nx = data.shape
    pg = _pixel_geometry(g, (ny, nx), rise_ref)
    target_apix3d = pg["target_apix3d"]
    geom = ReconstructionGeometry(
        d2=pg["d2"],
        l2=pg["l2"],
        d3=pg["d3"],
        l3=pg["l3"],
        rmin=pg["d3_inner"] / 2,
        rmax=pg["d3"] // 2 - 1,
        scale2d_to_3d=target_apix2d / target_apix3d,
        csym=int(csym),
    )
    if sym_oversample <= 0:
        sym_oversample = auto_sym_oversample(pg["l3"], pg["d3"], pg["d3_inner"])
    rise_pixels = rises / target_apix3d
    n_copies, n_pairs = estimate_copy_pair_counts(
        geom, float(np.min(rise_pixels)), sym_oversample,
        rise_pixel_max=float(np.max(rise_pixels)),
    )
    n_ops = estimate_n_pair_ops(geom, float(np.min(rise_pixels)))
    region = data[
        ny // 2 - geom.d2 // 2 : ny // 2 + geom.d2 // 2,
        nx // 2 - geom.l2 // 2 : nx // 2 + geom.l2 // 2,
    ]
    copy_cache: dict = {}
    dy_pixel = np.float32(dy / target_apix2d)
    drive = dict(batch_size=batch_size, progress_callback=progress_callback,
                 should_abort=should_abort, card_processes=card_processes)
    incremental = progress_callback is not None or should_abort is not None
    refine_all = bool(refine_tilt_psi_dy_range) and refine_mode == "all"
    t0 = time.perf_counter()
    if refine_all and not incremental:
        # every score is replaced by its refined pose's: the fixed-pose
        # ranking would go unread (it still runs for incremental progress)
        scores = np.zeros(n_cand, np.float32)
        effective = dict(path="refine_all", aborted=False, d3=int(geom.d3), l3=int(geom.l3),
                         n_copies=int(n_copies), n_pairs=int(n_pairs), n_ops=int(n_ops))
    elif _use_grouped(cfg, geom, twists, n_copies, n_ops):
        scores, effective = _grouped_scoring(
            geom, cfg, twists, rise_pixels, n_copies, n_pairs, n_ops, region,
            dy_pixel, copy_cache, device, densify_padding=densify_padding, **drive,
        )
    else:
        scores, effective = _percand_scoring(
            geom, cfg, twists, rise_pixels, n_copies, n_pairs, n_ops, region,
            (tilt, psi, dy_pixel), copy_cache, device, **drive,
        )
    effective["search_s"] = time.perf_counter() - t0
    refined_params = None
    if refine_tilt_psi_dy_range and not effective["aborted"]:
        scores, refined_params = _refine(
            geom, cfg, region, twists, rise_pixels, scores, n_copies, n_pairs, n_ops,
            copy_cache, (tilt, psi, dy_pixel), refine_tilt_psi_dy_range, refine_mode,
            refine_top_k, batch_size, device, effective, card_processes)
    extras = None
    if "extras" in effective:
        ee = effective.pop("extras")
        # rises in Angstrom, as the caller gave them
        extras = dict(twists=ee["twists"], rises=ee["rise_pixels"] * np.float32(target_apix3d),
                      scores=ee["scores"])
    result = GridResult(
        twists=twists,
        rises=rises,
        scores=scores,
        geom=geom,
        target_apix2d=float(target_apix2d),
        target_apix3d=float(target_apix3d),
        refined_params=refined_params,
        effective=effective,
        extras=extras,
    )
    result.best_index = int(np.argmax(scores))
    # partial scores: no re-solve of an arbitrary argmax
    if return_best_volume and not effective["aborted"]:
        bi = result.best_index
        # the winner's own pose: its refined one where refinement ran
        pose = refined_params.get(bi, (tilt, psi, dy_pixel)) if refined_params else (
            tilt, psi, dy_pixel)
        cfg_best = cfg._replace(compute_dtype="float32",
                                separable=(pose[0] == 0.0 and pose[1] == 0.0))
        ch, cc, cv, phc, pv, ops_hc, ops_v, pair_idx = _candidate_tables(
            geom, twists[bi : bi + 1], rise_pixels[bi : bi + 1],
            n_copies, n_pairs, n_ops, copy_cache,
        )
        from .geometry import compute_sym_dedup_mask

        # the nn re-solve drops duplicate symmetry rows (the reference's nn
        # dedup); the scoring pass skips it, as the ranking is invariant
        sym_keep = None
        if cfg.interpolation == "nn":
            sym_keep = compute_sym_dedup_mask(
                geom, float(twists[bi]), float(rise_pixels[bi]), phc[0], pv[0]
            )
        out = solve_candidate(
            geom,
            cfg_best,
            region,
            twists[bi],
            rise_pixels[bi],
            ch[0], cc[0], cv[0], phc[0], pv[0],
            *pose,
            pair_ops=(ops_hc[0], ops_v[0], pair_idx[0]) if cfg_best.separable else None,
            sym_keep=sym_keep,
            device=device,
        )
        result.best_volume = out["rec3d"].cpu().numpy()
    return result


def _refine(geom, cfg, region, twists, rise_pixels, scores, n_copies, n_pairs, n_ops,
            copy_cache, pose, r_range, refine_mode, refine_top_k, batch_size, device,
            effective, card_processes=1):
    """The reference's two refine branches (its grid.py:1408-1490), both on
    its refine_cfg (non-separable, float32). "all": every candidate refined
    from the grid's pose (refine.refine_all_candidates), its score replaced
    by its refined pose's. "topk": the refine_top_k best refined one at a
    time (refine.refine_tilt_psi_dy), each then re-solved at its refined
    pose for its score. Returns (scores, {index: (tilt, psi, dy)});
    effective gains the refine and re-solve seconds and the gather
    kernels' launches."""
    from . import gather_kernels
    from .refine import refine_all_candidates, refine_tilt_psi_dy

    refine_cfg = cfg._replace(separable=False, compute_dtype="float32")
    before = dict(gather_kernels.launches)
    t0 = time.perf_counter()
    resolve_s = 0.0
    if refine_mode == "all":
        tabs = _candidate_tables(geom, twists, rise_pixels, n_copies, n_pairs, n_ops, copy_cache)
        # k candidates a launch: half the free memory over one candidate's
        # bytes on the gather projector, capped by batch_size
        n = len(twists)
        per = _candidate_bytes(geom, refine_cfg, n_copies, n_pairs, 0)
        k = max(1, min(_groups_per_launch(per, n, torch.device(device), card_processes),
                       batch_size or n))
        scores, params = refine_all_candidates(
            geom, refine_cfg, region, twists, rise_pixels, tabs[:5], *pose, r_range,
            batch_size=k, device=device)
        refined = {i: tuple(map(float, params[i])) for i in range(len(twists))}
    else:
        scores = scores.copy()
        refined = {}
        for idx in np.argsort(-scores)[: max(1, int(refine_top_k))]:
            idx = int(idx)
            ch, cc, cv, phc, pv = _candidate_tables(
                geom, twists[idx : idx + 1], rise_pixels[idx : idx + 1], n_copies, n_pairs,
                n_ops, copy_cache)[:5]
            refined[idx] = refine_tilt_psi_dy(
                geom, refine_cfg, region, float(twists[idx]), float(rise_pixels[idx]),
                (ch[0], cc[0], cv[0]), (phc[0], pv[0]), *map(float, pose), r_range,
                device=device)
            t1 = time.perf_counter()
            out = solve_candidate(geom, refine_cfg, region, twists[idx], rise_pixels[idx],
                                  ch[0], cc[0], cv[0], phc[0], pv[0], *refined[idx],
                                  device=device)
            scores[idx] = float(out["score"])
            resolve_s += time.perf_counter() - t1
    effective.update(
        refine_mode=refine_mode, refine_s=time.perf_counter() - t0 - resolve_s,
        resolve_s=resolve_s,
        gather_launches={k: v - before[k] for k, v in gather_kernels.launches.items()})
    return scores, refined


def _rise_buckets(rises: np.ndarray, ratio: float):
    """Partition candidate indices into rise buckets with bounded spread:
    greedy over ascending rises, a bucket absorbs rises up to ratio * its
    smallest. Returns a list of index arrays covering range(len(rises))."""
    order = np.argsort(rises, kind="stable")
    buckets, cur = [], [int(order[0])]
    r0 = float(rises[order[0]])
    for i in order[1:]:
        if float(rises[i]) <= ratio * r0:
            cur.append(int(i))
        else:
            buckets.append(np.asarray(cur))
            cur, r0 = [int(i)], float(rises[i])
    buckets.append(np.asarray(cur))
    return buckets


def global_rise_buckets(rises, ratio) -> list:
    """The bucket partition reconstruct_grid applies to this whole
    candidate set ([arange(n)] when no bucketing triggers); a driver that
    scores subsets (the checkpointed search) reproduces the one-shot
    geometry by pinning each subset to its bucket's rise range."""
    rises = np.asarray(rises)
    n = len(rises)
    if (n and ratio and ratio > 1
            and float(np.max(rises)) > ratio * max(float(np.min(rises)), 1e-6)):
        return _rise_buckets(rises, ratio)
    return [np.arange(n)]


def crossbucket_selection(buckets, scores) -> np.ndarray:
    """The top 10 % (at least 10) of each bucket: the candidates the
    bucketed search re-scores at per-candidate geometry."""
    parts = []
    for idx in buckets:
        k = max(10, -(-len(idx) // 10))
        parts.append(idx[np.argsort(-scores[idx])[: min(k, len(idx))]])
    return np.unique(np.concatenate(parts))


def _rescore_and_pick(score, buckets, rises, scores, should_abort=None):
    """The second pass of a bucketed search, shared by the one-shot and the
    checkpointed drivers: each bucket's top 10 % (crossbucket_selection) is
    re-scored by ``score(indices)``, a reconstruct_grid call at one
    distinct rise's own geometry, into ``scores`` in place; should_abort is
    polled between the calls. Bucket scores compare only within a bucket,
    so the winner is the best re-scored candidate. Returns (winner index,
    -1 when no call ran; the winner's call result; aborted)."""
    sel = crossbucket_selection(buckets, scores)
    best, best_sub, best_score = -1, None, -np.inf
    for r in np.unique(rises[sel]):
        if should_abort is not None and should_abort():
            return best, best_sub, True
        m = sel[rises[sel] == r]
        sub = score(m)
        scores[m] = sub.scores
        if float(np.max(sub.scores)) > best_score:
            best_score = float(np.max(sub.scores))
            best, best_sub = int(m[int(np.argmax(sub.scores))]), sub
    return best, best_sub, False


def _reconstruct_grid_bucketed(
    image, apix, twists, rises, ratio, kw, return_best_volume, progress_callback, should_abort,
):
    """Run reconstruct_grid once per rise bucket, then re-score and merge.

    Each bucket recurses into reconstruct_grid (its rises now within
    ``ratio``: one geometry) with bucket-local progress and abort plumbing,
    without a best volume. Bucket scores compare only within a bucket (a
    longer volume has more unknowns and fits better), so each bucket's top
    10 % is re-scored at per-candidate geometry, one call per distinct
    selected rise, and the winner is taken from the re-scored set alone.
    One single-candidate call then solves the winner's volume. Abort is
    polled between the re-scoring calls (passing it down would overwrite
    good coarse scores with a partial launch's -inf)."""
    n_cand = len(twists)
    incremental = progress_callback is not None or should_abort is not None
    scores = np.full(n_cand, -np.inf if incremental else 0.0, np.float32)
    merged_refined: dict = {}
    merged_extras = []
    best_sub, best_score, best_global_idx = None, -np.inf, -1
    done_off = 0
    aborted = False
    buckets = _rise_buckets(rises, ratio)
    for idx in buckets:
        if should_abort is not None and should_abort():
            aborted = True
            break

        def cb(done_b, _n_b, scores_b, idx=idx, off=done_off):
            scores[idx] = scores_b
            if progress_callback is not None:
                progress_callback(off + done_b, n_cand, scores)

        sub = reconstruct_grid(
            image, apix, twists[idx], rises[idx], return_best_volume=False,
            progress_callback=cb if incremental else None, should_abort=should_abort,
            rise_bucket_ratio=ratio, **kw,
        )
        scores[idx] = sub.scores
        done_off += len(idx)
        if sub.extras:
            merged_extras.append(sub.extras)
        if sub.refined_params:
            merged_refined.update({int(idx[k]): v for k, v in sub.refined_params.items()})
        if sub.effective["aborted"]:
            aborted = True
            break
        if float(np.max(sub.scores)) > best_score:
            best_score = float(np.max(sub.scores))
            best_sub, best_global_idx = sub, int(idx[int(np.argmax(sub.scores))])

    if not aborted:
        # re-scoring known candidates must not mint duplicate extras
        rkw = dict(kw, refine_tilt_psi_dy_range=None, cost_analysis=False,
                   densify_padding=False)
        best, sub, aborted = _rescore_and_pick(
            lambda m: reconstruct_grid(image, apix, twists[m], rises[m],
                                       return_best_volume=False, rise_bucket_ratio=ratio, **rkw),
            buckets, rises, scores, should_abort,
        )
        if best >= 0:
            best_global_idx, best_sub = best, sub
        if progress_callback is not None:
            progress_callback(n_cand, n_cand, scores)

    extras = None
    if merged_extras:
        extras = {k: np.concatenate([e[k] for e in merged_extras])
                  for k in ("twists", "rises", "scores")}
    result = GridResult(
        twists=twists,
        rises=rises,
        scores=scores,
        geom=best_sub.geom if best_sub is not None else None,
        target_apix2d=best_sub.target_apix2d if best_sub is not None else -1.0,
        target_apix3d=best_sub.target_apix3d if best_sub is not None else -1.0,
        refined_params=merged_refined or None,
        effective=dict(best_sub.effective if best_sub is not None else {},
                       n_buckets=len(buckets), aborted=aborted),
        extras=extras,
    )
    result.best_index = best_global_idx if best_global_idx >= 0 else int(np.argmax(scores))
    if return_best_volume and best_sub is not None and not aborted:
        # one candidate: no caller's batch to cap it, nothing to densify
        win = reconstruct_grid(
            image, apix, twists[best_global_idx : best_global_idx + 1],
            rises[best_global_idx : best_global_idx + 1], return_best_volume=True,
            rise_bucket_ratio=ratio, **dict(kw, batch_size=None, densify_padding=False),
        )
        result.best_volume = win.best_volume
        result.geom = win.geom
        result.target_apix2d = win.target_apix2d
        result.target_apix3d = win.target_apix3d
        if win.refined_params:
            # refinement runs again on the winner alone, at its own geometry
            merged_refined[best_global_idx] = win.refined_params[0]
            result.refined_params = merged_refined
    return result
