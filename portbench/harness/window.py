"""The closed loop a run measures: one client searching a stack of class
averages back to back, as the batch command goes through a Class2D stack.
Each search is the program's entry, called as the command calls it; it is
timed on the host from the call to the ranking and the best volume on the
host. The search in flight at the deadline completes and counts, and the
window runs to its end."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import traceback

import numpy as np

from . import check


@dataclasses.dataclass
class Record:
    index: int  # position in the stack
    wall_s: float
    n_candidates: int
    effective: dict | None
    traced: bool
    ok: bool
    at_s: float = 0.0  # its start, in seconds from the window's start


@dataclasses.dataclass
class Window:
    records: list
    outcomes: dict  # stack index -> check.Outcome (the last search of each)
    seconds: float
    profile: object = None  # the traced slice's torch.profiler profile, or None
    traced_s: float = 0.0  # host seconds of the traced slice
    trace: object = None  # its trace.TraceSummary, once read


def _effective(res) -> dict:
    keep = ("path", "R", "groups_per_launch", "n_groups", "batch_size", "n_launches",
            "build_s", "solve_s", "score_s", "search_s", "b2_launches", "C_u", "n_ops")
    return {k: res.effective[k] for k in keep if res.effective and k in res.effective}


def search_once(search, image, twists, rises, kw, stack_index, traced=False):
    """One search, synchronised: (Record, Outcome or None)."""
    t0 = time.perf_counter()
    try:
        res = search(image, twists=twists, rises=rises, **kw)
        out = check.outcome(stack_index, res)
        ok = check.finite(out)
        eff = _effective(res)
    except Exception:  # a search that raises is counted failed, and the loop goes on
        traceback.print_exc(file=sys.stderr)
        out, ok, eff = None, False, None
    wall = time.perf_counter() - t0
    return Record(stack_index, wall, len(twists), eff, traced, ok), out


def run(search, stack, twists, rises, kw, seconds: float, trace_searches: int = 0,
        sync=lambda: None) -> Window:
    """Search the stack in a closed loop for ``seconds``. With
    trace_searches, the searches from the window's second on, that many,
    run under torch.profiler, which records the device's activity alone:
    recording every host operation as well slows these host-bound searches
    by half."""
    records, outcomes = [], {}
    prof, traced_s = None, 0.0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while time.perf_counter() < deadline:
        idx = i % len(stack.images)
        if trace_searches and i == 1:
            prof, traced_s, n = _traced(search, stack, twists, rises, kw, i, trace_searches,
                                        deadline, records, outcomes, sync, t_start)
            i += n
            continue
        at_s = time.perf_counter() - t_start
        rec, out = search_once(search, stack.images[idx], twists, rises, kw, idx)
        rec.at_s = at_s
        records.append(rec)
        if out is not None:
            outcomes[idx] = out
        i += 1
    return Window(records, outcomes, max(deadline, time.perf_counter()) - t_start, prof,
                  traced_s)


def _traced(search, stack, twists, rises, kw, first, count, deadline, records, outcomes,
            sync, t_start):
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    n = 0
    # no device to trace (the CPU): the slice runs without the profiler
    tracer = (profile(activities=[ProfilerActivity.CUDA]) if torch.cuda.is_available()
              else contextlib.nullcontext())
    with tracer as prof:
        t0 = time.perf_counter()
        while n < count and (n == 0 or time.perf_counter() < deadline):
            idx = (first + n) % len(stack.images)
            at_s = time.perf_counter() - t_start
            rec, out = search_once(search, stack.images[idx], twists, rises, kw, idx,
                                   traced=True)
            rec.at_s = at_s
            records.append(rec)
            if out is not None:
                outcomes[idx] = out
            n += 1
        sync()
        traced_s = time.perf_counter() - t0
    return prof, traced_s, n


def stack_order(records, outcomes, seed: int) -> list:
    """The stack positions of the searches completed in the window, in an
    order drawn from the seed."""
    done = sorted({r.index for r in records if r.ok and r.index in outcomes})
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    return [done[i] for i in rng.permutation(len(done))]
