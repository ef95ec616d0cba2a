"""One run of one cell: set-up, the measured window, the check, the result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up loads torch, the program and its kernel library (built into the
checkout's ``build/`` on a checkout's first run), makes the cell's stack of
class averages on the card from the seed and warms up with one search at
the cell's own shapes. The window (``window``) then searches the stack in a
closed loop; with ``--trace 1`` a slice of it runs under torch.profiler.
After the window the program's state is freed and a sample of its searches
is compared with the plain reference (``check``). The last line of
standard output is the result, one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from . import cell as cell_mod
from . import check, counts, window
from . import trace as trace_mod
from . import traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "helicon_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = cell_mod.ROOT / "build" / "portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def read_metric(name: str, data):
    """The per-layer metric ``name``'s reader (``metrics/<name>.py``) on
    the run's data: a number, or None where it finds nothing to read."""
    mod = importlib.import_module(f"portbench.metrics.{name}")
    return mod.read(data)


class RunData:
    """What a metric reader reads: the window's records, its trace, and
    the work of one search as the benchmark counts it."""

    def __init__(self, win: window.Window, work: counts.Work):
        self.window, self.work = win, work
        self.untraced = [r for r in win.records if r.ok and not r.traced and r.effective]

    def mean_effective(self, key: str):
        vals = [r.effective[key] for r in self.untraced if key in r.effective]
        return float(np.mean(vals)) if vals else None

    def path(self):
        paths = {r.effective.get("path") for r in self.untraced}
        return paths.pop() if len(paths) == 1 else None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch

    bench_cell = cell_mod.load(args.workload)
    chips = int(bench_cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cache_dirs()
    return run_cell(bench_cell, args.seed, args.seconds, args.trace, torch.device("cuda", 0),
                    t_start)


def run_cell(bench_cell, seed: int, seconds: float, trace: int, dev, t_start: float,
             search=None) -> int:
    """Set-up, window, check and result of one run on ``dev`` (tests pass
    the CPU and a ``search`` in place of the program's entry); returns the
    exit code."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    chips = int(bench_cell.entry["chips"])
    parts = {}
    t = time.perf_counter()
    from helicon_tpu_torch import _build
    from helicon_tpu_torch.denovo3d import reconstruct_grid

    search = search or reconstruct_grid
    parts["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        _build.load_kernels()
    parts["kernel_library_s"] = time.perf_counter() - t  # the build, on a checkout's first run

    t = time.perf_counter()
    traffic, image = bench_cell.traffic, bench_cell.config["image"]
    twists, rises = bench_cell.grid()
    kw = bench_cell.search_kwargs
    stack = traffic_mod.ordered(traffic_mod.pool(image, traffic, dev), seed)
    warm = traffic_mod.warm_image(image, traffic, dev)
    parts["stack_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rec, _ = window.search_once(search, warm, twists, rises, kw, -1)
    if not rec.ok:
        print("portbench: the warm-up search failed", file=sys.stderr)
    sync()
    parts["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    win = window.run(search, stack, twists, rises, kw, seconds,
                     trace_searches=int(traffic.get("trace_searches", 2)) if trace else 0,
                     sync=sync)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    summary = None
    if win.profile is not None:
        t = time.perf_counter()
        summary = trace_mod.summarize(win.profile, win.traced_s)
        parts["trace_read_s"] = time.perf_counter() - t
        win.profile = None
    win.trace = summary
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, on the program's outputs, after the window
    t = time.perf_counter()
    readings = check.sample_readings(win.outcomes, stack.images,
                                     window.stack_order(win.records, win.outcomes, seed),
                                     int(traffic.get("check_searches", 1)), kw, twists,
                                     rises, dev)
    worst = check.worst(readings)
    limits = bench_cell.checks["limits"]
    attempted = len(win.records)
    failed = sum(not r.ok for r in win.records)
    correct = failed == 0 and attempted > 0 and check.judge(worst, limits)
    check_s = time.perf_counter() - t

    metrics = {}
    if trace:
        from ..reference.search import setup as ref_setup

        work = counts.search_work(ref_setup(stack.images[0], kw, twists, rises, dev), kw,
                                  bench_cell.config["precision"]["scoring"])
        data = RunData(win, work)
        for m in bench_cell.per_layer():
            v = read_metric(m["name"], data)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        walls = [r.wall_s for r in win.records]
        done = sum(r.n_candidates for r in win.records if r.ok)
        e2e = dict(candidates_per_s=done / win.seconds,
                   search_s_p95=float(np.percentile(walls, 95)) if walls else float("inf"),
                   setup_s=setup_s)
        for m in bench_cell.end_to_end():
            metrics[m["name"]] = dict(value=float(e2e[m["name"]]), unit=m["unit"])
    device = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                  kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  count=chips, memory_peak_bytes=peak,
                  power_limit=_power_limit() if dev.type == "cuda" else "none")
    result = dict(correct=bool(correct), attempted=attempted, failed=failed, metrics=metrics,
                  device=device)
    if trace and win.trace is not None:
        print(json.dumps(dict(work=dict(path=work.path, flops=work.flops, bytes=work.bytes,
                                        bound_by=work.bound_by()))), file=sys.stderr)
        device.update(busy_s=win.trace.busy_s, window_s=win.trace.window_s)
        result["breakdown"] = dict(device_ops=win.trace.device_ops,
                                   idle_gaps=win.trace.idle_gaps)
    walls = np.asarray([r.wall_s for r in win.records])
    eff = [r.effective for r in win.records if r.effective]
    traced_walls = [r.wall_s for r in win.records if r.traced]
    untraced_walls = [r.wall_s for r in win.records if not r.traced]
    print(json.dumps(dict(
        searches=attempted, window_s=win.seconds, wall_median_s=float(np.median(walls)),
        untraced_wall_mean_s=float(np.mean(untraced_walls)) if untraced_walls else None,
        traced_wall_mean_s=float(np.mean(traced_walls)) if traced_walls else None,
        wall_min_s=float(walls.min()), wall_max_s=float(walls.max()),
        groups_per_launch=sorted({e.get("groups_per_launch", e.get("batch_size")) for e in eff}),
        # searches that took over twice the median: [start in the window, wall, position]
        slow_searches=[[r.at_s, r.wall_s, r.index] for r in win.records
                       if r.wall_s > 2 * float(np.median(walls))],
        setup_parts=parts, check_s=check_s, checked=len(readings),
        determinacy=[r.get("volume_determinacy") for r in readings])), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    result["checks"] = {k: dict(value=worst.get(k), limit=limits[k]) for k in limits}
    for k in limits:
        print(f"check {k} {worst.get(k)} limit {limits[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
