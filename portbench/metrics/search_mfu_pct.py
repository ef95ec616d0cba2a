"""The whole search's share of the chip's bf16 peak: the benchmark's
analytic FLOPs of every candidate scored in the window's untraced
searches, over those searches' host seconds times 989 TFLOP/s (the traced
slice's searches run slower under the profiler, and are left out)."""

from portbench.harness.counts import PEAK_BF16_FLOPS

LAYER = "search"
UNIT = "%"
MOVES = "candidates_per_s"
SOURCE = "host_clock"


def read(run):
    seconds = sum(r.wall_s for r in run.untraced)
    if seconds <= 0:
        return None
    per_candidate = run.work.flops / run.work.n_candidates
    flops = sum(r.n_candidates for r in run.untraced) * per_candidate
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)
