"""The grouped solve's share of its roofline: the least time its work
needs on the chip (the benchmark's own count of FLOPs and bytes, each
input byte read once; the larger of the two over the peaks) over the
program's solve span, ``effective["solve_s"]``: the host seconds from the
end of the operator build to the end of the solve launches, each ended by
a device synchronisation, so the kernels' time and the host's gaps
between them. Taken over that span and not over kernel names, so that it
reads the same whatever kernels do the work; it is at most the share over
the kernels' time alone. Nothing to read where the searches did not take
the grouped path."""

LAYER = "kernels"
UNIT = "%"
MOVES = "candidates_per_s"
SOURCE = "program_span"
PATH = "grouped"


def read(run):
    solve = run.mean_effective("solve_s")
    if run.path() != PATH or run.work.path != PATH or not solve:
        return None
    return 100.0 * run.work.bound_s() / solve
