"""The per-candidate solve's share of its roofline, by the grouped
solve's rule (``grouped_solve_roofline``) on the per-candidate path's
work (each candidate's operand read once) over the same solve span.
Nothing to read where the searches did not take the per-candidate path."""

LAYER = "kernels"
UNIT = "%"
MOVES = "candidates_per_s"
SOURCE = "program_span"
PATH = "percand"


def read(run):
    solve = run.mean_effective("solve_s")
    if run.path() != PATH or run.work.path != PATH or not solve:
        return None
    return 100.0 * run.work.bound_s() / solve
