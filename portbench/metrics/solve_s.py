"""Seconds per search the program spends in the scoring pass's solve
launches (its ``effective["solve_s"]``), the mean over the window's
untraced searches."""

LAYER = "scoring dispatch and operator build"
UNIT = "s"
MOVES = "candidates_per_s"
SOURCE = "program_span"


def read(run):
    return run.mean_effective("solve_s")
