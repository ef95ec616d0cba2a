"""Seconds per search the program spends building the operators of its
scoring pass (its ``effective["build_s"]``: host clock, ended by a device
synchronisation), the mean over the window's untraced searches."""

LAYER = "scoring dispatch and operator build"
UNIT = "s"
MOVES = "candidates_per_s"
SOURCE = "program_span"


def read(run):
    return run.mean_effective("build_s")
