"""Seconds per search outside the scoring pass: the search's wall less the
program's own ``effective["search_s"]`` (the prep, the geometry and host
tables, and the float32 best-volume re-solve), the mean over the window's
untraced searches."""

LAYER = "search entry"
UNIT = "s"
MOVES = "search_s_p95"
SOURCE = "program_span"


def read(run):
    vals = [r.wall_s - r.effective["search_s"] for r in run.untraced
            if "search_s" in r.effective]
    return sum(vals) / len(vals) if vals else None
