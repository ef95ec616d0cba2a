"""The work a search does, counted by the benchmark itself, and the chip's
peaks.

Frozen copies of the port's analytic count (``denovo3d/grid.py``:
``_grouped_analytic_flops``, ``_n_matvecs``, ``_grouped_cost`` and the
separable branch of ``_percand_cost``), applied to the geometry the
reference derives and to the real candidates only, never to padded slots.
Bytes count each input byte read once and each output byte written once,
whatever an implementation reads again: a group's (or a candidate's)
stacked operand A_top once, however many matvecs stream it, each
candidate's other tensors once, x and its score written once. The bound
is then the least time any implementation needs, one that keeps the
operand on chip included, so that a share of it cannot pass 100 %.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# NVIDIA H100 SXM, dense, at the 700 W limit (data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def n_matvecs(iters) -> int:
    cg, fista, power = iters
    return power + 1 + cg + fista


def grouped_analytic_flops(d2, d3, l3, C_u, n_ops, iters) -> float:
    """Per candidate: per matvec two A_top products, the z-Gram apply and
    two z-shift contractions, plus two data passes (rhs and prediction)."""
    rows = C_u * d2 + n_ops * d3 * d3
    per_matvec = (4.0 * rows * d3 * d3 * l3 + 2.0 * C_u * d2 * l3 * l3
                  + 4.0 * n_ops * d3 * d3 * l3 * l3)
    return n_matvecs(iters) * per_matvec + 2.0 * (2.0 * C_u * d2 * d3 * d3 * l3)


def _cand_bytes_grouped(C_u, n_ops, d3sq, l3) -> int:
    return 4 * (C_u * l3 * l3 + n_ops * l3 * l3 + 2 * n_ops * l3 * d3sq + n_ops * n_ops
                + l3 * d3sq + 3 + l3 * d3sq + 1)


def _cand_bytes_separable(n_copies, n_pairs, n_ops, d3sq, l3) -> int:
    return 4 * (n_copies * l3 * l3 + n_pairs * l3 * n_ops * l3 + n_pairs * l3 * d3sq
                + l3 * d3sq + 4 + l3 * d3sq + 1)


@dataclasses.dataclass
class Work:
    """FLOPs and bytes of one search's scoring solve, and its path."""

    path: str
    flops: float
    bytes: float
    n_candidates: int

    def bound_s(self) -> float:
        """The least time the chip needs for this work."""
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_HBM_BYTES)

    def bound_by(self) -> str:
        return ("operations" if self.flops / PEAK_BF16_FLOPS >= self.bytes / PEAK_HBM_BYTES
                else "bytes")


def union_width(search, rise_pixels) -> int:
    """C_u: the width of the canonical copy table over every rise."""
    from ..reference.geometry import select_copies

    u = set()
    for r in np.unique(rise_pixels):
        ch, cc, cv = select_copies(search.geom, float(r), search.n_copies)
        u.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    return len(u)


def group_count(geom, twists, n_copies, n_ops, batch_size) -> int:
    """The twist groups of the grouped path: each twist's candidates in
    groups of R, R an even split of the largest twist's count under the
    cap max(16, min(64, 1024 // l3)) and the batch (the caller's, or the
    automatic one from a 9e9-byte budget over the per-candidate operator
    estimate, in [8, 1024])."""
    counts = np.unique(twists, return_counts=True)[1]
    max_size = int(counts.max())
    if not batch_size:
        d3sq = geom.d3 * geom.d3
        per = 5.0 * n_copies * geom.d2 * d3sq + 3.0 * n_ops * d3sq * d3sq
        batch_size = max(1, min(len(twists), max(8, min(1024, int(9e9 / max(per, 1.0))))))
    cap = min(max(16, min(64, 1024 // max(1, geom.l3))), max_size, batch_size)
    R = -(-max_size // -(-max_size // max(1, cap)))
    return int(sum(-(-int(c) // R) for c in counts))


def grouped_path(twists) -> bool:
    """The port's rule for separable lsq searches: grouped where the grid
    has at least two candidates per twist."""
    return len(twists) >= 2 * len(np.unique(twists))


def search_work(search, kw: dict, scoring_dtype: str) -> Work:
    """The scoring solve's work of one search on the geometry the reference
    derived (``reference.search.setup``), its operand stored in
    scoring_dtype."""
    g = search.geom
    iters = (kw["cg_iters"], kw["fista_iters"], kw["power_iters"])
    item = ITEM_BYTES[scoring_dtype]
    d3sq, l3, n = g.d3 * g.d3, g.l3, len(search.twists)
    if grouped_path(search.twists):
        C_u = union_width(search, search.rise_pixels)
        per = grouped_analytic_flops(g.d2, g.d3, l3, C_u, search.n_ops, iters)
        a_top = (C_u * g.d2 + search.n_ops * d3sq) * d3sq * item
        groups = group_count(g, search.twists, search.n_copies, search.n_ops,
                             kw.get("batch_size"))
        nbytes = (groups * (a_top + 4 * l3 * d3sq)
                  + n * _cand_bytes_grouped(C_u, search.n_ops, d3sq, l3))
        return Work("grouped", n * per, float(nbytes), n)
    per = grouped_analytic_flops(g.d2, g.d3, l3, search.n_copies, search.n_ops, iters)
    operand = (search.n_copies * g.d2 + search.n_ops * d3sq) * d3sq * item
    cand = operand + _cand_bytes_separable(search.n_copies, search.n_pairs, search.n_ops,
                                           d3sq, l3)
    return Work("percand", n * per, float(4 * l3 * d3sq + n * cand), n)
