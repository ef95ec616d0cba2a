"""The comparison that decides ``correct``.

After the window has closed, a sample of the searches it completed, drawn
from the seed, is searched again by the plain reference (``reference``):
from the same raw class average and the same settings, in float32 with
TF32 off. Each number compared is the worst over the sample:

- ``geometry_mismatch``: the program's geometry and pixel sizes that
  differ from the reference's (exact: limit 0);
- ``score_gap``: the largest |program score - reference score| over every
  candidate of a search (the ranking with them);
- ``volume_err``: |program volume - reference volume| / |reference
  volume| of the best candidate, the reference solving the program's best
  candidate alone. Only where that volume is determined to float32: where
  the reference's float32 solve lies within ``DETERMINED`` of its float64
  solve. On a poorly determined candidate (a small twist: the copies and
  the symmetry pairs barely constrain some directions) the iterations grow
  float32's own rounding to ~1e-2 in every float32 solve, the reference's
  included, so that no limit could tell a lower precision from it there.
  Where the sample holds no determined volume, the searches after it, in
  the seed's order, are compared until one does (``sample_readings``); a
  run that compares none is not correct.

A search that raised, or returned a non-finite score or volume, is failed
and makes the run not correct.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NUMBERS = ("geometry_mismatch", "score_gap", "volume_err")
# the largest relative gap between the reference's float32 and float64
# solves of a best volume that still counts as determined to float32
DETERMINED = 1e-5


@dataclasses.dataclass
class Outcome:
    """What the program returned for one search (numpy, on the host)."""

    index: int  # position in the stack
    scores: np.ndarray
    best_index: int
    best_volume: np.ndarray
    geometry: dict


def outcome(index: int, res) -> Outcome:
    g = res.geom
    geometry = dict(d2=g.d2, l2=g.l2, d3=g.d3, l3=g.l3, rmin=float(g.rmin),
                    rmax=float(g.rmax), scale2d_to_3d=float(g.scale2d_to_3d), csym=g.csym,
                    target_apix2d=float(res.target_apix2d),
                    target_apix3d=float(res.target_apix3d))
    return Outcome(index, np.asarray(res.scores, np.float32).copy(), int(res.best_index),
                   np.asarray(res.best_volume, np.float32).copy(), geometry)


def finite(o: Outcome) -> bool:
    return bool(np.isfinite(o.scores).all() and np.isfinite(o.best_volume).all())


def reference_geometry(s) -> dict:
    g = s.geom
    return dict(d2=g.d2, l2=g.l2, d3=g.d3, l3=g.l3, rmin=float(g.rmin), rmax=float(g.rmax),
                scale2d_to_3d=float(g.scale2d_to_3d), csym=g.csym,
                target_apix2d=s.target_apix2d, target_apix3d=s.target_apix3d)


def reference(image, kw, twists, rises, device):
    """The float32 reference's search of one image: (setup, scores)."""
    from ..reference import search as ref

    s = ref.setup(image, kw, twists, rises, device)
    return s, ref.scores(s)


def _rel(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def volume_numbers(o: Outcome, s) -> dict:
    """``volume_err`` (None where the reference's best volume is not
    determined to float32) and ``volume_determinacy``, the reference's
    float32 solve's gap to its float64 solve (not compared), of the
    outcome o against the reference's setup s."""
    import torch

    from ..reference import search as ref

    v = ref.best_volume(s, o.best_index)
    det = _rel(v, ref.best_volume(s, o.best_index, dtype=torch.float64))
    return dict(volume_err=_rel(o.best_volume, v) if det <= DETERMINED else None,
                volume_determinacy=det)


def numbers(o: Outcome, s, sc, volume: dict | None = None) -> dict:
    """The numbers of one search: the outcome o against the reference's
    setup s and scores sc (its best volume solved at o's best index;
    ``volume`` its ``volume_numbers`` where they were read already)."""
    out = dict(geometry_mismatch=float(sum(
        o.geometry[k] != v for k, v in reference_geometry(s).items())))
    if o.scores.shape != sc.shape or o.best_volume.shape != s.geom.volume_shape:
        return dict(out, score_gap=float("inf"), volume_err=float("inf"))
    out["score_gap"] = float(np.abs(o.scores.astype(np.float64) - sc).max())
    return dict(out, **(volume or volume_numbers(o, s)))


def compare(o: Outcome, image, kw, twists, rises, device) -> dict:
    """The numbers of the program's outcome o of one image against the
    reference run on the same image."""
    return numbers(o, *reference(image, kw, twists, rises, device))


def sample_readings(outcomes: dict, images, order: list, k: int, kw, twists, rises,
                    device) -> list:
    """The numbers of the first k searches of ``order`` (stack positions);
    where none of them has a best volume determined to float32, then of the
    first search after them in ``order`` that has one."""
    from ..reference import search as ref

    readings = [compare(outcomes[i], images[i], kw, twists, rises, device)
                for i in order[:k]]
    for i in order[k:]:
        if any(r.get("volume_err") is not None for r in readings):
            break
        s = ref.setup(images[i], kw, twists, rises, device)
        volume = volume_numbers(outcomes[i], s)
        if volume["volume_err"] is not None:
            readings.append(numbers(outcomes[i], s, ref.scores(s), volume))
    return readings


def control_outcome(s) -> Outcome:
    """The control put in the program's place: the reference at the
    precision below the configuration's (the scoring pass rounded to
    float8 e4m3 where the program rounds to bf16, the best volume's
    products in TF32 where the program's are float32 with TF32 off)."""
    from ..reference import search as ref

    sc = ref.scores(s, "fp8")
    best = int(np.argmax(sc))
    return Outcome(-1, sc, best, ref.best_volume(s, best, tf32_products=True),
                   reference_geometry(s))


def worst(readings: list) -> dict:
    """The largest of each number over a sample's readings (None where no
    search of the sample gave one)."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in readings if r.get(k) is not None]
        out[k] = max(vals) if vals else None
    return out if readings else {}


def judge(readings: dict, limits: dict) -> bool:
    """Every number the cell compares (its limits' keys) read, and within
    its limit."""
    return bool(readings) and all(readings.get(k) is not None and readings[k] <= limits[k]
                                  for k in limits)
