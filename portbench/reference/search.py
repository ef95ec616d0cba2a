"""The plain reference of one (twist, rise) search: prep, geometry, every
candidate's operators, solve and cosine score, and the best candidate's
volume, in float32 with TF32 off.

It imports nothing of the program and takes nothing the program made: it
gets the raw class average and the search's settings, and works out the
prepared image, the geometry, the tables and the operators again. The
scoring pass runs by twist group (the whole twist in one group), which
gives every candidate the normal equations it has alone; the best volume
is solved alone on the dense factors, the nearest-neighbour symmetry rows
deduplicated, as the program re-solves its winner.

``rounding="fp8"`` with ``tf32=True`` is the control: the same code with
the scoring pass rounded to float8 e4m3 at the program's bf16 rounding
points and the best volume's products in TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from . import geometry as G
from .operators import candidate_operators, group_operators
from .prep import down_scale, prepare
from .solve import Rounding, candidate_solve, group_solve


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for float32 products on or off, restored on exit."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = enabled
    try:
        yield
    finally:
        for f, on in zip(flags, saved):
            f.allow_tf32 = on


@dataclasses.dataclass
class Search:
    """What a search derived: the geometry and its pixel sizes, the table
    sizes, the image region (l2, d2) as b, and the grid in pixels."""

    geom: G.Geometry
    target_apix2d: float
    target_apix3d: float
    n_copies: int
    n_pairs: int
    n_ops: int
    b: torch.Tensor
    twists: np.ndarray
    rise_pixels: np.ndarray
    kw: dict


def setup(image, kw: dict, twists, rises, device) -> Search:
    """Prep and geometry of a search with the settings kw (the program's
    keywords; the ones the reference does not model must be off)."""
    for key, off in (("low_pass", -1), ("denoise", ""), ("tilt", 0.0), ("psi", 0.0),
                     ("dy", 0.0), ("fsc_test", 0), ("thresh_fraction", -1),
                     ("score_metric", "cosine"), ("refine_tilt_psi_dy_range", None)):
        if kw.get(key, off) not in (off, None) and not (key == "low_pass" and kw[key] < 0):
            raise ValueError(f"the reference does not model {key}={kw[key]!r}")
    if (kw.get("algorithm") or {"model": "lsq"}).get("model", "lsq") != "lsq":
        raise ValueError("the reference models the lsq solve only")
    if kw.get("tube_diameter", -1) <= 0:
        raise ValueError("the reference needs the tube diameter given")
    apix = float(kw["apix"])
    twists = np.asarray(twists, np.float32)
    rises = np.asarray(rises, np.float32)
    if float(rises.max()) > kw.get("rise_bucket_ratio", 1.6) * float(rises.min()):
        raise ValueError("a rise range that the program would split into buckets")
    data = prepare(image, kw.get("transpose", 0), kw.get("horizontalize", 0), device)
    rise_ref = float(rises.max())
    g = G.task_sizes(data.shape, apix, rise_ref, (float(rises.min()), rise_ref), (0.0, 0.0),
                     kw.get("tube_length", -1), kw["tube_diameter"],
                     kw.get("tube_diameter_inner", 0.0),
                     kw.get("reconstruct_length_rise", 3.0) * rise_ref,
                     kw.get("target_apix2d", -1), kw.get("target_apix3d", -1))
    data = down_scale(data, g["target_apix2d"], apix)
    ny, nx = data.shape
    pg = G.pixel_sizes(g, (ny, nx), rise_ref)
    a2, a3 = pg["target_apix2d"], pg["target_apix3d"]
    geom = G.Geometry(d2=pg["d2"], l2=pg["l2"], d3=pg["d3"], l3=pg["l3"],
                      rmin=pg["d3_inner"] / 2, rmax=pg["d3"] // 2 - 1,
                      scale2d_to_3d=a2 / a3, csym=int(kw.get("csym", 1)))
    so = kw.get("sym_oversample", -1)
    if so <= 0:
        so = G.auto_sym_oversample(pg["l3"], pg["d3"], pg["d3_inner"])
    rise_pixels = rises / a3
    n_copies, n_pairs = G.copy_pair_counts(geom, float(rise_pixels.min()), so,
                                           float(rise_pixels.max()))
    n_ops = G.n_pair_ops(geom, float(rise_pixels.min()))
    region = data[ny // 2 - geom.d2 // 2: ny // 2 + geom.d2 // 2,
                  nx // 2 - geom.l2 // 2: nx // 2 + geom.l2 // 2]
    return Search(geom, float(a2), float(a3), n_copies, n_pairs, n_ops,
                  region.T.contiguous(), twists, rise_pixels, kw)


def _iters(kw):
    return (kw.get("cg_iters", 120), kw.get("fista_iters", 60), kw.get("power_iters", 8))


def _bounds(kw, rises_pixel, twist, l3, ub_raw):
    pos = torch.as_tensor(G.positive(kw.get("positive_constraint", -1), rises_pixel, twist,
                                     l3), device=ub_raw.device)
    return (torch.where(pos, 0.0, -torch.inf).to(torch.float32),
            torch.where(pos, ub_raw, torch.inf).to(torch.float32))


# float32 bytes of the groups' operands one batched solve holds
BATCH_BYTES = 4 << 30

_PER_GROUP = ("A_top", "Gz", "Mz_ops", "a_f", "Cn", "deg", "rhs", "b_norm", "ub_raw")


def scores(s: Search, rounding: str = "float32") -> np.ndarray:
    """Every candidate's cosine score (n,) float32. Each twist is one group;
    groups of equal shapes solve together, as many as BATCH_BYTES of
    operands hold."""
    rnd = Rounding(rounding)
    linear = s.kw.get("interpolation", "nn").startswith("linear")
    out = np.zeros(len(s.twists), np.float32)
    pending: dict = {}
    with tf32(False):
        for t in np.unique(s.twists):
            idx = np.where(s.twists == t)[0]
            rp = s.rise_pixels[idx]
            ch_u, cc_u, m, pidx, pval = G.group_tables(s.geom, float(t), rp, s.n_copies,
                                                       s.n_pairs, s.n_ops)
            op = group_operators(s.geom, float(t), ch_u, cc_u, m, pidx, pval, rp, s.n_ops,
                                 linear, s.b, s.b.device, operand=rnd)
            op["bounds"] = _bounds(s.kw, rp, float(t), s.geom.l3, op["ub_raw"])
            op["index"] = idx
            key = (len(idx), tuple(op["A_top"].shape))
            batch = pending.setdefault(key, [])
            batch.append(op)
            if len(batch) * op["A_top"].numel() * 4 >= BATCH_BYTES:
                _solve_batch(pending.pop(key), s, rnd, out)
        for batch in pending.values():
            _solve_batch(batch, s, rnd, out)
    return out


def _solve_batch(batch, s, rnd, out):
    op = {k: torch.stack([b[k] for b in batch]) for k in _PER_GROUP}
    op.update(mask=batch[0]["mask"], d2=batch[0]["d2"])
    lb = torch.stack([b["bounds"][0] for b in batch])
    ub = torch.stack([b["bounds"][1] for b in batch])
    _, sc = group_solve(op, lb, ub, _iters(s.kw), rnd)
    sc = sc.cpu().numpy()
    for b, row in zip(batch, sc):
        out[b["index"]] = row


def _candidate(s: Search, index: int):
    twist, rp = float(s.twists[index]), float(s.rise_pixels[index])
    linear = s.kw.get("interpolation", "nn").startswith("linear")
    tabs = G.candidate_tables(s.geom, twist, rp, s.n_copies, s.n_pairs, s.n_ops)
    keep = None if linear else G.sym_dedup_mask(s.geom, twist, rp, tabs["phc"], tabs["pv"])
    op = candidate_operators(s.geom, twist, rp, tabs, keep, linear, s.b, s.b.device)
    return op, twist, rp


def best_volume(s: Search, index: int, tf32_products: bool = False,
                dtype=torch.float32) -> np.ndarray:
    """The volume (l3, d3, d3) of candidate ``index`` solved alone in
    float32 (TF32 in its products with tf32_products; float64 with dtype,
    a witness of the float32 solve's own rounding)."""
    with tf32(tf32_products):
        op, twist, rp = _candidate(s, index)
        lb, ub = _bounds(s.kw, np.asarray([rp], np.float32), twist, s.geom.l3,
                         op["ub"].reshape(1))
        if dtype != torch.float32:
            op = {k: v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                  else v for k, v in op.items()}
            lb, ub = lb.to(dtype), ub.to(dtype)
        x = candidate_solve(op, lb[0], ub[0], _iters(s.kw))
    return x.float().reshape(s.geom.volume_shape).cpu().numpy()
