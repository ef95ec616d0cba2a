"""Matrix-free projection / symmetry operators for any pose (gather form).

Counterpart of ``helicon_tpu/denovo3d/projector.py``. Both operators are
linear in the volume x (l3, d3, d3) and sample it along the reference's
coordinate conventions:

  data term   P(x)[t, i, j] = sum_k interp(x, pose_t(i, j, k))  = b[i, j]
  sym term    S(x)[p, v]    = interp(x, g1.v) - interp(x, g2.v) = 0

  * 2D pixel (row j, column i) back-projects to the ray
    (x, y, z) = (-s.kc, s.jc - dy, s.ic), kc the ray parameter, turned by
    the inverse of the (tilt, psi) rotation;
  * per projection copy t = (h, c): rotate about z by
    -(twist.h + 360.c/csym), then z -= h.rise;
  * per symmetry op g = (h, c): rotate about z by +(twist.h + 360.c/csym),
    then z += h.rise;
  * "nn": round, valid where the voxel is in the volume and the mask;
    "linear": floor, valid where the whole cell is (the cell-valid volume),
    with the trilinear weights (the reference's docstring: the intended
    weights, not the two typo'd corners of the original numba kernel).

The reference's ``PT`` and ``ST`` are ``jax.vjp``s of ``P`` and ``S``;
here they are explicit transposes. The builders take k candidates at
once, each at its own pose (``build_problems``; ``build_problem`` is one):
``P`` and ``PT`` run as one launch of the kernels K1 / K2 on the card
(``gather_kernels``: the amyloid geometry samples 177 copies x 256 x 56 x
56 = 124 M points per application), and as their plain versions on the
CPU, a candidate and a chunk of copies at a time, the transpose an
``index_add_`` of the same samples' weights. The solves apply the data
term as ``PTRP`` = PT(rows * P(x)), one call of ``gather_normal`` on the
card. Coordinates are recomputed in
every application, as in the reference; on the card only for the pose's
live rays, listed once per build, and nn reads them from a table of the
listed rays' samples made with the list. ``S`` and ``ST`` touch pairs x l3
x d3^2 voxels, far fewer: alone they are torch on either device, their
taps computed once per build, the k candidates' in one batch; the solves
apply them as ``STS`` = ST(S(x)), the kernel K4 on the card (on a list of
the symmetry rows that can be nonzero, made at its first call). PT and STS
sum exactly, in 64-bit integers (``gather_kernels``), so the card repeats
a refinement bit for bit. A
nearest-neighbour sample reads the masked volume padded by one zero
voxel: a position outside the volume rounds into the padding, so it needs
no bounds tests (``gather_kernels._Sampler``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import gather_kernels as _gk
from . import projector_separable as _ps

__all__ = ["build_problem", "build_problems", "data_operator", "data_operators", "sym_operator",
           "sym_operators", "rot_yx_inv"]


def rot_yx_inv(tilt_deg, psi_deg, device="cuda") -> torch.Tensor:
    """Transpose of scipy R.from_euler('yx', (tilt, psi)) as a (3, 3)
    float32 tensor: Ry(-tilt) @ Rx(-psi), each entry the one nonzero
    product of the reference's 3 x 3 float32 matmul."""
    return _gk.rotations([float(tilt_deg)], [float(psi_deg)], device)[0]


def data_operators(
    geom,
    twists,
    rises_pixel,
    copies_h,
    copies_c,
    copies_valid,
    tilt_degree=0.0,
    psi_degree=0.0,
    dy_pixel=0.0,
    interpolation: str = "nn",
    mask_flat=None,
    cellok_flat=None,
):
    """Projection operator P, its transpose PT and the row validity of k
    candidates (twists, rises_pixel (k,), copies (k, C)), each at its own
    pose (tilt, psi, dy: a number or (k,)). mask_flat / cellok_flat:
    float32 tensors (l3*d3*d3,) on the operators' device: CUDA runs the
    kernels K1 / K2 (``gather_kernels``) on the list of the pose's live
    rays, built here once, the CPU their plain versions.

    Returns (P, PT, PTRP, row_valid): P(x (k, l3, d3, d3)) -> pred (k, C,
    l2, d2); PT(r (k, C, l2, d2)) -> (k, l3, d3, d3); PTRP(x, rows (k, C,
    l2, d2)) -> PT(rows * P(x)), gather_normal (one call on the card);
    row_valid (k, C, l2, d2) bool, True where the ray hits >= 1 valid voxel
    and the copy slot is populated."""
    tab = _gk.gather_tables(geom, twists, rises_pixel, copies_h, copies_c, copies_valid,
                            tilt_degree, psi_degree, dy_pixel, interpolation, mask_flat,
                            cellok_flat)
    _, row_valid = _gk.gather_project(tab, None, row_valid=True)
    if row_valid.is_cuda:
        tab = _gk.with_live_rays(tab, row_valid)
    return (lambda x_vol: _gk.gather_project(tab, x_vol),
            lambda r: _gk.gather_backproject(tab, r),
            lambda x_vol, rows: _gk.gather_normal(tab, x_vol, rows), row_valid)


def data_operator(
    geom,
    twist_degree,
    rise_pixel,
    copies_h,
    copies_c,
    copies_valid,
    tilt_degree=0.0,
    psi_degree=0.0,
    dy_pixel=0.0,
    interpolation: str = "nn",
    mask_flat=None,
    cellok_flat=None,
):
    """Projection operator P, its transpose PT and the row validity for
    one candidate (data_operators for one). mask_flat / cellok_flat:
    float32 tensors (l3*d3*d3,) on the operators' device.

    Returns (P, PT, PTRP, row_valid): P(x (l3, d3, d3)) -> pred (C, l2,
    d2); PT(r (C, l2, d2)) -> (l3, d3, d3); PTRP(x, rows (C, l2, d2)) ->
    PT(rows * P(x)); row_valid (C, l2, d2) bool."""
    P, PT, PTRP, row_valid = data_operators(
        geom, [twist_degree], [rise_pixel], _ps._lead(copies_h), _ps._lead(copies_c),
        _ps._lead(copies_valid), tilt_degree, psi_degree, dy_pixel, interpolation, mask_flat,
        cellok_flat)
    return (lambda x_vol: P(x_vol[None])[0], lambda r: PT(r[None])[0],
            lambda x_vol, rows: PTRP(x_vol[None], rows[None])[0], row_valid[0])


def sym_operators(
    geom,
    twists,
    rises_pixel,
    pairs_hc,
    pairs_valid,
    interpolation: str = "nn",
    mask_flat=None,
    cellok_flat=None,
    sym_keep=None,
    with_normal: bool = False,
):
    """Symmetry-constraint operator S and its transpose ST of k candidates
    (twists, rises_pixel (k,), pairs_hc (k, P, 4), pairs_valid (k, P)), in
    torch on either device. S(x (k, l3, d3, d3)) -> residuals (k, P, l3,
    d3, d3): interp at g1.v minus interp at g2.v per voxel v, zero where
    either side leaves the mask, where v is unmasked, where the pair slot
    is padding, or (with sym_keep (k, P, l3, d3, d3) bool) where the row is
    a duplicate. The taps are computed once, at the first S or ST.
    with_normal: also STS, x -> ST(S(x)) summed exactly, the kernel K4 on
    the card (``gather_kernels.sym_normal``), its plain version on the
    CPU."""
    st = _gk.sym_tables(geom, twists, rises_pixel, pairs_hc, pairs_valid, interpolation,
                        mask_flat, cellok_flat, sym_keep)
    sampler = st.sampler()
    k = st.shape[0]

    def S(x_vol):
        taps1, taps2, valid = st.taps()
        xf = sampler.source(x_vol)
        return (_gk._gather(xf, taps1) - _gk._gather(xf, taps2)) * valid

    def ST(r):
        taps1, taps2, valid = st.taps()
        out = sampler.zeros(mask_flat.device, k)
        rv = r * valid
        _gk._scatter(out, taps1, rv)
        _gk._scatter(out, taps2, -rv)
        return sampler.result(out, k)

    if with_normal:
        return S, ST, lambda x_vol: _gk.sym_normal(st, x_vol)
    return S, ST


def sym_operator(
    geom,
    twist_degree,
    rise_pixel,
    pairs_hc,
    pairs_valid,
    interpolation: str = "nn",
    mask_flat=None,
    cellok_flat=None,
    sym_keep=None,
):
    """Symmetry-constraint operator S and its transpose ST for one
    candidate (sym_operators for one): S(x (l3, d3, d3)) -> residuals
    (n_pairs, l3, d3, d3); sym_keep (P, l3, d3, d3) bool."""
    S, ST = sym_operators(geom, [twist_degree], [rise_pixel], _ps._lead(pairs_hc),
                          _ps._lead(pairs_valid), interpolation, mask_flat, cellok_flat,
                          None if sym_keep is None else _ps._lead(sym_keep))
    return lambda x_vol: S(x_vol[None])[0], lambda r: ST(r[None])[0]


def build_problems(
    geom,
    image_region,
    twists,
    rises_pixel,
    copies_h,
    copies_c,
    copies_valid,
    pairs_hc,
    pairs_valid,
    tilt_degree=0.0,
    psi_degree=0.0,
    dy_pixel=0.0,
    interpolation: str = "nn",
    mask=None,
    cellok=None,
    sym_keep=None,
    device="cuda",
):
    """Assemble (P, PT, PTRP, S, ST, STS, b, row_valid, mask) for k
    candidates on ``device``, each at its own pose (tilt, psi, dy: a number
    or (k,)); tables carry a leading candidate axis. P maps (k, l3, d3, d3)
    to (k, C, l2, d2), S to (k, P, l3, d3, d3); PTRP(x, rows) is PT(rows *
    P(x)), one call of gather_normal on the card, and STS is ST(S(x)), one
    call of K4. image_region: (d2, l2) pixel values
    (rows j, columns i); b[i, j] = region[j, i]."""
    dev = torch.device(device)
    mask_flat = _ps._as(np.asarray(mask, np.float32).reshape(-1), dev)
    cellok_flat = _ps._as(np.asarray(cellok, np.float32).reshape(-1), dev)
    P, PT, PTRP, row_valid = data_operators(
        geom, twists, rises_pixel, copies_h, copies_c, copies_valid, tilt_degree, psi_degree,
        dy_pixel, interpolation, mask_flat, cellok_flat,
    )
    S, ST, STS = sym_operators(geom, twists, rises_pixel, pairs_hc, pairs_valid, interpolation,
                               mask_flat, cellok_flat, sym_keep=sym_keep, with_normal=True)
    return dict(
        P=P,
        PT=PT,
        PTRP=PTRP,
        S=S,
        ST=ST,
        STS=STS,
        b=_ps._as(image_region, dev, torch.float32).T,
        row_valid=row_valid,
        mask=mask_flat.reshape(geom.volume_shape) > 0.5,
    )


def build_problem(
    geom,
    image_region,
    twist_degree,
    rise_pixel,
    copies_h,
    copies_c,
    copies_valid,
    pairs_hc,
    pairs_valid,
    tilt_degree=0.0,
    psi_degree=0.0,
    dy_pixel=0.0,
    interpolation: str = "nn",
    mask=None,
    cellok=None,
    sym_keep=None,
    device="cuda",
):
    """Assemble (P, PT, PTRP, S, ST, STS, b, row_valid, mask) for one
    candidate on ``device`` (build_problems for one). image_region: (d2, l2) pixel
    values (rows j, columns i); b[i, j] = region[j, i]."""
    ops = build_problems(
        geom, image_region, [twist_degree], [rise_pixel],
        *(_ps._lead(t) for t in (copies_h, copies_c, copies_valid, pairs_hc, pairs_valid)),
        tilt_degree, psi_degree, dy_pixel, interpolation, mask, cellok,
        None if sym_keep is None else _ps._lead(sym_keep), device)
    one = {k: (lambda f: lambda a: f(a[None])[0])(ops[k]) for k in ("P", "PT", "S", "ST", "STS")}
    one["PTRP"] = lambda x_vol, rows: ops["PTRP"](x_vol[None], rows[None])[0]
    return dict(ops, **one, row_valid=ops["row_valid"][0])
