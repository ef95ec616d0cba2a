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
here they are explicit transposes: ``index_add_`` of the same samples'
weights. The per-copy work runs in chunks of copies
(``_CHUNK_SAMPLES`` samples at most), so one candidate's samples are
never resident at once: the amyloid geometry samples 196 copies x 256 x
56 x 56 = 157 M points per application. Coordinates are recomputed in
every application, as in the reference. A nearest-neighbour sample reads
the masked volume padded by one zero voxel: a position outside the
volume rounds into the padding, so it needs no bounds tests
(``_Sampler``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import projector_separable as _ps

__all__ = ["build_problem", "data_operator", "sym_operator", "rot_yx_inv"]

# samples (copies x l2 x d2 x d2) one chunk of P or PT holds at most
_CHUNK_SAMPLES = 1 << 25


def rot_yx_inv(tilt_deg, psi_deg, device="cpu") -> torch.Tensor:
    """Transpose of scipy R.from_euler('yx', (tilt, psi)) as a (3, 3)
    float32 tensor: Ry(-tilt) @ Rx(-psi), each entry the one nonzero
    product of the reference's 3 x 3 float32 matmul."""
    ang = torch.deg2rad(torch.tensor([float(tilt_deg), float(psi_deg)], dtype=torch.float32,
                                     device=device))
    c, s = _ps.cos_sin(ang)
    ct, cp, st, sp = c[0], c[1], s[0], s[1]
    zero = torch.zeros_like(ct)
    return torch.stack([
        torch.stack([ct, st * sp, -(st * cp)]),
        torch.stack([zero, cp, sp]),
        torch.stack([st, -(ct * sp), ct * cp]),
    ])


class _Sampler:
    """Where the samples of one interpolation read the volume and write its
    transpose. nn: the flat index, into the masked volume padded by one
    zero voxel on every side, of each sample's rounded position clamped
    into that padding, so that a sample outside the volume or the mask
    reads zero with no bounds tests. linear: the eight corners of each
    sample's cell in the volume itself, weighted by the trilinear weights
    times the cell's validity (bounds and the cell-valid volume)."""

    def __init__(self, interpolation, mask_flat, cellok_flat, d3: int, l3: int):
        self.linear = interpolation.startswith("linear")
        self.d3, self.l3 = d3, l3
        self.in_mask = mask_flat > 0.5
        self.cellok = cellok_flat
        self.in_mask_pad = torch.nn.functional.pad(
            self.in_mask.reshape(l3, d3, d3), (1, 1, 1, 1, 1, 1)).reshape(-1)

    def taps(self, Z, Y, X):
        """The samples at (Z, Y, X) as taps [(flat index, weight or None)]
        and their validity."""
        d3, l3 = self.d3, self.l3
        if not self.linear:
            D = d3 + 2
            # float32 arithmetic, exact for these small integers
            z = torch.round(Z).clamp_(-1, l3)
            y = torch.round(Y).clamp_(-1, d3)
            x = torch.round(X).clamp_(-1, d3)
            idx = (z.mul_(D) + y).mul_(D).add_(x).add_(D * D + D + 1).to(torch.int64)
            return [(idx, None)], self.in_mask_pad[idx]
        zf, yf, xf = torch.floor(Z), torch.floor(Y), torch.floor(X)
        zi, yi, xi = zf.to(torch.int64), yf.to(torch.int64), xf.to(torch.int64)
        inb = ((zi >= 0) & (zi <= l3 - 2) & (yi >= 0) & (yi <= d3 - 2)
               & (xi >= 0) & (xi <= d3 - 2))
        ok = self.cellok[(zi.clamp(0, l3 - 1) * d3 + yi.clamp(0, d3 - 1)) * d3
                         + xi.clamp(0, d3 - 1)]
        valid = inb & (ok > 0.5)
        vf = valid.to(torch.float32)
        wz, wy, wx = Z - zf, Y - yf, X - xf
        uz, uy, ux = 1 - wz, 1 - wy, 1 - wx
        base = (zi.clamp(0, l3 - 2) * d3 + yi.clamp(0, d3 - 2)) * d3 + xi.clamp(0, d3 - 2)
        dzs = d3 * d3
        # the reference's order of the eight trilinear terms
        return [(base + off, a * b * c * vf) for off, (a, b, c) in (
            (0, (uz, uy, ux)), (1, (uz, uy, wx)), (d3, (uz, wy, ux)), (d3 + 1, (uz, wy, wx)),
            (dzs, (wz, uy, ux)), (dzs + 1, (wz, uy, wx)), (dzs + d3, (wz, wy, ux)),
            (dzs + d3 + 1, (wz, wy, wx)),
        )], valid

    def source(self, x_vol):
        """The flat volume the taps read."""
        if self.linear:
            return x_vol.reshape(-1)
        x = (x_vol.reshape(-1) * self.in_mask).reshape(self.l3, self.d3, self.d3)
        return torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1)).reshape(-1)

    def zeros(self, device):
        """A flat buffer the transposes add into."""
        d3, l3 = self.d3, self.l3
        n = l3 * d3 * d3 if self.linear else (l3 + 2) * (d3 + 2) ** 2
        return torch.zeros(n, dtype=torch.float32, device=device)

    def result(self, out):
        """The volume (l3, d3, d3) of a buffer from zeros()."""
        d3, l3 = self.d3, self.l3
        if self.linear:
            return out.reshape(l3, d3, d3)
        return (out.reshape(l3 + 2, d3 + 2, d3 + 2)[1:-1, 1:-1, 1:-1]
                * self.in_mask.reshape(l3, d3, d3))


def _gather(x_flat, taps):
    """Sum over the taps of weight * x at the index."""
    val = None
    for idx, w in taps:
        t = x_flat[idx] if w is None else w * x_flat[idx]
        val = t if val is None else val + t
    return val


def _scatter(out_flat, taps, r) -> None:
    """out_flat[idx] += weight * r for every tap (r broadcast to the
    taps' shape): the transpose of _gather."""
    for idx, w in taps:
        v = r.expand(idx.shape) if w is None else w * r
        out_flat.index_add_(0, idx.reshape(-1), v.reshape(-1))


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
    one candidate. mask_flat / cellok_flat: float32 tensors (l3*d3*d3,) on
    the operators' device.

    Returns (P, PT, row_valid): P(x (l3, d3, d3)) -> pred (C, l2, d2);
    PT(r (C, l2, d2)) -> (l3, d3, d3); row_valid (C, l2, d2) bool, True
    where the ray hits >= 1 valid voxel and the copy slot is populated."""
    d2, l2, d3, l3 = geom.d2, geom.l2, geom.d3, geom.l3
    s = geom.scale2d_to_3d
    dev = mask_flat.device
    sampler = _Sampler(interpolation, mask_flat, cellok_flat, d3, l3)
    f32 = dict(dtype=torch.float32, device=dev)

    ic = (torch.arange(l2, **f32) - l2 // 2)[:, None, None]
    jc = (torch.arange(d2, **f32) - d2 // 2)[None, :, None]
    kc = (torch.arange(d2, **f32) - d2 // 2)[None, None, :]
    shape = (l2, d2, d2)
    x0 = (-s * kc).expand(shape)
    y0 = (s * jc).expand(shape) - _ps._as(dy_pixel, dev, torch.float32)
    z0 = (s * ic).expand(shape)
    R = rot_yx_inv(tilt_degree, psi_degree, dev)
    bx = R[0, 0] * x0 + R[0, 1] * y0 + R[0, 2] * z0
    by = R[1, 0] * x0 + R[1, 1] * y0 + R[1, 2] * z0
    bz = R[2, 0] * x0 + R[2, 1] * y0 + R[2, 2] * z0

    ch = _ps._as(copies_h, dev)
    cvf = _ps._as(copies_valid, dev, torch.float32)
    theta = _ps._op_angles(_ps._as(twist_degree, dev, torch.float32), ch,
                           _ps._as(copies_c, dev), geom.csym)
    dz = ch.float() * _ps._as(rise_pixel, dev, torch.float32)
    cos_t, sin_t = _ps.cos_sin(theta)
    n_copies = theta.shape[0]
    # a linear sample holds eight taps
    step = max(1, _CHUNK_SAMPLES // ((8 if sampler.linear else 1) * l2 * d2 * d2))

    def chunks():
        """(copy slice, taps, valid) of each chunk of copies."""
        for a in range(0, n_copies, step):
            sl = slice(a, min(a + step, n_copies))
            c = cos_t[sl, None, None, None]
            sn = sin_t[sl, None, None, None]
            # inverse z-rotation: (x, y) -> (x c + y s, -x s + y c), in the
            # reference's order of float32 operations
            X = (bx * c + by * sn) + d3 // 2
            Y = (by * c - bx * sn) + d3 // 2
            Z = (bz - dz[sl, None, None, None]) + l3 // 2
            yield (sl, *sampler.taps(Z, Y, X))

    row_valid = torch.empty((n_copies, l2, d2), dtype=torch.bool, device=dev)
    for sl, _, valid in chunks():
        row_valid[sl] = valid.any(dim=3) & (cvf[sl, None, None] > 0)

    def P(x_vol):
        xf = sampler.source(x_vol)
        pred = torch.empty((n_copies, l2, d2), **f32)
        for sl, taps, _ in chunks():
            pred[sl] = _gather(xf, taps).sum(dim=3) * cvf[sl, None, None]
        return pred

    def PT(r):
        out = sampler.zeros(dev)
        for sl, taps, _ in chunks():
            _scatter(out, taps, (r[sl] * cvf[sl, None, None])[..., None])
        return sampler.result(out)

    return P, PT, row_valid


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
    candidate. S(x) -> residuals (n_pairs, l3, d3, d3): interp at g1.v
    minus interp at g2.v per voxel v, zero where either side leaves the
    mask, where v is unmasked, where the pair slot is padding, or (with
    sym_keep (P, l3, d3, d3) bool) where the row is a duplicate."""
    d3, l3 = geom.d3, geom.l3
    dev = mask_flat.device
    sampler = _Sampler(interpolation, mask_flat, cellok_flat, d3, l3)
    f32 = dict(dtype=torch.float32, device=dev)
    voxel_in_mask = mask_flat.reshape(l3, d3, d3) > 0.5
    zc = (torch.arange(l3, **f32) - l3 // 2)[:, None, None]
    yc = (torch.arange(d3, **f32) - d3 // 2)[None, :, None]
    xc = (torch.arange(d3, **f32) - d3 // 2)[None, None, :]
    twist = _ps._as(twist_degree, dev, torch.float32)
    rise = _ps._as(rise_pixel, dev, torch.float32)
    phc = _ps._as(pairs_hc, dev)
    keep = voxel_in_mask[None] & _ps._as(pairs_valid, dev, torch.bool)[:, None, None, None]
    if sym_keep is not None:
        keep = keep & _ps._as(sym_keep, dev, torch.bool)

    def op_taps(h, c):
        # forward z-rotation: (x, y) -> (x c - y s, x s + y c)
        cs, sn = _ps.cos_sin(_ps._op_angles(twist, h, c, geom.csym))
        cs, sn = cs[:, None, None, None], sn[:, None, None, None]
        X = (xc * cs - yc * sn) + d3 // 2
        Y = (xc * sn + yc * cs) + d3 // 2
        Z = (zc + h.float()[:, None, None, None] * rise) + l3 // 2
        return sampler.taps(Z, Y, X)

    taps1, ok1 = op_taps(phc[:, 0], phc[:, 1])
    taps2, ok2 = op_taps(phc[:, 2], phc[:, 3])
    valid = (ok1 & ok2 & keep).to(torch.float32)

    def S(x_vol):
        xf = sampler.source(x_vol)
        return (_gather(xf, taps1) - _gather(xf, taps2)) * valid

    def ST(r):
        out = sampler.zeros(dev)
        rv = r * valid
        _scatter(out, taps1, rv)
        _scatter(out, taps2, -rv)
        return sampler.result(out)

    return S, ST


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
    """Assemble (P, PT, S, ST, b, row_valid, mask) for one candidate on
    ``device``. image_region: (d2, l2) pixel values (rows j, columns i);
    b[i, j] = region[j, i]."""
    dev = torch.device(device)
    mask_flat = _ps._as(np.asarray(mask, np.float32).reshape(-1), dev)
    cellok_flat = _ps._as(np.asarray(cellok, np.float32).reshape(-1), dev)
    P, PT, row_valid = data_operator(
        geom, twist_degree, rise_pixel, copies_h, copies_c, copies_valid, tilt_degree,
        psi_degree, dy_pixel, interpolation, mask_flat, cellok_flat,
    )
    S, ST = sym_operator(geom, twist_degree, rise_pixel, pairs_hc, pairs_valid, interpolation,
                         mask_flat, cellok_flat, sym_keep=sym_keep)
    return dict(
        P=P,
        PT=PT,
        S=S,
        ST=ST,
        b=_ps._as(image_region, dev, torch.float32).T,
        row_valid=row_valid,
        mask=mask_flat.reshape(geom.volume_shape) > 0.5,
    )
