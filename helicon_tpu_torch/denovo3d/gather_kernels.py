"""The gather projector's kernels (K1, K2, K4) and refinement's pose Jacobian (K3).

No Pallas kernel stands behind these: they replace the XLA gathers of
``helicon_tpu/denovo3d/projector.py`` (``data_operator``'s P :153-228 and
its ``jax.vjp`` PT, ``sym_operator``'s S and ST) and the ``jax.jacfwd`` of
``refine.py::_gn_step`` (:50-94). Each takes a leading axis of k
candidates, each with its own pose, so that one launch serves a
per-candidate batch or a refinement batch:

    gather_project      (K1)  P: pred (k, C, l2, d2), optionally row_valid
    gather_backproject  (K2)  PT: (k, l3, d3, d3)
    pose_jacobian       (K3)  J^T J (k, 3, 3), J^T r (k, 3), r^T r (k,) of
                              the linear residual (P(x) - b) * row_valid by
                              (tilt, psi, dy), J never stored
    sym_normal          (K4)  ST(S(x)) (k, l3, d3, d3): the symmetry term
                              of the normal operator

The transposes (K2, K4 and their plain versions) sum exactly: each term is
rounded to a 64-bit integer at a power of two per candidate
(``fixed_scales``), the integers are added, and the sum is turned back into
float32 once. Integer sums do not depend on their order, so the kernels'
atomics repeat bit for bit from run to run and equal their plain versions'
``index_add_``; a refinement's Gauss-Newton steps would amplify float
atomics' run-to-run rounding into other poses.

CPU tensors take the plain PyTorch versions (``*_reference``: the
sampler ``_Sampler``, a candidate and a chunk of copies at a time); CUDA
tensors take the kernels of ``csrc/gather_projector.cu`` or raise. The
kernels skip the rays that cannot hold a valid sample (a padded copy
slot, or no sample inside the volume's z range), which the plain versions
compute and find invalid. Every table the kernels read (rotation, copy angles, ray
coordinates) is computed here once in torch, so that kernel and plain
version round the same inputs (ROADMAP C11); the kernels' coordinate
arithmetic is unfused, in the plain version's order, so that each
nearest-neighbour sample lands on the same voxel (C6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import projector_separable as _ps

__all__ = ["GatherTables", "gather_tables", "with_live_rays", "rotations", "gather_project",
           "gather_project_reference", "gather_backproject", "gather_backproject_reference",
           "pose_jacobian", "pose_jacobian_reference", "SymTables", "sym_tables", "sym_normal",
           "sym_normal_reference", "fixed_scales", "launches"]

# kernel launches made on CUDA tensors, by entry (one kernel a call)
launches = {"gather_project": 0, "gather_backproject": 0, "pose_jacobian": 0, "sym_normal": 0}

# shared memory a block may stage the volume in (its float32 values and a
# validity byte a voxel); past it the kernels read device memory
SMEM_LIMIT = 200 * 1024

# samples (copies x l2 x d2 x d2) one chunk of the plain versions holds at most
_CHUNK_SAMPLES = 1 << 25

# the transposes' integer sums stay below 2^FIXED_BITS (int64 holds 2^63)
FIXED_BITS = 61

# the blocks a candidate of K3 takes at most (gather_projector.cu's
# MAX_BLOCKS): the rows of its scratch
_K3_MAX_BLOCKS = 1024

# d(deg2rad(a)) / da in float32, the factor jax.jacfwd carries into the
# rotation's derivatives
_DEG = np.float32(np.pi / 180)


class _Sampler:
    """Where the samples of one interpolation read the volume and write its
    transpose. nn: the flat index, into the masked volume padded by one
    zero voxel on every side, of each sample's rounded position clamped
    into that padding, so that a sample outside the volume or the mask
    reads zero with no bounds tests. linear: the eight corners of each
    sample's cell in the volume itself, weighted by the trilinear weights
    times the cell's validity (bounds and the cell-valid volume). Volumes
    may carry a leading batch axis: ``size`` elements a volume."""

    def __init__(self, interpolation, mask_flat, cellok_flat, d3: int, l3: int):
        self.linear = interpolation.startswith("linear")
        self.d3, self.l3 = d3, l3
        self.in_mask = mask_flat > 0.5
        self.cellok = cellok_flat
        self.in_mask_pad = torch.nn.functional.pad(
            self.in_mask.reshape(l3, d3, d3), (1, 1, 1, 1, 1, 1)).reshape(-1)
        self.size = l3 * d3 * d3 if self.linear else (l3 + 2) * (d3 + 2) ** 2

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
        """The flat volumes (x_vol (..., l3, d3, d3)) the taps read."""
        if self.linear:
            return x_vol.reshape(-1)
        d3, l3 = self.d3, self.l3
        x = x_vol.reshape(-1, l3 * d3 * d3) * self.in_mask
        return torch.nn.functional.pad(x.reshape(-1, l3, d3, d3), (1, 1, 1, 1, 1, 1)).reshape(-1)

    def zeros(self, device, k: int = 1):
        """A flat buffer of k volumes the transposes add into."""
        return torch.zeros(k * self.size, dtype=torch.float32, device=device)

    def result(self, out, k: int = 1):
        """The volumes (k, l3, d3, d3) of a buffer from zeros()."""
        d3, l3 = self.d3, self.l3
        if self.linear:
            return out.reshape(k, l3, d3, d3)
        return (out.reshape(k, l3 + 2, d3 + 2, d3 + 2)[:, 1:-1, 1:-1, 1:-1]
                * self.in_mask.reshape(l3, d3, d3))


def _gather(x_flat, taps):
    """Sum over the taps of weight * x at the index."""
    val = None
    for idx, w in taps:
        t = x_flat[idx] if w is None else w * x_flat[idx]
        val = t if val is None else val + t
    return val


def _ray_sum(v):
    """The sum over the last axis (the d2 samples of each ray) in K1's
    order, so that the plain version and the kernel give the same bits:
    lane l of a warp adds samples l, l + 32, ... to zero in turn, then the
    32 lanes' sums meet by the butterfly of xor shuffles (16, 8, 4, 2, 1);
    lane 0 holds the result. Zeros stand for the samples past d2, which
    leave a sum unchanged."""
    d2 = v.shape[-1]
    n = -(-d2 // 32)
    v = torch.nn.functional.pad(v, (0, 32 * n - d2)).reshape(v.shape[:-1] + (n, 32))
    acc = torch.zeros(v.shape[:-2] + (32,), dtype=v.dtype, device=v.device)
    for c in range(n):
        acc = acc + v[..., c, :]
    lanes = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def _scatter(out_flat, taps, r) -> None:
    """out_flat[idx] += weight * r for every tap (r broadcast to the
    taps' shape): the transpose of _gather."""
    for idx, w in taps:
        v = r.expand(idx.shape) if w is None else w * r
        out_flat.index_add_(0, idx.reshape(-1), v.reshape(-1))


def fixed_scales(amax, n_terms: int) -> torch.Tensor:
    """The power of two (k,) float64 at which n_terms terms of at most
    amax (k,) each sum below 2^FIXED_BITS once rounded to integers (NaN
    where amax is not finite, so that the result is NaN). Built from its
    bits, so that it is the same on every device; the kernels' C entries
    compute the same (gather_projector.cu's scale_of)."""
    bound = amax.double() * float(n_terms)
    _, e = torch.frexp(bound)
    scale = ((1023 + FIXED_BITS - e.to(torch.int64)) << 52).view(torch.float64)
    return torch.where(torch.isfinite(bound), scale, torch.full_like(bound, float("nan")))


def _to_fixed(t, scale) -> torch.Tensor:
    """The terms t as the integers round(t * scale), half to even as the
    kernels' __double2ll_rn."""
    return torch.round(t.double() * scale).to(torch.int64)


def _from_fixed(acc, scale) -> torch.Tensor:
    """float32 of the integer sums acc at scale, as the kernels' last
    block: double(acc) / scale."""
    return (acc.double() / scale).float()


def _scatter_fixed(acc, taps, r, scale) -> None:
    """acc[idx] += the integer of weight * r for every tap (r broadcast to
    the taps' shape): _scatter's sums, exact."""
    for idx, w in taps:
        v = r.expand(idx.shape) if w is None else w * r
        acc.index_add_(0, idx.reshape(-1), _to_fixed(v.reshape(-1), scale))


def rotations(tilt_deg, psi_deg, device="cpu", derivatives: bool = False):
    """The transpose of scipy R.from_euler('yx', (tilt, psi)) for k poses
    (tilt_deg, psi_deg (k,)) as (k, 3, 3) float32: Ry(-tilt) @ Rx(-psi),
    each entry the one nonzero product of the reference's 3 x 3 float32
    matmul. With derivatives, also its derivatives by tilt and by psi in
    degrees (k, 2, 3, 3), pi/180 inside, as jax.jacfwd carries it."""
    ang = torch.deg2rad(torch.stack([_ps._as(np.atleast_1d(np.asarray(a, np.float32)), device,
                                             torch.float32) for a in (tilt_deg, psi_deg)], 1))
    c, s = _ps.cos_sin(ang)
    ct, cp, st, sp = c[:, 0], c[:, 1], s[:, 0], s[:, 1]
    z = torch.zeros_like(ct)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=1) for r in rows], dim=1)

    R = mat([(ct, st * sp, -(st * cp)), (z, cp, sp), (st, -(ct * sp), ct * cp)])
    if not derivatives:
        return R
    dt = mat([(-st, ct * sp, -(ct * cp)), (z, z, z), (ct, st * sp, -(st * cp))])
    dp = mat([(z, st * cp, st * sp), (z, -sp, cp), (z, -(ct * cp), -(ct * sp))])
    return R, torch.stack([dt, dp], dim=1) * _DEG


@dataclasses.dataclass
class GatherTables:
    """The sampling tables of k candidates' data operators (float32 on one
    device): R (k, 3, 3) the inverse pose rotations and dR (k, 2, 3, 3)
    their derivatives by tilt and psi (None unless asked for); cs, sn, dz,
    cvf (k, C) each copy's in-plane cos and sin, z shift (h * rise) and
    slot validity; x0 (d2,) the ray parameter's x, y0 (k, d2) each column's
    y less dy, z0 (l2,) each row's z; mask and cellok (l3*d3*d3,) the
    cylindrical mask and the cell-valid volume."""

    R: torch.Tensor
    dR: torch.Tensor | None
    cs: torch.Tensor
    sn: torch.Tensor
    dz: torch.Tensor
    cvf: torch.Tensor
    x0: torch.Tensor
    y0: torch.Tensor
    z0: torch.Tensor
    mask: torch.Tensor
    cellok: torch.Tensor
    d2: int
    l2: int
    d3: int
    l3: int
    linear: bool
    # the live rays (with_live_rays): candidate q's are ridx[rptr[q] ..
    # rptr[q + 1]] (int32), n_max the most of any candidate
    rptr: torch.Tensor | None = None
    ridx: torch.Tensor | None = None
    n_max: int = 0
    # the kernels' validity bytes (aux > 0.5), made once with the tables
    ok: torch.Tensor | None = None

    @property
    def shape(self):
        """(k, C, l2, d2): the rays."""
        return tuple(self.cs.shape) + (self.l2, self.d2)

    @property
    def aux(self) -> torch.Tensor:
        """The volume whose > 0.5 voxels make a sample valid."""
        return self.cellok if self.linear else self.mask

    def sampler(self) -> _Sampler:
        return _Sampler("linear" if self.linear else "nn", self.mask, self.cellok, self.d3,
                        self.l3)


def _per(a, k: int) -> np.ndarray:
    """A value per candidate (k,) float32 from a number or k numbers."""
    return np.broadcast_to(np.asarray(a, np.float32).reshape(-1), (k,)).copy()


def gather_tables(geom, twists, rises_pixel, copies_h, copies_c, copies_valid, tilt_degree,
                  psi_degree, dy_pixel, interpolation, mask_flat, cellok_flat,
                  derivatives: bool = False) -> GatherTables:
    """The tables of k candidates' data operators: twists, rises_pixel (k,),
    copies (k, C), one pose each (tilt, psi, dy: a number or (k,)), on
    mask_flat's device. With derivatives, dR for pose_jacobian. Every
    value is the one the per-candidate plain arithmetic computes. K1 and
    K2 test every ray on these; with_live_rays adds the list of the rays
    that hold a valid sample, which they then take alone."""
    dev = mask_flat.device
    f32 = dict(dtype=torch.float32, device=dev)
    ch = _ps._as(copies_h, dev)
    if ch.dim() == 1:
        ch = ch[None]
    k = ch.shape[0]
    cc = _ps._as(copies_c, dev).reshape(ch.shape)
    cvf = _ps._as(copies_valid, dev, torch.float32).reshape(ch.shape)
    tw = _ps._as(_per(twists, k), dev, torch.float32)[:, None]
    ri = _ps._as(_per(rises_pixel, k), dev, torch.float32)[:, None]
    rot = rotations(_per(tilt_degree, k), _per(psi_degree, k), dev, derivatives)
    R, dR = rot if derivatives else (rot, None)
    theta = _ps._op_angles(tw, ch, cc, geom.csym)
    cs, sn = _ps.cos_sin(theta)
    s = geom.scale2d_to_3d
    d2, l2 = geom.d2, geom.l2
    x0 = -s * (torch.arange(d2, **f32) - d2 // 2)
    y0 = (s * (torch.arange(d2, **f32) - d2 // 2))[None] - _ps._as(_per(dy_pixel, k), dev,
                                                                    torch.float32)[:, None]
    z0 = s * (torch.arange(l2, **f32) - l2 // 2)
    linear = interpolation.startswith("linear")
    return GatherTables(R=R.contiguous(), dR=None if dR is None else dR.contiguous(),
                        cs=cs.contiguous(), sn=sn.contiguous(),
                        dz=(ch.float() * ri).contiguous(), cvf=cvf.contiguous(), x0=x0,
                        y0=y0.contiguous(), z0=z0, mask=mask_flat.float().contiguous(),
                        cellok=cellok_flat.float().contiguous(), d2=d2,
                        l2=l2, d3=geom.d3, l3=geom.l3, linear=linear,
                        ok=((cellok_flat if linear else mask_flat) > 0.5).to(torch.uint8))


def with_live_rays(tab: GatherTables, row_valid) -> GatherTables:
    """tab with the list of its live rays, the rays of row_valid (k, C, l2,
    d2) (K1's validity at this pose): K1 and K2 take those alone, a
    block's share each, where every launch would otherwise test every ray
    (at the amyloid's geometry 3 % of them are live). The engine's
    per-pose sampling tables, at the ray's grain: a table of the valid
    samples would hold 8 bytes (nn) to 36 (linear) each, 16-60 MB a
    candidate there. Built once per pose, with one device-to-host copy (the
    longest list); the plain versions do not read it."""
    k = tab.shape[0]
    flat = row_valid.reshape(k, -1)
    counts = flat.sum(dim=1)
    rptr = torch.zeros(k + 1, dtype=torch.int32, device=flat.device)
    rptr[1:] = torch.cumsum(counts, 0)
    ridx = torch.nonzero(flat)[:, 1].to(torch.int32).contiguous()
    return dataclasses.replace(tab, rptr=rptr, ridx=ridx, n_max=int(counts.max()))


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _base(tab: GatherTables, q: int):
    """Candidate q's rotated ray coordinates (bx, by, bz), broadcast to
    (l2, d2, d2): rows i, columns j, samples along the ray."""
    R = tab.R[q]
    x0, y0, z0 = tab.x0[None, None, :], tab.y0[q][None, :, None], tab.z0[:, None, None]
    return tuple(R[a, 0] * x0 + R[a, 1] * y0 + R[a, 2] * z0 for a in range(3))


def _chunks(tab: GatherTables, q: int, sampler: _Sampler, base=None):
    """(copy slice, (Z, Y, X), taps, valid) of each chunk of candidate q's
    copies, in the reference's order of float32 operations."""
    bx, by, bz = _base(tab, q) if base is None else base
    k, C, l2, d2 = tab.shape
    step = max(1, _CHUNK_SAMPLES // ((8 if sampler.linear else 1) * l2 * d2 * d2))
    for a in range(0, C, step):
        sl = slice(a, min(a + step, C))
        c = tab.cs[q, sl, None, None, None]
        sn = tab.sn[q, sl, None, None, None]
        # inverse z-rotation: (x, y) -> (x c + y s, -x s + y c)
        X = (bx * c + by * sn) + tab.d3 // 2
        Y = (by * c - bx * sn) + tab.d3 // 2
        Z = (bz - tab.dz[q, sl, None, None, None]) + tab.l3 // 2
        yield (sl, (Z, Y, X), *sampler.taps(Z, Y, X))


def gather_project_reference(tab: GatherTables, x=None, row_valid: bool = False):
    """The plain K1: pred (k, C, l2, d2) of the volumes x (k, l3, d3, d3)
    (None: no values), each ray's samples summed in the kernel's order
    (_ray_sum), and with row_valid also the rays' validity (k, C, l2, d2)
    bool: >= 1 valid sample and the copy slot populated."""
    k, C, l2, d2 = tab.shape
    dev = tab.mask.device
    sampler = tab.sampler()
    pred = None if x is None else torch.empty((k, C, l2, d2), dtype=torch.float32, device=dev)
    rowv = torch.empty((k, C, l2, d2), dtype=torch.bool, device=dev) if row_valid else None
    for q in range(k):
        xf = None if x is None else sampler.source(x[q])
        cv = tab.cvf[q]
        for sl, _, taps, valid in _chunks(tab, q, sampler):
            if pred is not None:
                pred[q, sl] = _ray_sum(_gather(xf, taps)) * cv[sl, None, None]
            if rowv is not None:
                rowv[q, sl] = valid.any(dim=3) & (cv[sl, None, None] > 0)
    return (pred, rowv) if row_valid else pred


def gather_backproject_reference(tab: GatherTables, r) -> torch.Tensor:
    """The plain K2: the transpose of K1 applied to r (k, C, l2, d2):
    (k, l3, d3, d3), the int64 index_add_ of each sample's weight times its
    ray's r (the exact sum, module docstring)."""
    k, C, l2, d2 = tab.shape
    sampler = tab.sampler()
    # a sample's weights sum to 1: its terms add up to at most max |r|
    scale = fixed_scales(r.abs().reshape(k, -1).amax(dim=1), C * l2 * d2 * d2)
    out = []
    for q in range(k):
        acc = torch.zeros(sampler.size, dtype=torch.int64, device=r.device)
        cv = tab.cvf[q]
        for sl, _, taps, _ in _chunks(tab, q, sampler):
            _scatter_fixed(acc, taps, (r[q, sl] * cv[sl, None, None])[..., None], scale[q])
        out.append(sampler.result(_from_fixed(acc, scale[q]))[0])
    return torch.stack(out)


def pose_jacobian_reference(tab: GatherTables, x, b):
    """The plain K3 (linear tables with derivatives): for each candidate
    the residual r = (P(x) - b) over the valid rows and its Jacobian J by
    (tilt, psi, dy), each ray's derivative the trilinear gradient at each
    sample dotted with the sample's coordinate derivatives. Returns (J^T J
    (k, 3, 3), J^T r (k, 3), r^T r (k,)) float64."""
    if not tab.linear or tab.dR is None:
        raise ValueError("pose_jacobian needs linear tables with derivatives")
    k, C, l2, d2 = tab.shape
    sampler = tab.sampler()
    dzs = tab.d3 * tab.d3
    f64 = dict(dtype=torch.float64, device=x.device)
    JtJ, Jtr, rtr = torch.zeros((k, 3, 3), **f64), torch.zeros((k, 3), **f64), torch.zeros(k, **f64)
    x0, z0 = tab.x0[None, None, :], tab.z0[:, None, None]
    for q in range(k):
        xf = x[q].reshape(-1)
        y0 = tab.y0[q][None, :, None]
        R = tab.R[q]
        # d(bx, by, bz) / d(tilt, psi), and by dy (y0 moves by -1)
        dbase = [[tab.dR[q, p, a, 0] * x0 + tab.dR[q, p, a, 1] * y0 + tab.dR[q, p, a, 2] * z0
                  for a in range(3)] for p in range(2)]
        dbase.append([-R[0, 1], -R[1, 1], -R[2, 1]])
        for sl, (Z, Y, X), taps, valid in _chunks(tab, q, sampler):
            c = tab.cs[q, sl, None, None, None]
            sn = tab.sn[q, sl, None, None, None]
            vf = valid.to(torch.float32)
            base = taps[0][0]
            v = [xf[base + off] for off in (0, 1, tab.d3, tab.d3 + 1, dzs, dzs + 1,
                                             dzs + tab.d3, dzs + tab.d3 + 1)]
            wz, wy, wx = Z - torch.floor(Z), Y - torch.floor(Y), X - torch.floor(X)
            uz, uy, ux = 1 - wz, 1 - wy, 1 - wx
            c00, c01 = v[0] * ux + v[1] * wx, v[2] * ux + v[3] * wx
            c10, c11 = v[4] * ux + v[5] * wx, v[6] * ux + v[7] * wx
            c0, c1 = c00 * uy + c01 * wy, c10 * uy + c11 * wy
            gZ = (c1 - c0) * vf
            gY = ((c01 - c00) * uz + (c11 - c10) * wz) * vf
            gX = (((v[1] - v[0]) * uy + (v[3] - v[2]) * wy) * uz
                  + ((v[5] - v[4]) * uy + (v[7] - v[6]) * wy) * wz) * vf
            pred = _gather(xf, taps).sum(dim=3)
            J = torch.stack([
                (gX * (dx * c + dy * sn) + gY * (dy * c - dx * sn) + gZ * dz).sum(dim=3)
                for dx, dy, dz in dbase])  # (3, copies, l2, d2)
            rows = (valid.any(dim=3) & (tab.cvf[q, sl, None, None] > 0)).double()
            r = (pred.double() - b.double()[None]) * rows
            J = J.double() * rows
            JtJ[q] += torch.einsum("pcij,qcij->pq", J, J)
            Jtr[q] += torch.einsum("pcij,cij->p", J, r)
            rtr[q] += (r * r).sum()
    return JtJ, Jtr, rtr


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _launcher(key: str, dev: torch.device):
    from .._build import Launcher

    def count(kernels: int) -> None:
        launches[key] += kernels

    return Launcher(dev, count)


def _device_of(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type


def _check(tab: GatherTables, **tensors) -> None:
    """A call's own tensors on the tables' device, contiguous float32 (the
    tables are gather_tables' own, so in that form already)."""
    dev = tab.mask.device
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")


def _args(tab: GatherTables):
    """The tables as the C entries take them, after the validity bytes."""
    return (tab.R, tab.cs, tab.sn, tab.dz, tab.cvf, tab.x0, tab.y0, tab.z0)


def _listed(tab: GatherTables):
    """K1 / K2's list arguments (rptr, ridx) and n_max: null pointers and 0
    without a list."""
    if tab.rptr is None:
        return (None, None), 0
    return (tab.rptr, tab.ridx), tab.n_max


def _volumes(tab: GatherTables, x, name: str):
    k = tab.shape[0]
    vol = (k, tab.l3, tab.d3, tab.d3)
    if tuple(x.shape) != vol:
        raise ValueError(f"{name} must be {vol}, got {tuple(x.shape)}")
    return x.contiguous()


def gather_project(tab: GatherTables, x=None, row_valid: bool = False):
    """K1: pred (k, C, l2, d2) = P(x) of the volumes x (k, l3, d3, d3) (None:
    no values), and with row_valid also the rays' validity (bool; every ray
    tested, the list unused). CPU tensors run the plain version; CUDA
    tensors run the kernel (never the plain version)."""
    if _device_of(tab.mask, "gather_project") == "cpu":
        return gather_project_reference(tab, x, row_valid)
    k, C, l2, d2 = tab.shape
    dev = tab.mask.device
    x = None if x is None else _volumes(tab, x, "x")
    _check(tab, x=x)
    lists, n_max = ((None, None), 0) if row_valid else _listed(tab)
    pred = None if x is None else torch.empty((k, C, l2, d2), dtype=torch.float32, device=dev)
    rowv = torch.empty((k, C, l2, d2), dtype=torch.bool, device=dev) if row_valid else None
    _launcher("gather_project", dev)("hgp_project", x, tab.aux, tab.ok, *_args(tab), *lists,
                                     pred, rowv, k, C, l2, d2, tab.d3, tab.l3, int(tab.linear),
                                     n_max, SMEM_LIMIT)
    return (pred, rowv) if row_valid else pred


def gather_backproject(tab: GatherTables, r) -> torch.Tensor:
    """K2: PT(r) (k, l3, d3, d3) of r (k, C, l2, d2), the transpose of K1,
    summed exactly (the same bits as the plain version). CPU tensors run
    the plain version; CUDA tensors run the kernel (never the plain
    version)."""
    if _device_of(tab.mask, "gather_backproject") == "cpu":
        return gather_backproject_reference(tab, r)
    k, C, l2, d2 = tab.shape
    dev = tab.mask.device
    if tuple(r.shape) != (k, C, l2, d2):
        raise ValueError(f"r must be {(k, C, l2, d2)}, got {tuple(r.shape)}")
    r = r.contiguous()
    _check(tab, r=r)
    vol = (k, tab.l3, tab.d3, tab.d3)
    # scratch the entry zeroes: the max pass's bits, the sums, the counts
    amax, done = torch.empty((2, k), dtype=torch.int32, device=dev)
    accg = torch.empty(vol, dtype=torch.int64, device=dev)
    out = torch.empty(vol, dtype=torch.float32, device=dev)
    lists, n_max = _listed(tab)
    _launcher("gather_backproject", dev)("hgp_backproject", r, tab.ok, *_args(tab), *lists, amax,
                                         accg, done, out, k, C, l2, d2, tab.d3, tab.l3,
                                         int(tab.linear), n_max, SMEM_LIMIT)
    return out


def pose_jacobian(tab: GatherTables, x, b):
    """K3 on linear tables with derivatives: (J^T J (k, 3, 3), J^T r (k, 3),
    r^T r (k,)) float64 of the residual r = P(x) - b (b (l2, d2)) over each
    candidate's valid rows and its Jacobian by (tilt, psi, dy). CPU
    tensors run the plain version; CUDA tensors run the kernel (never the
    plain version)."""
    if not tab.linear or tab.dR is None:
        raise ValueError("pose_jacobian needs linear tables with derivatives")
    if _device_of(tab.mask, "pose_jacobian") == "cpu":
        return pose_jacobian_reference(tab, x, b)
    k, C, l2, d2 = tab.shape
    dev = tab.mask.device
    x = _volumes(tab, x, "x")
    b = b.contiguous()
    if tuple(b.shape) != (l2, d2):
        raise ValueError(f"b must be {(l2, d2)}, got {tuple(b.shape)}")
    _check(tab, x=x, b=b, dR=tab.dR)
    part = torch.empty((k, _K3_MAX_BLOCKS, 10), dtype=torch.float64, device=dev)
    done = torch.zeros(k, dtype=torch.int32, device=dev)
    out = torch.empty((k, 10), dtype=torch.float64, device=dev)
    R, *rest = _args(tab)
    _launcher("pose_jacobian", dev)("hgp_pose_jacobian", x, tab.aux, tab.ok, R, tab.dR, *rest,
                                    b, part, done, out, k, C, l2, d2, tab.d3, tab.l3, SMEM_LIMIT)
    sym = out[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(k, 3, 3)
    return sym, out[:, 6:9], out[:, 9]


# ---------------------------------------------------------------------------
# the symmetry term (K4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SymTables:
    """The symmetry term's tables of k candidates (float32 on one device):
    cs, sn, dz (k, P, 2) each pair's two ops' in-plane cos and sin and z
    shift (h * rise), pv (k, P) the slot's validity (0 / 1), keep (k, P,
    l3, d3, d3) bool or None (the deduplication mask), mask and cellok
    (l3*d3*d3,) the cylindrical mask and the cell-valid volume."""

    cs: torch.Tensor
    sn: torch.Tensor
    dz: torch.Tensor
    pv: torch.Tensor
    keep: torch.Tensor | None
    mask: torch.Tensor
    cellok: torch.Tensor
    d3: int
    l3: int
    linear: bool
    # K4's bytes, made once with the tables: the sampler's validity (aux >
    # 0.5), the voxels in the mask, keep (or None)
    ok: torch.Tensor | None = None
    inmask: torch.Tensor | None = None
    keep_u8: torch.Tensor | None = None
    _taps: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def shape(self):
        """(k, P): the pair slots."""
        return tuple(self.pv.shape)

    def sampler(self) -> _Sampler:
        return _Sampler("linear" if self.linear else "nn", self.mask, self.cellok, self.d3,
                        self.l3)

    def taps(self):
        """(taps1, taps2, valid): each pair's two samples of every voxel as
        taps into the batch's flat buffer (sampler().size a candidate) and
        the float32 validity (k, P, l3, d3, d3) of the pair's row: both
        samples valid, the voxel in the mask, the slot populated, keep set.
        Computed once, on first use."""
        if self._taps is None:
            self._taps = _sym_taps(self)
        return self._taps


def sym_tables(geom, twists, rises_pixel, pairs_hc, pairs_valid, interpolation, mask_flat,
               cellok_flat, sym_keep=None) -> SymTables:
    """The symmetry tables of k candidates: twists, rises_pixel (k,),
    pairs_hc (k, P, 4), pairs_valid (k, P), sym_keep (k, P, l3, d3, d3) bool
    or None, on mask_flat's device."""
    dev = mask_flat.device
    phc = _ps._as(pairs_hc, dev)
    k = phc.shape[0]
    twist = _ps._as(twists, dev, torch.float32).reshape(k)[:, None]
    rise = _ps._as(rises_pixel, dev, torch.float32).reshape(k)[:, None]
    cs, sn, dz = [], [], []
    for h, c in ((phc[..., 0], phc[..., 1]), (phc[..., 2], phc[..., 3])):
        a, b = _ps.cos_sin(_ps._op_angles(twist, h, c, geom.csym))
        cs.append(a)
        sn.append(b)
        dz.append(h.float() * rise)
    keep = None if sym_keep is None else _ps._as(sym_keep, dev, torch.bool).contiguous()
    linear = interpolation.startswith("linear")
    return SymTables(cs=torch.stack(cs, -1).contiguous(), sn=torch.stack(sn, -1).contiguous(),
                     dz=torch.stack(dz, -1).contiguous(),
                     pv=_ps._as(pairs_valid, dev, torch.float32).contiguous(), keep=keep,
                     mask=mask_flat.float().contiguous(),
                     cellok=cellok_flat.float().contiguous(), d3=geom.d3, l3=geom.l3,
                     linear=linear,
                     ok=((cellok_flat if linear else mask_flat) > 0.5).to(torch.uint8),
                     inmask=(mask_flat > 0.5).to(torch.uint8),
                     keep_u8=None if keep is None else keep.to(torch.uint8))


def _sym_taps(st: SymTables):
    """SymTables.taps, in the reference's order of float32 operations."""
    d3, l3 = st.d3, st.l3
    dev = st.mask.device
    sampler = st.sampler()
    f32 = dict(dtype=torch.float32, device=dev)
    zc = (torch.arange(l3, **f32) - l3 // 2)[:, None, None]
    yc = (torch.arange(d3, **f32) - d3 // 2)[None, :, None]
    xc = (torch.arange(d3, **f32) - d3 // 2)[None, None, :]
    k = st.shape[0]
    # candidate q's taps index its own volume in the batch's flat buffer
    offset = (torch.arange(k, device=dev) * sampler.size)[:, None, None, None, None]

    def op_taps(o):
        # forward z-rotation: (x, y) -> (x c - y s, x s + y c)
        cs, sn, dz = (t[..., o][..., None, None, None] for t in (st.cs, st.sn, st.dz))
        X = (xc * cs - yc * sn) + d3 // 2
        Y = (xc * sn + yc * cs) + d3 // 2
        Z = (zc + dz) + l3 // 2
        taps, ok = sampler.taps(Z, Y, X)
        return [(idx + offset, w) for idx, w in taps], ok

    taps1, ok1 = op_taps(0)
    taps2, ok2 = op_taps(1)
    keep = (st.mask.reshape(l3, d3, d3) > 0.5)[None, None] & (st.pv > 0.5)[..., None, None, None]
    if st.keep is not None:
        keep = keep & st.keep
    return taps1, taps2, (ok1 & ok2 & keep).to(torch.float32)


def sym_normal_reference(st: SymTables, x) -> torch.Tensor:
    """The plain K4: ST(S(x)) (k, l3, d3, d3) of the volumes x (k, l3, d3,
    d3): S's rows (the samples' difference times the row's validity) added
    back by an int64 index_add_ (the exact sum, module docstring)."""
    k, P = st.shape
    sampler = st.sampler()
    taps1, taps2, valid = st.taps()
    xf = sampler.source(x)
    rv = (_gather(xf, taps1) - _gather(xf, taps2)) * valid
    # a pair's row is at most 2 max |x|, added back at two samples
    scale = fixed_scales(x.abs().reshape(k, -1).amax(dim=1), 4 * P * st.l3 * st.d3 * st.d3)
    sc = scale[:, None, None, None, None]
    acc = torch.zeros(k * sampler.size, dtype=torch.int64, device=x.device)
    for taps, r in ((taps1, rv), (taps2, -rv)):
        for idx, w in taps:
            v = r if w is None else w * r
            acc.index_add_(0, idx.reshape(-1), _to_fixed(v, sc).reshape(-1))
    return sampler.result(_from_fixed(acc.reshape(k, -1), scale[:, None]), k)


def sym_normal(st: SymTables, x) -> torch.Tensor:
    """K4: ST(S(x)) (k, l3, d3, d3) of the volumes x (k, l3, d3, d3), summed
    exactly (the same bits as the plain version). CPU tensors run the
    plain version; CUDA tensors run the kernel (never the plain
    version)."""
    if _device_of(st.mask, "sym_normal") == "cpu":
        return sym_normal_reference(st, x)
    k, P = st.shape
    dev = st.mask.device
    vol = (k, st.l3, st.d3, st.d3)
    if tuple(x.shape) != vol:
        raise ValueError(f"x must be {vol}, got {tuple(x.shape)}")
    x = x.contiguous()
    if x.device != dev or x.dtype != torch.float32:
        raise ValueError(f"x must be a float32 tensor on {dev}")
    # scratch the entry zeroes: the max pass's bits, the sums, the counts
    amax, done = torch.empty((2, k), dtype=torch.int32, device=dev)
    accg = torch.empty(vol, dtype=torch.int64, device=dev)
    out = torch.empty(vol, dtype=torch.float32, device=dev)
    _launcher("sym_normal", dev)("hgp_sym_normal", x, st.ok, st.cs, st.sn, st.dz, st.pv,
                                 st.keep_u8, st.inmask, amax, accg, done, out, k, P, st.d3, st.l3,
                                 int(st.linear), SMEM_LIMIT)
    return out
