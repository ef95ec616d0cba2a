"""The gather projector's kernels (K1, K2, K4) and refinement's pose Jacobian (K3).

No Pallas kernel stands behind these: they replace the XLA gathers of
``helicon_tpu/denovo3d/projector.py`` (``data_operator``'s P :153-228 and
its ``jax.vjp`` PT, ``sym_operator``'s S and ST) and the ``jax.jacfwd`` of
``refine.py::_gn_step`` (:50-94). Each takes a leading axis of k
candidates, each with its own pose, so that one launch serves a
per-candidate batch or a refinement batch:

    gather_project      (K1)  P: pred (k, C, l2, d2), optionally row_valid
    gather_backproject  (K2)  PT: (k, l3, d3, d3)
    gather_normal             PT(rows * P(x)) (k, l3, d3, d3): the data term
                              of the solver's normal operator, K1 and K2 on
                              the list of live rays in one call
    sample_table              each listed ray's samples' voxels, once a
                              pose, which K1 and K2 then read
    pose_jacobian       (K3)  J^T J (k, 3, 3), J^T r (k, 3), r^T r (k,) of
                              the linear residual (P(x) - b) * row_valid by
                              (tilt, psi, dy), J never stored; on the card
                              on the list of live rays
    sym_items                 K4's item list (sym_list), once a pose: the
                              (pair, voxel) rows of S that can be nonzero
                              and their samples
    sym_normal          (K4)  ST(S(x)) (k, l3, d3, d3): the symmetry term
                              of the normal operator, on the card from the
                              item list and its incidences by output voxel

The transposes (K2, K4 and their plain versions) sum exactly: each term is
rounded to a 64-bit integer at a power of two per candidate
(``fixed_scales``), the integers are added, and the sum is turned back into
float32 once. Integer sums do not depend on their order, so the kernels'
atomics repeat bit for bit from run to run and equal their plain versions'
``index_add_``; a refinement's Gauss-Newton steps would amplify float
atomics' run-to-run rounding into other poses. On the card K4 needs no
atomics: each output voxel sums its own incidences.

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
import threading

import numpy as np
import torch

from . import projector_separable as _ps

__all__ = ["GatherTables", "gather_tables", "with_live_rays", "rotations", "gather_project",
           "gather_project_reference", "gather_backproject", "gather_backproject_reference",
           "gather_normal", "gather_normal_reference", "sample_table",
           "sample_table_reference", "launch_grid", "jacobian_grid", "pose_jacobian",
           "pose_jacobian_reference", "SymTables", "sym_tables", "SymList", "sym_list",
           "sym_items", "sym_items_reference", "sym_blocks", "sym_lanes", "sym_normal",
           "sym_normal_reference", "sym_normal_list_reference", "fixed_scales", "launches"]

# kernel launches made on CUDA tensors, by entry (one a call)
launches = {"gather_project": 0, "gather_backproject": 0, "gather_normal": 0,
            "sample_table": 0, "pose_jacobian": 0, "sym_items": 0, "sym_normal": 0}
_COUNT_LOCK = threading.Lock()

# shared memory a block of K2 (and gather_normal's sums) may keep its
# private 64-bit sums and the validity bytes in; past it they add into
# device memory. K1, K3 and K4 read the volume through the cache at any
# size: on the H100 that measured faster than staging it (PERF.md §6)
SMEM_LIMIT = 200 * 1024

# K1 / K2's grid (gather_projector.cu): GT threads a block, one block an SM
# over a launch, at least MIN_RAYS listed rays a block; the max pass's
# blocks of NT threads
_GT, _NT = 1024, 256
MIN_RAYS = 256

# the most of the card's free memory a pose's sample table may take
TABLE_SHARE = 0.25

# samples (copies x l2 x d2 x d2) one chunk of the plain versions holds at most
_CHUNK_SAMPLES = 1 << 25

# the transposes' integer sums stay below 2^FIXED_BITS (int64 holds 2^63)
FIXED_BITS = 61

# K3's grid: blocks of _NT threads, about K3_BLOCKS_A_SM an SM over the
# launch (its registers let two stay on an SM), at least K3_MIN_RAYS listed
# rays a block
K3_BLOCKS_A_SM, K3_MIN_RAYS = 2, 64

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
    leave a sum unchanged. Only the lanes below o reach lane 0 after the
    shuffle by o, and for them lane ^ o = lane + o: each step adds the
    upper half of the lanes it keeps to the lower."""
    d2 = v.shape[-1]
    n = -(-d2 // 32)
    v = torch.nn.functional.pad(v, (0, 32 * n - d2)).reshape(v.shape[:-1] + (n, 32))
    acc = torch.zeros(v.shape[:-2] + (32,), dtype=v.dtype, device=v.device)
    for c in range(n):
        acc = acc + v[..., c, :]
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o : 2 * o]
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


def rotations(tilt_deg, psi_deg, device="cuda", derivatives: bool = False):
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
    # the nn list's sample table (sample_table; None: the kernels compute
    # the samples): sidx (k, n_max, d2) int32 each listed ray's samples'
    # voxels, -1 where not valid
    sidx: torch.Tensor | None = None
    # the kernels' validity bytes (aux > 0.5), made once with the tables
    ok: torch.Tensor | None = None
    # the kernels' fixed arguments and scratch by C entry (_plan), kept for
    # the tables' later calls
    _plans: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

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
    (at the amyloid's geometry 3 % of them are live). On the card, nn, also
    the list's sample table (sample_table), when its bytes (4 a sample: 14
    MB a candidate there) are at most TABLE_SHARE of the card's free
    memory: the ~30 applications of a solve then read each sample's voxel
    instead of computing it (the engine's per-pose sampling tables). A
    linear table (16 bytes a sample: a cell and its fractions) measured
    slower than computing the samples, so linear lists have none (PERF.md,
    PR 13). Built once per pose, with one device-to-host copy (the longest
    list); the plain versions read neither."""
    k = tab.shape[0]
    flat = row_valid.reshape(k, -1)
    counts = flat.sum(dim=1)
    rptr = torch.zeros(k + 1, dtype=torch.int32, device=flat.device)
    rptr[1:] = torch.cumsum(counts, 0)
    ridx = torch.nonzero(flat)[:, 1].to(torch.int32).contiguous()
    listed = dataclasses.replace(tab, rptr=rptr, ridx=ridx, n_max=int(counts.max()), sidx=None)
    if flat.is_cuda and not tab.linear:
        if 4 * k * listed.n_max * tab.d2 <= TABLE_SHARE * torch.cuda.mem_get_info(flat.device)[0]:
            listed.sidx = sample_table(listed)
    return listed


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
    for sl in _copy_chunks(tab, sampler):
        Z, Y, X = _sample_coords(tab, q, sl, bx[None], by[None], bz[None])
        yield (sl, (Z, Y, X), *sampler.taps(Z, Y, X))


def _sample_coords(tab: GatherTables, q: int, ci, bx, by, bz):
    """(Z, Y, X) of candidate q's copies ci at the ray coordinates (bx, by,
    bz), whose leading axis runs with ci or has length 1: the volume index
    of every sample, in the reference's order of float32 operations. Both
    chunk iterators take it, so that the blocks _live_chunks keeps are
    _chunks' samples, bit for bit."""
    shape = (-1,) + (1,) * (bx.dim() - 1)
    c = tab.cs[q, ci].reshape(shape)
    sn = tab.sn[q, ci].reshape(shape)
    # inverse z-rotation: (x, y) -> (x c + y s, -x s + y c)
    X = (bx * c + by * sn) + tab.d3 // 2
    Y = (by * c - bx * sn) + tab.d3 // 2
    Z = (bz - tab.dz[q, ci].reshape(shape)) + tab.l3 // 2
    return Z, Y, X


def _copy_chunks(tab: GatherTables, sampler: _Sampler):
    """Slices of the copies, each of at most _CHUNK_SAMPLES samples (taps)."""
    k, C, l2, d2 = tab.shape
    step = max(1, _CHUNK_SAMPLES // ((8 if sampler.linear else 1) * l2 * d2 * d2))
    return [slice(a, min(a + step, C)) for a in range(0, C, step)]


def _live_chunks(tab: GatherTables, q: int, sampler: _Sampler, every: bool = False):
    """(copy indices, row indices, (Z, Y, X), taps, valid) of candidate q's
    live row blocks, chunk by chunk: the (copy, row) pairs some sample of which lies
    in the volume's z range, each block (n, d2, d2) with _chunks' samples
    (_sample_coords). Z is monotone (rounding is) along a ray and
    across the columns of a row, so its values at a block's four corners
    bound every sample's; a sample of a block outside the range reads and
    writes nothing of the volume (nn: the zero padding; linear: weight 0),
    so that its rays sum to +0 and add 0 to the transpose, as the blocks
    left out here. ``every`` keeps every block (the tests hold the pruned
    sums to it)."""
    bx, by, bz = _base(tab, q)
    corners = bz[:, [0, -1]][:, :, [0, -1]].reshape(1, -1, 4)
    # a sample is valid only at z in [0, l3 - 1]: nn rounds half to even,
    # linear takes the cell below
    z_lo, z_hi = (0.0, tab.l3 - 1.0) if sampler.linear else (-0.5, tab.l3 - 0.5)
    for sl in _copy_chunks(tab, sampler):
        Zc = (corners - tab.dz[q, sl, None, None]) + tab.l3 // 2
        lo, hi = Zc.amin(dim=2), Zc.amax(dim=2)
        live = (hi >= z_lo) & ((lo < z_hi) if sampler.linear else (lo <= z_hi))
        if every:
            live = torch.ones_like(live)
        ci, ii = torch.nonzero(live, as_tuple=True)
        if not len(ci):
            continue
        ci = ci + sl.start
        Z, Y, X = _sample_coords(tab, q, ci, bx[ii], by[ii], bz[ii])
        yield (ci, ii, (Z, Y, X), *sampler.taps(Z, Y, X))


def gather_project_reference(tab: GatherTables, x=None, row_valid: bool = False):
    """The plain K1: pred (k, C, l2, d2) of the volumes x (k, l3, d3, d3)
    (None: no values), each ray's samples summed in the kernel's order
    (_ray_sum), and with row_valid also the rays' validity (k, C, l2, d2)
    bool: >= 1 valid sample and the copy slot populated."""
    k, C, l2, d2 = tab.shape
    dev = tab.mask.device
    sampler = tab.sampler()
    pred = None if x is None else torch.zeros((k, C, l2, d2), dtype=torch.float32, device=dev)
    rowv = torch.zeros((k, C, l2, d2), dtype=torch.bool, device=dev) if row_valid else None
    for q in range(k):
        xf = None if x is None else sampler.source(x[q])
        cv = tab.cvf[q]
        for ci, ii, _, taps, valid in _live_chunks(tab, q, sampler):
            if pred is not None:
                pred[q, ci, ii] = _ray_sum(_gather(xf, taps)) * cv[ci, None]
            if rowv is not None:
                rowv[q, ci, ii] = valid.any(dim=2) & (cv[ci, None] > 0)
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
        for ci, ii, _, taps, _ in _live_chunks(tab, q, sampler):
            _scatter_fixed(acc, taps, (r[q, ci, ii] * cv[ci, None])[..., None], scale[q])
        out.append(sampler.result(_from_fixed(acc, scale[q]))[0])
    return torch.stack(out)


def sample_table_reference(tab: GatherTables) -> torch.Tensor:
    """The plain sample table of tab's nn list: sidx (k, n_max, d2) int32
    as the kernel writes it, each listed ray's samples' flat voxel index
    (rounded half to even, inside the volume and the mask), -1 where the
    sample is not valid and in the slots past a candidate's entries."""
    k, C, l2, d2 = tab.shape
    d3, l3 = tab.d3, tab.l3
    sidx = torch.full((k, tab.n_max, d2), -1, dtype=torch.int32, device=tab.mask.device)
    for q in range(k):
        a, b = int(tab.rptr[q]), int(tab.rptr[q + 1])
        ray = tab.ridx[a:b].long()
        t, i, j = ray // (l2 * d2), (ray // d2) % l2, ray % d2
        bx, by, bz = _base(tab, q)
        Z, Y, X = _sample_coords(tab, q, t, bx[i, j], by[i, j], bz[i, j])
        zi, yi, xi = (torch.round(v).to(torch.int64) for v in (Z, Y, X))
        inb = ((zi >= 0) & (zi <= l3 - 1) & (yi >= 0) & (yi <= d3 - 1) & (xi >= 0)
               & (xi <= d3 - 1))
        idx = ((zi * d3 + yi) * d3 + xi).clamp(0, l3 * d3 * d3 - 1)
        valid = inb & (tab.mask[idx] > 0.5)
        sidx[q, : b - a] = torch.where(valid, idx, -1).to(torch.int32)
    return sidx


def gather_normal_reference(tab: GatherTables, x, rows) -> torch.Tensor:
    """The plain gather_normal: PT(P(x) * rows) (k, l3, d3, d3) of the
    volumes x (k, l3, d3, d3) and the row weights rows (k, C, l2, d2), the
    two plain versions composed."""
    return gather_backproject_reference(tab, gather_project_reference(tab, x) * rows)


def pose_jacobian_reference(tab: GatherTables, x, b):
    """The plain K3 (linear tables with derivatives): for each candidate
    the residual r = (P(x) - b) over the valid rows and its Jacobian J by
    (tilt, psi, dy), each ray's derivative the trilinear gradient at each
    sample dotted with the sample's coordinate derivatives, over the live
    row blocks (_live_chunks: the others add 0). The valid rows are the
    tables' list of live rays where they have one (with_live_rays: the
    rays the kernel walks), else each ray's >= 1 valid sample and its
    populated slot. Returns (J^T J (k, 3, 3), J^T r (k, 3), r^T r (k,))
    float64."""
    if not tab.linear or tab.dR is None:
        raise ValueError("pose_jacobian needs linear tables with derivatives")
    k, C, l2, d2 = tab.shape
    listed = None
    if tab.rptr is not None:
        listed = torch.zeros((k, C * l2 * d2), dtype=torch.bool, device=x.device)
        for q in range(k):
            listed[q, tab.ridx[int(tab.rptr[q]):int(tab.rptr[q + 1])].long()] = True
        listed = listed.reshape(k, C, l2, d2)
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
        for ci, ii, (Z, Y, X), taps, valid in _live_chunks(tab, q, sampler):
            c = tab.cs[q, ci, None, None]
            sn = tab.sn[q, ci, None, None]
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
            pred = _gather(xf, taps).sum(dim=2)
            # the blocks' rows of the coordinates' derivatives (dy's are
            # numbers)
            dblk = [[d[ii] if d.dim() == 3 else d for d in p] for p in dbase]
            J = torch.stack([
                (gX * (dx * c + dy * sn) + gY * (dy * c - dx * sn) + gZ * dz).sum(dim=2)
                for dx, dy, dz in dblk])  # (3, blocks, d2)
            rows = (valid.any(dim=2) & (tab.cvf[q, ci, None] > 0) if listed is None
                    else listed[q, ci, ii]).double()
            r = (pred.double() - b.double()[ii]) * rows
            J = J.double() * rows
            JtJ[q] += torch.einsum("pnj,qnj->pq", J, J)
            Jtr[q] += torch.einsum("pnj,nj->p", J, r)
            rtr[q] += (r * r).sum()
    return JtJ, Jtr, rtr


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


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


def launch_grid(k: int, n_items: int, listed: bool, sms: int) -> tuple:
    """(blocks a candidate, entries a block) of a K1 / K2 launch of k
    candidates on a card of ``sms`` SMs: one block an SM over the launch
    (each block walks its share, so its fixed costs are paid once an SM),
    but no more blocks than leave each at least MIN_RAYS of the longest
    list's n_items entries (listed) or one group of 32 rays a warp of the
    n_items rays (every ray tested; entries a block 0)."""
    per = max(1, min(-(-sms // k), n_items // (MIN_RAYS if listed else _GT)))
    return per, (max(1, -(-n_items // per)) if listed else 0)


def _max_blocks(k: int, n: int, sms: int) -> int:
    """Blocks a candidate of K2's max pass over n values: about four blocks
    an SM over the launch."""
    return max(1, min(-(-4 * sms // k), -(-n // _NT)))


_SMS: dict = {}


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _geometry(tab: GatherTables, listed: bool):
    """The C entries' list arguments (rptr, ridx), null without one, and
    the ints after them: k, C, l2, d2, d3, l3, linear, n_max, per, rpb."""
    k, C, l2, d2 = tab.shape
    listed = listed and tab.rptr is not None
    n = tab.n_max if listed else C * l2 * d2
    per, rpb = launch_grid(k, n, listed, _sm_count(tab.mask.device))
    lists = (tab.rptr, tab.ridx) if listed else (None, None)
    return lists, (k, C, l2, d2, tab.d3, tab.l3, int(tab.linear), tab.n_max if listed else 0,
                   per, rpb)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _plan(tab: GatherTables, entry: str):
    """The C function of K1 ("project": on the list when the tables have
    one; "project_all": every ray tested), K2 ("backproject") or
    gather_normal ("normal"), and its arguments that stay fixed for the
    tables: the tables' and the list's pointers (as ints), the grid, and
    the entry's scratch, made here. Made on the first call and kept, so a
    solve's ~30 calls on one pose convert and allocate none of it."""
    plan = tab._plans.get(entry)
    if plan is not None:
        return plan
    from .._build import load_kernels

    lib = load_kernels()
    lists, ints = _geometry(tab, entry != "project_all")
    k, C, l2, d2, d3, l3, _, _, per, _ = ints
    vol = l3 * d3 * d3
    tables = tuple(_ptr(t) for t in (*_args(tab), *lists,
                                      tab.sidx if lists[0] is not None else None))
    dev = tab.mask.device
    # (the C function, the pointers before the call's middle tensor, those
    # after it, the ints, the scratch tensors they point into)
    if entry in ("project", "project_all"):
        plan = (lib.hgp_project, (_ptr(tab.ok), *tables), (), ints, ())
    elif entry == "backproject":
        nbmax = _max_blocks(k, C * l2 * d2, _sm_count(dev))
        scratch = (torch.empty((k, nbmax), dtype=torch.int32, device=dev),
                   torch.empty((k, per, vol), dtype=torch.int64, device=dev))
        plan = (lib.hgp_backproject, (_ptr(tab.ok), *tables, *map(_ptr, scratch)), (),
                ints + (nbmax,), scratch)
    else:
        scratch = (torch.empty((k, max(1, tab.n_max)), dtype=torch.float32, device=dev),
                   torch.empty((k, per), dtype=torch.int32, device=dev),
                   torch.empty((k, per, vol), dtype=torch.int64, device=dev))
        plan = (lib.hgp_normal, (_ptr(tab.ok), *tables), tuple(map(_ptr, scratch)), ints,
                scratch)
    tab._plans[entry] = plan
    return plan


def _run(dev: torch.device, fn, *args) -> None:
    """fn(*args, the current stream of the card dev), with dev the current
    CUDA device during the call (entered only where it is not already);
    raises if its launches were refused."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch._C._cuda_getDevice():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


def _counted(name: str) -> None:
    """One more launch of ``name`` in ``launches``, under a lock (threads
    may drive several cards at once)."""
    with _COUNT_LOCK:
        launches[name] += 1


def _volumes(tab: GatherTables, x, name: str):
    vol = (tab.shape[0], tab.l3, tab.d3, tab.d3)
    if tuple(x.shape) != vol:
        raise ValueError(f"{name} must be {vol}, got {tuple(x.shape)}")
    return x.contiguous()


def _rays(tab: GatherTables, r, name: str):
    if tuple(r.shape) != tab.shape:
        raise ValueError(f"{name} must be {tab.shape}, got {tuple(r.shape)}")
    return r.contiguous()


# the C entries' steps (bits of their `steps` argument), for timing them alone
PROJECT_STEPS = {"zero pred": 1, "kernel": 2}
BACKPROJECT_STEPS = {"max pass": 1, "sums": 2, "reduce": 4}
NORMAL_STEPS = {"projection": 1, "sums": 2, "reduce": 4}


def _project_cuda(tab: GatherTables, x, pred, rowv, steps: int = 3) -> None:
    fn, pre, _, ints, _ = _plan(tab, "project" if rowv is None else "project_all")
    _run(tab.mask.device, fn, _ptr(x), *pre, _ptr(pred), _ptr(rowv), *ints, steps)


def _backproject_cuda(tab: GatherTables, r, out, steps: int = 7) -> None:
    fn, pre, _, ints, _ = _plan(tab, "backproject")
    _run(tab.mask.device, fn, r.data_ptr(), *pre, out.data_ptr(), *ints, SMEM_LIMIT, steps)


def _normal_cuda(tab: GatherTables, x, rows, out, steps: int = 7) -> None:
    fn, pre, post, ints, _ = _plan(tab, "normal")
    _run(tab.mask.device, fn, x.data_ptr(), *pre, rows.data_ptr(), *post, out.data_ptr(), *ints,
         SMEM_LIMIT, steps)


def sample_table(tab: GatherTables) -> torch.Tensor:
    """The sample table of tab's nn list (sample_table_reference's sidx),
    computed as K1 computes each sample. CPU tensors run the plain version;
    CUDA tensors run the kernel (never the plain version)."""
    if tab.rptr is None or tab.linear:
        raise ValueError("sample_table tabulates an nn list of live rays: with_live_rays(tab, ...)")
    if _device_of(tab.mask, "sample_table") == "cpu":
        return sample_table_reference(tab)
    k, C, l2, d2 = tab.shape
    sidx = torch.full((k, tab.n_max, d2), -1, dtype=torch.int32, device=tab.mask.device)
    lists, (*head, _, n_max, per, rpb) = _geometry(tab, True)
    from .._build import load_kernels

    _run(tab.mask.device, load_kernels().hgp_sample_table, _ptr(tab.ok), *map(_ptr, _args(tab)),
         *map(_ptr, lists), _ptr(sidx), *head, n_max, per, rpb)
    _counted("sample_table")
    return sidx


def gather_project(tab: GatherTables, x=None, row_valid: bool = False):
    """K1: pred (k, C, l2, d2) = P(x) of the volumes x (k, l3, d3, d3) (None:
    no values), and with row_valid also the rays' validity (bool; every ray
    tested, the list unused). CPU tensors run the plain version; CUDA
    tensors run the kernel (never the plain version)."""
    if _device_of(tab.mask, "gather_project") == "cpu":
        return gather_project_reference(tab, x, row_valid)
    dev = tab.mask.device
    x = None if x is None else _volumes(tab, x, "x")
    _check(tab, x=x)
    pred = None if x is None else torch.empty(tab.shape, dtype=torch.float32, device=dev)
    rowv = torch.empty(tab.shape, dtype=torch.bool, device=dev) if row_valid else None
    _project_cuda(tab, x, pred, rowv)
    _counted("gather_project")
    return (pred, rowv) if row_valid else pred


def gather_backproject(tab: GatherTables, r) -> torch.Tensor:
    """K2: PT(r) (k, l3, d3, d3) of r (k, C, l2, d2), the transpose of K1,
    summed exactly (the same bits as the plain version). CPU tensors run
    the plain version; CUDA tensors run the kernel (never the plain
    version)."""
    if _device_of(tab.mask, "gather_backproject") == "cpu":
        return gather_backproject_reference(tab, r)
    r = _rays(tab, r, "r")
    _check(tab, r=r)
    out = torch.empty((tab.shape[0], tab.l3, tab.d3, tab.d3), dtype=torch.float32,
                      device=tab.mask.device)
    _backproject_cuda(tab, r, out)
    _counted("gather_backproject")
    return out


def gather_normal(tab: GatherTables, x, rows) -> torch.Tensor:
    """PT(P(x) * rows) (k, l3, d3, d3) of the volumes x (k, l3, d3, d3) and
    the row weights rows (k, C, l2, d2), summed exactly: the same bits as
    the plain version, gather_backproject_reference(tab,
    gather_project_reference(tab, x) * rows). CPU tensors run the plain
    version; CUDA tensors run K1 and K2 on the tables' list of live rays
    (with_live_rays; off it P(x) is 0) in one call, the projected values
    kept in a compact buffer of the listed rays (never the plain
    version)."""
    if _device_of(tab.mask, "gather_normal") == "cpu":
        return gather_normal_reference(tab, x, rows)
    if tab.rptr is None:
        raise ValueError("gather_normal runs on the list of live rays: with_live_rays(tab, ...)")
    x = _volumes(tab, x, "x")
    rows = _rays(tab, rows, "rows")
    _check(tab, x=x, rows=rows)
    out = torch.empty((tab.shape[0], tab.l3, tab.d3, tab.d3), dtype=torch.float32,
                      device=tab.mask.device)
    _normal_cuda(tab, x, rows, out)
    _counted("gather_normal")
    return out


def jacobian_grid(k: int, n_items: int, sms: int) -> tuple:
    """(blocks a candidate, entries a block) of a K3 launch of k candidates
    whose longest list holds n_items live rays, on a card of ``sms`` SMs:
    about K3_BLOCKS_A_SM blocks an SM over the launch, but no more blocks
    than leave each at least K3_MIN_RAYS entries, and none without any."""
    per = max(1, min(-(-K3_BLOCKS_A_SM * sms // k), n_items // K3_MIN_RAYS))
    rpb = max(1, -(-n_items // per))
    return max(1, -(-n_items // rpb)), rpb


def pose_jacobian(tab: GatherTables, x, b):
    """K3 on linear tables with derivatives: (J^T J (k, 3, 3), J^T r (k, 3),
    r^T r (k,)) float64 of the residual r = P(x) - b (b (l2, d2)) over each
    candidate's valid rows and its Jacobian by (tilt, psi, dy). CPU
    tensors run the plain version; CUDA tensors run the kernel on the
    tables' list of live rays (with_live_rays: the valid rows) (never the
    plain version)."""
    if not tab.linear or tab.dR is None:
        raise ValueError("pose_jacobian needs linear tables with derivatives")
    if _device_of(tab.mask, "pose_jacobian") == "cpu":
        return pose_jacobian_reference(tab, x, b)
    if tab.rptr is None:
        raise ValueError("pose_jacobian runs on the list of live rays: with_live_rays(tab, ...)")
    k, C, l2, d2 = tab.shape
    x = _volumes(tab, x, "x")
    b = b.contiguous()
    if tuple(b.shape) != (l2, d2):
        raise ValueError(f"b must be {(l2, d2)}, got {tuple(b.shape)}")
    _check(tab, x=x, b=b, dR=tab.dR)
    out = torch.empty((k, 13), dtype=torch.float64, device=tab.mask.device)
    _jacobian_cuda(tab, x, b, out)
    _counted("pose_jacobian")
    return out[:, :9].reshape(k, 3, 3), out[:, 9:12], out[:, 12]


def _jacobian_plan(tab: GatherTables):
    """K3's C function and its arguments that stay fixed for the listed
    tables: the pointers (as ints) before b and after it (its scratch: the
    blocks' sums and the candidates' counts, zero between launches), and
    the ints; made on the first call and kept."""
    plan = tab._plans.get("jacobian")
    if plan is None:
        from .._build import load_kernels

        k, C, l2, d2 = tab.shape
        dev = tab.mask.device
        per, rpb = jacobian_grid(k, tab.n_max, _sm_count(dev))
        scratch = (torch.empty((k, per, 10), dtype=torch.float64, device=dev),
                   torch.zeros(k, dtype=torch.int32, device=dev))
        R, *rest = _args(tab)
        pre = tuple(map(_ptr, (tab.ok, R, tab.dR, *rest, tab.rptr, tab.ridx)))
        plan = (load_kernels().hgp_pose_jacobian, pre, tuple(map(_ptr, scratch)),
                (k, C, l2, d2, tab.d3, tab.l3, tab.n_max, per, rpb), scratch)
        tab._plans["jacobian"] = plan
    return plan


def _jacobian_cuda(tab: GatherTables, x, b, out) -> None:
    fn, pre, post, ints, _ = _jacobian_plan(tab)
    _run(tab.mask.device, fn, x.data_ptr(), *pre, b.data_ptr(), *post, out.data_ptr(), *ints)


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
    # K4's item list (sym_list) and its C function, fixed arguments and
    # scratch (_sym_plan), made on first use and kept
    _list: SymList | None = dataclasses.field(default=None, init=False, repr=False,
                                               compare=False)
    _plan: tuple | None = dataclasses.field(default=None, init=False, repr=False, compare=False)

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


@dataclasses.dataclass
class SymList:
    """K4's list of the items of k candidates' symmetry tables: the (pair
    slot, voxel) rows of S that can be nonzero (the voxel in the mask, the
    slot populated, keep set, both ops' samples valid), made once per
    tables. Candidate q's items are iptr[q] .. iptr[q + 1] (int32), in
    (pair, voxel) order; itap (n, 2) int32 each item's two samples, the
    flat voxel (nn) or the cell's base corner (linear), and iw (n, 2, 8)
    float32 linear's trilinear weights (None for nn). Their incidences by
    output voxel: those of voxel o = q * vol + v are cptr[o] .. cptr[o + 1]
    (int32), each an item (cinc, int32) and its tap's signed weight (cw,
    float32: +w at the first op's sample, -w at the second's; nn's w 1)."""

    iptr: torch.Tensor
    itap: torch.Tensor
    iw: torch.Tensor | None
    cptr: torch.Tensor
    cinc: torch.Tensor
    cw: torch.Tensor


def sym_items_reference(st: SymTables):
    """The plain item list: (iptr, itap, iw) of SymList as the kernels
    write them, each sample computed as sym_tap computes it (nn: rounded
    half to even, inside the volume and the mask; linear: the cell below,
    inside the volume and cell-valid, with its eight weights in the plain
    version's order)."""
    k, P = st.shape
    d3, l3 = st.d3, st.l3
    vol = l3 * d3 * d3
    dev = st.mask.device
    v = torch.arange(vol, device=dev)
    zc, yc, xc = ((a - h).float() for a, h in ((v // (d3 * d3), l3 // 2),
                                                ((v // d3) % d3, d3 // 2), (v % d3, d3 // 2)))
    ok = st.ok.bool()

    def tap(o):
        c, s, dz = (t[..., o][..., None] for t in (st.cs, st.sn, st.dz))
        X = (xc * c - yc * s) + d3 // 2
        Y = (xc * s + yc * c) + d3 // 2
        Z = (zc + dz) + l3 // 2
        fl = torch.floor if st.linear else torch.round
        zi, yi, xi = (fl(a).to(torch.int64) for a in (Z, Y, X))
        top = 2 if st.linear else 1
        inb = ((zi >= 0) & (zi <= l3 - top) & (yi >= 0) & (yi <= d3 - top) & (xi >= 0)
               & (xi <= d3 - top))
        idx = ((zi * d3 + yi) * d3 + xi).clamp(0, vol - 1)
        w = None
        if st.linear:
            wz, wy, wx = Z - torch.floor(Z), Y - torch.floor(Y), X - torch.floor(X)
            uz, uy, ux = 1 - wz, 1 - wy, 1 - wx
            w = torch.stack([a * b * c for a, b, c in (
                (uz, uy, ux), (uz, uy, wx), (uz, wy, ux), (uz, wy, wx),
                (wz, uy, ux), (wz, uy, wx), (wz, wy, ux), (wz, wy, wx))], dim=-1)
        return idx, inb & ok[idx], w

    (t1, ok1, w1), (t2, ok2, w2) = tap(0), tap(1)
    item = ok1 & ok2 & (st.inmask > 0)[None, None] & (st.pv != 0)[..., None]
    if st.keep is not None:
        item = item & st.keep.reshape(k, P, vol)
    ids = torch.nonzero(item.reshape(-1))[:, 0]
    iptr = torch.zeros(k + 1, dtype=torch.int32, device=dev)
    iptr[1:] = torch.cumsum(item.reshape(k, -1).sum(dim=1), 0)
    itap = torch.stack([t1.reshape(-1)[ids], t2.reshape(-1)[ids]], dim=1).to(torch.int32)
    iw = None
    if st.linear:
        iw = torch.stack([w1.reshape(-1, 8)[ids], w2.reshape(-1, 8)[ids]], dim=1).contiguous()
    return iptr, itap, iw


def sym_items(st: SymTables):
    """K4's item list (iptr, itap, iw), once per tables: CPU tensors run the
    plain version; CUDA tensors run the two build kernels (the items'
    flags, then each item's samples; never the plain version), with one
    device-to-host copy (torch.nonzero's count)."""
    if _device_of(st.mask, "sym_items") == "cpu":
        return sym_items_reference(st)
    from .._build import load_kernels

    lib = load_kernels()
    k, P = st.shape
    dev = st.mask.device
    ints = (k, P, st.d3, st.l3, int(st.linear))
    tables = tuple(map(_ptr, (st.ok, st.cs, st.sn, st.dz, st.pv, st.keep_u8, st.inmask)))
    flag = torch.empty((k, P * st.l3 * st.d3 * st.d3), dtype=torch.uint8, device=dev)
    _run(dev, lib.hgp_sym_items, *tables, flag.data_ptr(), None, None, None, *ints, 0)
    ids = torch.nonzero(flag.reshape(-1))[:, 0]
    n = ids.numel()
    itap = torch.empty((n, 2), dtype=torch.int32, device=dev)
    iw = torch.empty((n, 2, 8), dtype=torch.float32, device=dev) if st.linear else None
    _run(dev, lib.hgp_sym_items, *tables, None, ids.data_ptr(), itap.data_ptr(), _ptr(iw), *ints,
         n)
    iptr = torch.zeros(k + 1, dtype=torch.int32, device=dev)
    iptr[1:] = torch.cumsum(flag.sum(dim=1, dtype=torch.int64), 0)
    _counted("sym_items")
    return iptr, itap, iw


def _corners(d3: int, n: int, dev) -> torch.Tensor:
    """The flat offsets of a cell's first n corners (1 or 8) in the plain
    version's order (z, y, x as the bits of the corner's number)."""
    a = torch.arange(n, device=dev)
    return (a & 1) + ((a >> 1) & 1) * d3 + (a >> 2) * (d3 * d3)


def _item_candidates(iptr, n: int) -> torch.Tensor:
    """Each of the n listed items' candidate (int64), from the list's
    pointers iptr (k + 1), with no device-to-host copy."""
    k = iptr.numel() - 1
    return torch.repeat_interleave(torch.arange(k, device=iptr.device),
                                   (iptr[1:] - iptr[:-1]).long(), output_size=n)


def _incidences(st: SymTables, iptr, itap, iw):
    """(cptr, cinc, cw) of SymList: each item's taps (nn one a sample,
    linear the cell's eight corners) as incidences of its output voxels,
    sorted by voxel (a stable sort, so in item order within one), with no
    device-to-host copy."""
    k = st.shape[0]
    vol = st.l3 * st.d3 * st.d3
    dev = itap.device
    n = itap.shape[0]
    q = _item_candidates(iptr, n)
    offs = _corners(st.d3, 8 if st.linear else 1, dev)
    dst = (itap.long()[:, :, None] + offs + (q * vol)[:, None, None]).reshape(-1)
    sign = (1 - 2 * torch.arange(2, device=dev, dtype=torch.float32))[None, :, None]
    w = iw * sign if st.linear else sign.expand(n, 2, 1)
    dst, order = torch.sort(dst, stable=True)
    cptr = torch.searchsorted(dst, torch.arange(k * vol + 1, device=dev)).to(torch.int32)
    cinc = torch.div(order, 2 * len(offs), rounding_mode="floor").to(torch.int32)
    return cptr, cinc, w.reshape(-1)[order].contiguous()


def sym_list(st: SymTables) -> SymList:
    """The tables' SymList, made on first use (sym_items and the sort of
    its incidences) and kept."""
    if st._list is None:
        iptr, itap, iw = sym_items(st)
        st._list = SymList(iptr, itap, iw, *_incidences(st, iptr, itap, iw))
    return st._list


def sym_normal_list_reference(st: SymTables, x) -> torch.Tensor:
    """The plain K4 on the tables' list: each item's row s = x(g1 v) - x(g2
    v) (linear: the eight corners weighted in the plain version's order),
    each incidence's integer fixed(w * s) added into its voxel, at
    sym_normal_reference's scale: its bits, from the list alone."""
    lst = sym_list(st)
    k, P = st.shape
    vol = st.l3 * st.d3 * st.d3
    dev = x.device
    xf = x.reshape(-1)
    at = lst.itap.long() + (_item_candidates(lst.iptr, lst.itap.shape[0]) * vol)[:, None]
    if st.linear:
        vals = xf[at[..., None] + _corners(st.d3, 8, dev)]
        a = lst.iw[..., 0] * vals[..., 0]
        for c in range(1, 8):
            a = a + lst.iw[..., c] * vals[..., c]
    else:
        a = xf[at]
    s = a[:, 0] - a[:, 1]
    scale = fixed_scales(x.abs().reshape(k, -1).amax(dim=1), 4 * P * vol)
    dst = torch.repeat_interleave(torch.arange(k * vol, device=dev),
                                  (lst.cptr[1:] - lst.cptr[:-1]).long(),
                                  output_size=lst.cinc.numel())
    terms = _to_fixed(lst.cw * s[lst.cinc.long()], scale[dst // vol])
    acc = torch.zeros(k * vol, dtype=torch.int64, device=dev).index_add_(0, dst, terms)
    return _from_fixed(acc.reshape(k, vol), scale[:, None]).reshape(x.shape)


def sym_normal(st: SymTables, x) -> torch.Tensor:
    """K4: ST(S(x)) (k, l3, d3, d3) of the volumes x (k, l3, d3, d3), summed
    exactly (the same bits as the plain version). CPU tensors run the
    plain version; CUDA tensors run the kernels on the tables' list
    (sym_list, made at the first call; never the plain version): the
    call's only allocation is its result."""
    if _device_of(st.mask, "sym_normal") == "cpu":
        return sym_normal_reference(st, x)
    dev = st.mask.device
    vol = (st.shape[0], st.l3, st.d3, st.d3)
    if tuple(x.shape) != vol:
        raise ValueError(f"x must be {vol}, got {tuple(x.shape)}")
    x = x.contiguous()
    if x.device != dev or x.dtype != torch.float32:
        raise ValueError(f"x must be a float32 tensor on {dev}")
    out = torch.empty(vol, dtype=torch.float32, device=dev)
    _sym_cuda(st, x, out)
    _counted("sym_normal")
    return out


SYM_STEPS = {"differences and max pass": 1, "sums": 2}


def sym_blocks(k: int, n_items: int, vol: int, sms: int) -> int:
    """Blocks a candidate of K4's first kernel: one of a candidate's mean
    share of the n_items items (or a voxel of the max pass) a thread of
    _NT, but at most about four blocks an SM over the launch."""
    return max(1, min(-(-4 * sms // k), -(-max(-(-n_items // k), vol) // _NT)))


def sym_lanes(k: int, vol: int, n_inc: int, sms: int) -> int:
    """Lanes that share an output voxel in K4's sums: the least power of two
    at or above the mean incidences a voxel, but at most 32 and no more
    than one wave of the card's threads (2,048 an SM) holds."""
    cap = min(32, sms * 2048 // max(1, k * vol))
    lanes = 1
    while lanes * 2 <= cap and lanes * k * vol < n_inc:
        lanes *= 2
    return lanes


def _sym_plan(st: SymTables):
    """K4's C function and its arguments that stay fixed for the tables:
    the list's pointers (as ints), the call's scratch (the rows'
    differences, the blocks' maxima) and the grid; made on the first call
    and kept, so that a call allocates nothing but its result and converts
    only x and out."""
    if st._plan is None:
        from .._build import load_kernels

        lst = sym_list(st)
        k, P = st.shape
        dev = st.mask.device
        vol = st.l3 * st.d3 * st.d3
        sms = _sm_count(dev)
        nb = sym_blocks(k, lst.itap.shape[0], vol, sms)
        scratch = (torch.empty(max(1, lst.itap.shape[0]), dtype=torch.float32, device=dev),
                   torch.empty((k, nb), dtype=torch.int32, device=dev))
        pre = tuple(map(_ptr, (lst.iptr, lst.itap, lst.iw, lst.cptr, lst.cinc, lst.cw, *scratch)))
        st._plan = (load_kernels().hgp_sym_normal, pre,
                    (k, P, st.d3, st.l3, int(st.linear), nb,
                     sym_lanes(k, vol, lst.cinc.numel(), sms)), scratch)
    return st._plan


def _sym_cuda(st: SymTables, x, out, steps: int = 3) -> None:
    fn, pre, ints, _ = _sym_plan(st)
    _run(st.mask.device, fn, x.data_ptr(), *pre, out.data_ptr(), *ints, steps)
