"""The adaptive 3D mask of the true-FSC command, on the device of the map.

Counterpart of ``helicon_tpu/core/mask3d.py`` (:46-243), with its chain and
its quirks: a Gaussian lowpass (three axis products with the
reflect-Gaussian matrix, TF32 off), the threshold (fraction > absolute >
mass > Otsu, EMAN2's histogram offset and bin-0 skip), the 1,000 brightest
voxels as seeds, growth inside the threshold mask (26-connected, the
fixpoint of 3^3 dilations capped at ``sum(shape)``), an exact Euclidean
distance transform (separable min-plus passes) and the cosine soft edge.

Where the reference relies on an order the port's libraries do not
promise, the port fixes it: the seeds come from a stable descending sort
(``jax.lax.top_k`` takes the lower index of a tie), and Otsu's histogram
counts in int64 (the reference adds float32 ones, exact below 2^24 voxels
a bin).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.precision import tf32_off

__all__ = [
    "euclidean_distance_outside",
    "gaussian_lowpass_3d",
    "grow_from_seeds",
    "otsu_threshold_3d",
    "soft_cosine_mask",
    "adaptive_mask_3d",
]

# dilations between two host reads of the growth's fixpoint test
GROW_CHECK_EVERY = 8


@functools.lru_cache(maxsize=32)
def _reflect_gaussian_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) matrix applying a 1D Gaussian with reflect boundaries (scipy's
    'reflect': d c b a | a b c d), so K @ line equals
    scipy.ndimage.gaussian_filter1d(line, sigma)."""
    radius = max(1, int(4.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    kern = np.exp(-0.5 * (x / sigma) ** 2)
    kern /= kern.sum()
    K = np.zeros((n, n), np.float64)
    idx = np.arange(n)
    for t, w in zip(range(-radius, radius + 1), kern):
        j = idx + t
        j = np.where(j < 0, -j - 1, j)
        j = np.where(j >= n, 2 * n - j - 1, j)
        K[idx, j] += w
    return K.astype(np.float32)


@tf32_off
def gaussian_lowpass_3d(volume, sigma: float) -> torch.Tensor:
    """Separable 3D Gaussian blur, reflect boundary (sigma in voxels)."""
    v = torch.as_tensor(volume).to(torch.float32)
    if sigma <= 0:
        return v
    for axis in range(3):
        K = torch.as_tensor(_reflect_gaussian_matrix(v.shape[axis], float(sigma)),
                            device=v.device)
        v = torch.tensordot(K, v.movedim(axis, 0), dims=([1], [0])).movedim(0, axis)
    return v


def otsu_threshold_3d(volume, n_bins: int = 256, ignore_zero: bool = True) -> torch.Tensor:
    """EMAN2-style Otsu threshold (inter-class variance maximization): the
    histogram spans [min, max] in n_bins equal bins, exact zeros are
    dropped when ignore_zero, bin 0 never wins, and the level is min +
    (winning bin + 1) * bin width (a float32 0-d tensor on the volume's
    device). The counts are int64, each capped at 2^24 before the
    conversion to float32: the reference adds float32 ones, and a bin past
    2^24 stops there (2^24 + 1 rounds back to 2^24)."""
    v = torch.as_tensor(volume).to(torch.float32).reshape(-1)
    lo, hi = v.min(), v.max()
    width = (hi - lo) / n_bins
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    bins = torch.clamp(((v - lo) / span * n_bins).to(torch.int32), 0, n_bins - 1)
    if ignore_zero:
        bins = bins[v != 0]
    hist = torch.bincount(bins, minlength=n_bins).clamp_max(2**24).to(torch.float32)
    p = hist / torch.clamp_min(hist.sum(), 1.0)
    centers = torch.arange(n_bins, dtype=torch.float32, device=v.device)
    omega = torch.cumsum(p, 0)
    mu = torch.cumsum(p * centers, 0)
    mu_total = mu[-1]
    denom = omega * (1.0 - omega)
    var_b = torch.where(denom > 0, (mu_total * omega - mu) ** 2 / torch.clamp_min(denom, 1e-30),
                        0.0)
    var_b[0] = -1.0
    best = torch.argmax(var_b)
    return lo + (best.to(torch.float32) + 1.0) * width


def _dilate_box3(mask: torch.Tensor) -> torch.Tensor:
    """One 3^3 box dilation (26-connectivity) of a boolean volume, as three
    axis passes (the box's maximum is separable; outside counts as False)."""
    for dim in range(3):
        out = mask.clone()
        n = mask.shape[dim]
        out.narrow(dim, 1, n - 1).logical_or_(mask.narrow(dim, 0, n - 1))
        out.narrow(dim, 0, n - 1).logical_or_(mask.narrow(dim, 1, n - 1))
        mask = out
    return mask


def _grow(above, seeds, max_iters: int | None = None) -> tuple[torch.Tensor, int]:
    """grow_from_seeds, and the reference loop's count of dilations: up to
    and including the first that changes nothing, or max_iters. The growth
    only adds voxels, so a dilation changed the mask iff it raised the
    voxel count; the counts stay on the device and are read on the host
    every GROW_CHECK_EVERY dilations, and the count never passes max_iters."""
    above = torch.as_tensor(above).to(torch.bool)
    cur = (torch.as_tensor(seeds, device=above.device) > 0.5) & above
    if max_iters is None:
        max_iters = int(sum(above.shape))
    it, count = 0, cur.sum()
    while it < max_iters:
        counts = [count]
        for _ in range(min(GROW_CHECK_EVERY, max_iters - it)):
            cur = _dilate_box3(cur) & above
            counts.append(cur.sum())
        grew = (torch.diff(torch.stack(counts)) > 0).tolist()
        if not all(grew):
            return cur, it + grew.index(False) + 1
        it, count = it + len(grew), counts[-1]
    return cur, it


def grow_from_seeds(above, seeds, max_iters: int | None = None) -> torch.Tensor:
    """Morphological reconstruction: the union of ``above``'s 26-connected
    components that hold a seed, as the fixpoint of dilations inside
    ``above`` (at most max_iters, by default ``sum(shape)``)."""
    return _grow(above, seeds, max_iters)[0]


def euclidean_distance_outside(mask, cap: float | None = None) -> torch.Tensor:
    """EXACT Euclidean distance from each voxel to the mask (0 inside):
    per axis, d2[x] = min_i (d2_in[i] + (x - i)^2), a loop of elementwise
    minimums in float32 (integers, exact). cap only bounds the returned
    values."""
    m = torch.as_tensor(mask).to(torch.bool)
    big = float(np.float32(np.prod(m.shape) ** 2))
    d2 = torch.where(m, 0.0, big).to(torch.float32)
    for axis in range(3):
        d2m = d2.movedim(axis, 0)
        n = d2m.shape[0]
        ar = torch.arange(n, dtype=torch.float32, device=m.device)
        offs = (ar[:, None] - ar[None, :]) ** 2
        acc = torch.full_like(d2m, big)
        for i in range(n):
            torch.minimum(acc, d2m[i][None] + offs[:, i][:, None, None], out=acc)
        d2 = acc.movedim(0, axis)
    d = torch.sqrt(d2)
    if cap is not None:
        d = torch.clamp_max(d, cap)
    return d


def soft_cosine_mask(mask, soft_width: float) -> torch.Tensor:
    """Cosine falloff over ``soft_width`` voxels outside the binary mask, a
    full cosine reaching 0 at d = soft_width (the reference's documented
    deviation from the half cosine that leaves a 0.5 cliff)."""
    m = torch.as_tensor(mask).to(torch.bool)
    if soft_width <= 0:
        return m.to(torch.float32)
    d = euclidean_distance_outside(m, cap=2.0 * soft_width)
    edge = (torch.cos(d / soft_width * float(np.float32(np.pi))) + 1.0) / 2.0
    return torch.where(m, 1.0, torch.where(d <= soft_width, edge, 0.0))


def _top_seeds(v_lp: torch.Tensor, n_seeds: int) -> torch.Tensor:
    """A float32 0/1 volume of the n_seeds largest voxels, a tie taken at
    the lower flat index (jax.lax.top_k's order): a stable descending
    sort."""
    flat = v_lp.reshape(-1)
    k = min(n_seeds, flat.numel())
    idx = torch.sort(flat, descending=True, stable=True).indices[:k]
    seeds = torch.zeros_like(flat)
    seeds[idx] = 1.0
    return seeds.reshape(v_lp.shape)


def _threshold(v_lp, apix, thresh_fraction, thresh_absolute, mass_kda) -> torch.Tensor:
    """The mask level, by the reference's precedence: fraction of the
    maximum > absolute > the value rank that encloses mass_kda (0.81 Da per
    A^3) > Otsu."""
    if thresh_fraction > 0:
        return thresh_fraction * v_lp.max()
    if thresh_absolute > 0:
        return torch.tensor(float(np.float32(thresh_absolute)), device=v_lp.device)
    if mass_kda > 0:
        n_vox = int(mass_kda * 1e3 / (0.81 * apix**3))
        flat = torch.sort(v_lp.reshape(-1), descending=True).values
        return flat[min(n_vox, flat.numel() - 1)]
    return otsu_threshold_3d(v_lp)


def adaptive_mask_3d(volume, apix: float, cutoff_res: float, thresh_fraction: float = 0.0,
                     thresh_absolute: float = 0.0, mass_kda: float = 0.0,
                     n_seeds: int = 1000):
    """EMAN2 mask.auto3d-equivalent adaptive mask on the volume's device:
    the lowpass (sigma = cutoff_res / (3.81 apix) when cutoff_res > 2
    apix), the threshold, the n_seeds brightest voxels as seeds, connected
    growth; an empty growth falls back to the threshold mask. Returns
    (boolean mask, threshold, lowpassed volume)."""
    v = torch.as_tensor(volume).to(torch.float32)
    v_lp = gaussian_lowpass_3d(v, cutoff_res / (3.81 * apix)) if cutoff_res > 2 * apix else v
    level = _threshold(v_lp, apix, thresh_fraction, thresh_absolute, mass_kda)
    above = v_lp > level
    grown = grow_from_seeds(above, _top_seeds(v_lp, n_seeds))
    mask = grown if bool(grown.any()) else above
    return mask, level, v_lp
