"""Filters on tensors: the threshold clip, the normalizations, the cosine
edge taper, and on ``torch.fft`` the structural factor and its matching,
the Gaussian low/high-pass, the anti-aliased down-scaling (Gaussian
prefilter, then a cubic B-spline resample) and the phase randomization
beyond a resolution cutoff.

Counterpart of ``helicon_tpu/core/filters.py`` whole:
``calculate_structural_factor`` :51, ``set_structural_factors`` :82,
``match_structural_factors`` :105, the normalizations :117-137,
``threshold_data`` :139, ``_normalized_r2`` :151,
``low_high_pass_filter`` :165, ``_gaussian_blur`` :181, ``down_scale``
:195 / :224, ``generate_tapering_filter`` :244 and
``randomize_phases_lowpass`` :266. Each runs on the device of the tensor
it is given; numpy input, and the taper, which takes none, go to the
keyword ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import _jax_random
from ..utils.tensors import on_device
from .analysis import _div, _fftfreq64

__all__ = [
    "calculate_structural_factor",
    "down_scale",
    "generate_tapering_filter",
    "low_high_pass_filter",
    "match_structural_factors",
    "normalize_mean_std",
    "normalize_min_max",
    "normalize_percentile",
    "randomize_phases_lowpass",
    "set_structural_factors",
    "threshold_data",
]

logger = logging.getLogger(__name__)


def _fftfreq_radius(shape, apix: float) -> np.ndarray:
    """|q| grid (1/Angstrom) in fft layout for a 2D / 3D shape, float64 on
    the host as the reference bins it."""
    grids = [np.fft.fftfreq(n) ** 2 for n in shape]
    if len(shape) == 2:
        qr2 = grids[0][:, None] + grids[1][None, :]
    else:
        qr2 = grids[0][:, None, None] + grids[1][None, :, None] + grids[2][None, None, :]
    return np.sqrt(qr2) / apix


def calculate_structural_factor(data, apix: float, thresh=None, mask=None,
                                return_fft: bool = False, *, device="cuda"):
    """1D structural factor: the sum of |F|^2 over radial q bins (a float32
    scatter-add, as the reference's). Returns (qbins numpy, sf[, F])."""
    data = on_device(data, device)
    work = threshold_data(data, thresh_value=thresh) if thresh else data
    if mask is not None:
        work = work * torch.as_tensor(mask, device=data.device).to(torch.float32)
    F = torch.fft.fftn(work)
    amp2 = F.real**2 + F.imag**2

    qr = _fftfreq_radius(work.shape, apix)
    qstep = qr[qr > 0].min()
    nbins = int(qr.max() / qstep) // 2 * 2
    qbins = np.linspace(0, nbins * qstep, nbins)
    labels = torch.as_tensor(np.searchsorted(qbins, qr, "right").ravel() - 1, device=data.device)
    sf = torch.zeros(nbins, dtype=torch.float32, device=data.device)
    sf.index_add_(0, labels, amp2.reshape(-1))
    if return_fft:
        return qbins, sf, F
    return qbins, sf


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp(x, xp, fp) in x's dtype (a segment shorter than the
    float32 spacing of eps takes its left value; outside the ends, the end
    values)."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _interp_fill0(xq: torch.Tensor, xp, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation with 0 outside [xp[0], xp[-1]], float32."""
    xp = torch.tensor(np.asarray(xp, np.float32), device=xq.device)
    y = _interp(xq, xp, fp)
    return torch.where((xq >= xp[0]) & (xq <= xp[-1]), y, 0.0)


def set_structural_factors(data, apix: float, target_bins, target_structural_factors,
                           thresh=None, mask=None, *, device="cuda") -> torch.Tensor:
    """Rescale the radial amplitudes so that the structural factor matches
    a target (interpolated onto this map's bins, 0 outside its range)."""
    data = on_device(data, device)
    qbins, sf, fft = calculate_structural_factor(data, apix, thresh=thresh, mask=mask,
                                                 return_fft=True)
    if mask is not None:
        fft = torch.fft.fftn(data)
    dev = data.device
    target = _interp_fill0(torch.tensor(qbins.astype(np.float32), device=dev), target_bins,
                           torch.tensor(np.asarray(target_structural_factors, np.float32),
                                        device=dev))
    ratio = torch.where(sf > 0, torch.sqrt(torch.clamp_min(target, 0.0)
                                           / torch.where(sf > 0, sf, 1.0)), 0.0)
    qr = torch.as_tensor(_fftfreq_radius(data.shape, apix).astype(np.float32), device=dev)
    ratio_grid = _interp_fill0(qr, qbins, ratio)
    return torch.fft.ifftn(fft * ratio_grid).real


def match_structural_factors(data, apix: float, data_target, apix_target: float, thresh=None,
                             thresh_target=None, mask=None, *, device="cuda") -> torch.Tensor:
    """Match the structural factor of *data* to that of *data_target*."""
    data = on_device(data, device)
    tb, tsf = calculate_structural_factor(data_target, apix_target, thresh=thresh_target,
                                          mask=mask, device=data.device)
    return set_structural_factors(data, apix, tb, tsf.cpu().numpy(), thresh=thresh, mask=mask)


def normalize_min_max(data, min: float = 0, max: float = 1, *, device="cuda") -> torch.Tensor:
    """(max - min) * (data - lo) / (hi - lo); a constant array unchanged
    (the reference's form, which does not add min)."""
    data = on_device(data, device, None)
    lo, hi = data.min(), data.max()
    same = hi == lo
    return torch.where(same, data, (max - min) * (data - lo) / torch.where(same, 1.0, hi - lo))


def _mean(x: torch.Tensor) -> torch.Tensor:
    """jnp.mean as XLA forms it: the sum times the reciprocal of the count
    in x's dtype (a constant float32 array of 30 x 2.5 has the mean
    2.5000002)."""
    return x.sum() * torch.tensor(1.0 / x.numel(), dtype=x.dtype, device=x.device)


def normalize_mean_std(data, mean: float = 0, std: float = 1, *, device="cuda") -> torch.Tensor:
    """(data - mean(data)) / std(data), the population std, as jnp.std
    forms it (an array whose std is 0 unchanged; the reference's form,
    which ignores mean and std)."""
    data = on_device(data, device, None)
    centered = data - _mean(data)
    s = torch.sqrt(_mean(centered * centered))
    return torch.where(s == 0, data, centered / torch.where(s == 0, 1.0, s))


def _percentiles(data: torch.Tensor, ps) -> list:
    """jnp.percentile's linear method over all elements: the sorted values
    at the float32 index q (n - 1), weighted by its fraction."""
    s = torch.sort(data.reshape(-1)).values
    n = s.numel()
    out = []
    for p in ps:
        q = np.float32(np.float32(p) / np.float32(100.0)) * (np.float32(n) - np.float32(1))
        lo, hi = np.floor(q), np.ceil(q)
        w_hi = np.float32(q - lo)
        w_lo = np.float32(1) - w_hi
        lo, hi = int(min(max(lo, 0), n - 1)), int(min(max(hi, 0), n - 1))
        out.append(s[lo] * float(w_lo) + s[hi] * float(w_hi))
    return out


def normalize_percentile(data, percentile=(0, 100), *, device="cuda") -> torch.Tensor:
    """Rescale so the two percentiles map to 0 and 1 (a constant array
    unchanged)."""
    data = on_device(data, device, None)
    v = torch.stack(_percentiles(data, percentile))
    vmin, vmax = v.min(), v.max()
    same = vmax == vmin
    return torch.where(same, data, (data - vmin) / torch.where(same, 1.0, vmax - vmin))


def threshold_data(data, thresh_fraction=None, thresh_value=None, *, device="cuda"):
    """Clip values below a threshold (thresh_fraction >= 0: that fraction of
    the maximum; else thresh_value) and shift so the threshold maps to 0;
    neither given: the data unchanged (counterpart of
    ``helicon_tpu/core/filters.py:139``)."""
    data = on_device(data, device, None)
    if thresh_fraction is not None and thresh_fraction >= 0:
        thresh = data.max() * thresh_fraction
    elif thresh_value is not None:
        thresh = torch.as_tensor(thresh_value, dtype=data.dtype, device=data.device)
    else:
        return data
    return torch.clamp_min(data, thresh) - thresh


def _normalized_r2(shape) -> np.ndarray:
    """Squared radius grid normalized to the half-axis, centred layout."""
    axes = [(np.arange(n, dtype=np.float32) - n // 2) / (n // 2) for n in shape]
    if len(shape) == 2:
        return axes[0][:, None] ** 2 + axes[1][None, :] ** 2
    return (axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
            + axes[2][None, None, :] ** 2)


def low_high_pass_filter(data, low_pass_fraction: float = 0, high_pass_fraction: float = 0,
                         *, device="cuda"):
    """Gaussian low/high-pass of a 2D or 3D image in Fourier space (each
    fraction of Nyquist; outside (0, 1) that filter is off)."""
    data = on_device(data, device)
    if data.ndim not in (2, 3):
        raise ValueError("Input data must be a 2D or 3D array.")
    fft = torch.fft.fftn(data)
    R2 = _normalized_r2(data.shape)
    for frac, high in ((low_pass_fraction, False), (high_pass_fraction, True)):
        if 0 < frac < 1:
            g = np.exp(-np.float32(np.log(2) / frac**2) * R2)
            g = np.fft.fftshift(1.0 - g if high else g)
            fft = fft * torch.as_tensor(g, device=data.device)
    return torch.fft.ifftn(fft).real


def _gaussian_blur(data: torch.Tensor, sigmas) -> torch.Tensor:
    """Separable FFT-domain Gaussian blur (anti-alias prefilter) over the
    trailing len(sigmas) axes; leading axes are a batch."""
    data = torch.as_tensor(data, dtype=torch.float32)
    axes = tuple(range(data.ndim - len(sigmas), data.ndim))
    fft = torch.fft.fftn(data, dim=axes)
    for ax, sigma in zip(axes, sigmas):
        if sigma <= 0:
            continue
        f = np.fft.fftfreq(data.shape[ax]).astype(np.float32)
        g = np.exp(-2 * (np.pi * f * sigma) ** 2)
        shape = [1] * data.ndim
        shape[ax] = -1
        fft = fft * torch.as_tensor(g, device=data.device).reshape(shape)
    return torch.fft.ifftn(fft, dim=axes).real


def down_scale(data, target_apix: float, apix_orig: float, *, device="cuda") -> torch.Tensor:
    """Anti-aliased down-scale of a 2D image to a larger pixel size.

    Gaussian prefilter (sigma ``(1/scale - 1)/2``, as skimage), cubic
    resample, then zero-padding to even dimensions.
    """
    from .interp import map_coordinates
    from .transforms import pad_to_size

    data = on_device(data, device, None)
    if target_apix == apix_orig:
        return data
    if target_apix < apix_orig:
        logger.warning(
            "the input image pixel size (%s) is larger than --target_apix2d=%s. "
            "Down-scaling skipped",
            apix_orig,
            target_apix,
        )
        return data

    scale = apix_orig / target_apix
    ny0, nx0 = data.shape
    ny1 = int(round(ny0 * scale))
    nx1 = int(round(nx0 * scale))
    sigma = (1.0 / scale - 1.0) / 2.0
    blurred = _gaussian_blur(data, (sigma, sigma))
    rr = (torch.arange(ny1, dtype=torch.float32, device=data.device) + 0.5) / scale - 0.5
    cc = (torch.arange(nx1, dtype=torch.float32, device=data.device) + 0.5) / scale - 0.5
    R, C = torch.meshgrid(rr, cc, indexing="ij")
    out = map_coordinates(blurred, (R, C), order=3, mode="mirror")
    return pad_to_size(out, (ny1 + ny1 % 2, nx1 + nx1 % 2))


def generate_tapering_filter(image_size, fraction_start=(0.8, 0.8),
                             fraction_slope: float = 0.1, device="cuda") -> torch.Tensor:
    """Cosine edge taper (ny, nx) float32 on device: 1 inside
    fraction_start of each half axis, a cosine fall over fraction_slope,
    0 beyond; an axis whose fraction is outside (0, 1) is not tapered."""
    ny, nx = image_size
    fy, fx = fraction_start
    if not (0 < fy < 1 or 0 < fx < 1):
        return torch.ones((ny, nx), dtype=torch.float32, device=device)

    def axis(n):
        return torch.abs(_div(torch.arange(n, dtype=torch.float32, device=device) - n // 2,
                              float(n // 2)))

    filt = torch.ones((ny, nx), dtype=torch.float32, device=device)
    for f, a in ((fy, axis(ny)[:, None]), (fx, axis(nx)[None, :])):
        if 0 < f < 1:
            w = _div(1.0 + torch.cos(_div(a - f, fraction_slope) * np.pi), 2.0)
            w = torch.where(a < f, 1.0, torch.where(a > f + fraction_slope, 0.0, w))
            filt = filt * w
    return filt


def randomize_phases_lowpass(data, apix: float, cutoff_res: float, return_fft: bool = False,
                             key=None, *, device="cuda"):
    """Randomize the phases beyond a resolution cutoff, keeping the
    amplitudes (Chen et al. 2013, the true-FSC noise substitution).

    key: a raw (2,) uint32 key of ``_jax_random.PRNGKey``; without one a
    seed is drawn with ``np.random.randint(0, 2**31 - 1)``, as the
    reference draws it, so both packages under one numpy seed take the
    same key. The draw is JAX's uniform words bit for bit, computed on
    data's device. Returns the rfftn spectrum (return_fft) or the map.
    """
    data = on_device(data, device)
    F = torch.fft.rfftn(data)
    amp = torch.abs(F)
    phase = torch.angle(F)
    del F
    cutoff2 = (apix / cutoff_res) ** 2
    n = data.shape[-1]
    k = _fftfreq64(n, data.device)
    kr = _fftfreq64(n, data.device, half=True)
    k2, kr2 = k * k, kr * kr
    mask = (k2[:, None, None] + k2[None, :, None] + kr2[None, None, :]) >= cutoff2
    if key is None:
        key = _jax_random.PRNGKey(np.random.randint(0, 2**31 - 1))
    rand = _jax_random.uniform_tensor(key, phase.shape, minval=0.0, maxval=2 * np.pi,
                                      device=data.device)
    rand = torch.angle(torch.exp(1j * rand))
    phase = torch.where(mask, rand, phase)
    del rand, mask
    F2 = amp * torch.exp(1j * phase)
    if return_fft:
        return F2
    return torch.fft.irfftn(F2, s=data.shape)
