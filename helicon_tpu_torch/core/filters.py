"""Fourier-space filters on ``torch.fft``: the Gaussian low/high-pass and
the anti-aliased down-scaling (Gaussian prefilter, then a cubic B-spline
resample).

Counterpart of ``helicon_tpu/core/filters.py:151`` (``_normalized_r2``),
``:165`` (``low_high_pass_filter``), ``:181`` (``_gaussian_blur``),
``:195`` (``down_scale``) and ``:224`` (``_down_scale_jit``). Each runs on
the device of the tensor it is given.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["low_high_pass_filter", "down_scale"]

logger = logging.getLogger(__name__)


def _normalized_r2(shape) -> np.ndarray:
    """Squared radius grid normalized to the half-axis, centred layout."""
    axes = [(np.arange(n, dtype=np.float32) - n // 2) / (n // 2) for n in shape]
    if len(shape) == 2:
        return axes[0][:, None] ** 2 + axes[1][None, :] ** 2
    return (axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
            + axes[2][None, None, :] ** 2)


def low_high_pass_filter(data, low_pass_fraction: float = 0, high_pass_fraction: float = 0):
    """Gaussian low/high-pass of a 2D or 3D image in Fourier space (each
    fraction of Nyquist; outside (0, 1) that filter is off)."""
    data = torch.as_tensor(data, dtype=torch.float32)
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


def down_scale(data, target_apix: float, apix_orig: float) -> torch.Tensor:
    """Anti-aliased down-scale of a 2D image to a larger pixel size.

    Gaussian prefilter (sigma ``(1/scale - 1)/2``, as skimage), cubic
    resample, then zero-padding to even dimensions.
    """
    from .interp import map_coordinates
    from .transforms import pad_to_size

    data = torch.as_tensor(data)
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
