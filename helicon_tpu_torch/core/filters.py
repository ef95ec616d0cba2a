"""Anti-aliased down-scaling (Gaussian prefilter on ``torch.fft``, then a
cubic B-spline resample).

Counterpart of ``helicon_tpu/core/filters.py:181`` (``_gaussian_blur``),
``:195`` (``down_scale``) and ``:224`` (``_down_scale_jit``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["down_scale"]

logger = logging.getLogger(__name__)


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
