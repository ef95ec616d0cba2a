"""Image preparation and size bookkeeping for one grid search.

Counterpart of ``helicon_tpu/denovo3d/pipeline.py``: ``prepare_data`` :26,
``derive_task_geometry`` :60, ``_pixel_geometry`` :114 and
``auto_sym_oversample`` :159. The last three are host arithmetic, copied;
``tests/test_torch_prep.py`` pins them to the originals.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["prepare_data", "derive_task_geometry", "auto_sym_oversample"]


def prepare_data(
    data,
    apix: float,
    denoise: str = "",
    low_pass: float = -1,
    transpose: int = 0,
    horizontalize: int = 0,
    device="cuda",
) -> torch.Tensor:
    """The image as a float32 tensor on ``device``, after the reference's
    chain: the low-pass (above 2 apix: a Gaussian low-pass to 2 apix /
    low_pass of Nyquist and a high-pass at 2 / the longer side), the
    denoiser, the transpose (transpose > 0, or < 0 when the filament is
    vertical), then with horizontalize the refined auto_horizontalize."""
    from ..core.filters import low_high_pass_filter
    from ..helix.orient import auto_horizontalize, is_vertical

    if not isinstance(data, torch.Tensor):
        data = np.array(data, np.float32)  # a copy: the caller's array may be read-only
    data = torch.as_tensor(data, dtype=torch.float32, device=device)
    if low_pass > 2 * apix:
        data = low_high_pass_filter(data, low_pass_fraction=2 * apix / low_pass,
                                    high_pass_fraction=2.0 / max(data.shape))
    if denoise:
        from ..core.denoise import denoise_image

        data = denoise_image(data, method=denoise)
    if transpose > 0 or (transpose < 0 and is_vertical(data)):
        data = data.T.contiguous()
    if horizontalize:
        data, theta_best, shift_best = auto_horizontalize(data, refine=True)
        logger.debug("auto_horizontalize: rotation=%.2f deg shift=%.1f A",
                     theta_best, shift_best * apix)
    return data


def derive_task_geometry(
    data_shape,
    apix2d_orig: float,
    rise: float,
    rise_range,
    tilt_range,
    tube_length: float,
    tube_diameter: float,
    tube_diameter_inner: float,
    reconstruct_length: float,
    target_apix2d: float,
    target_apix3d: float,
    estimated_diameter: float | None = None,
):
    """Physical-size bookkeeping. Returns a dict of the derived sizes in
    Angstroms/pixels."""
    ny, nx = data_shape
    if tube_diameter < 0:
        # estimator output is in PIXELS; the fallback for a degenerate
        # image must be a pixel count too
        diameter = estimated_diameter if estimated_diameter else ny / 2.5
        tube_diameter = int(min(ny, diameter) * apix2d_orig * 2.5)
    if tube_length < 0:
        if tube_diameter > ny * apix2d_orig / 2:
            tube_length = int(nx * apix2d_orig)
        else:
            tube_length = round(
                np.sqrt((nx * apix2d_orig) ** 2 / 4 - tube_diameter**2 / 4) * 2
            )
    reconstruct_diameter = (
        tube_diameter if 0 < tube_diameter < ny * apix2d_orig else ny * apix2d_orig
    )
    reconstruct_diameter_inner = (
        tube_diameter_inner if 0 < tube_diameter_inner < reconstruct_diameter else 0
    )
    if reconstruct_length < rise:
        reconstruct_length = max(
            min(3 * np.max(rise_range), tube_length),
            round(np.tan(np.deg2rad(np.max(np.abs(tilt_range)))) * tube_diameter * 3),
        )
    if target_apix2d < apix2d_orig:
        target_apix2d = apix2d_orig
    return dict(
        tube_diameter=tube_diameter,
        tube_length=tube_length,
        reconstruct_diameter=reconstruct_diameter,
        reconstruct_diameter_inner=reconstruct_diameter_inner,
        reconstruct_length=reconstruct_length,
        target_apix2d=target_apix2d,
        target_apix3d=target_apix3d,
    )


def _pixel_geometry(g, data_shape, rise):
    """Angstrom -> pixel conversions."""
    ny, nx = data_shape
    target_apix2d = g["target_apix2d"]
    target_apix3d = g["target_apix3d"]
    if target_apix3d < 0:
        vol = (
            g["reconstruct_length"]
            * (g["reconstruct_diameter"] ** 2 - g["reconstruct_diameter_inner"] ** 2)
            / 4
            * np.pi
        )
        target_apix3d = max(
            target_apix2d, round(np.power(vol / (nx * ny), 1 / 3) + 0.5)
        )
    elif target_apix3d == 0:
        target_apix3d = target_apix2d

    d3 = int(round(g["reconstruct_diameter"] / target_apix3d))
    d3 += d3 % 2
    d3_inner = int(round(g["reconstruct_diameter_inner"] / target_apix3d))
    d2 = int(round(g["reconstruct_diameter"] / target_apix2d))
    d2 += d2 % 2
    l2_angstrom = (
        g["tube_length"]
        if 0 < g["tube_length"] < nx * target_apix2d
        else nx * target_apix2d
    )
    l2 = int(l2_angstrom / target_apix2d)
    l2 += l2 % 2
    if g["reconstruct_length"] > 0:
        l3 = max(
            int(np.ceil(rise / target_apix3d)),
            int(np.ceil(g["reconstruct_length"] / target_apix3d)),
        )
        l3 += l3 % 2
    else:
        l3 = int(l2 * target_apix2d / target_apix3d + 0.5)
        l3 += l3 % 2
    return dict(
        d2=d2, l2=l2, d3=d3, l3=l3, d3_inner=d3_inner,
        target_apix2d=target_apix2d, target_apix3d=target_apix3d,
    )


def auto_sym_oversample(l3, d3, d3_inner, return_3d=False):
    """~2^20 constrained voxels target."""
    n_voxels = l3 * (d3**2 - d3_inner**2)
    ratio = 2**20 / max(1, n_voxels)
    if ratio < 10:
        so = max(1, int(round(ratio)))
    elif ratio < 100:
        so = max(1, int(round(ratio / 10)) * 10)
    else:
        so = max(1, int(round(ratio / 100)) * 100)
    if return_3d:
        so *= 2
    return so
