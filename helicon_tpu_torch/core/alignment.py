"""2D image registration on ``torch.fft``: the phase correlation, and the
alignment over flip x polarity x (scale, angle) built on it.

Counterpart of ``helicon_tpu/core/alignment.py:22``
(``phase_cross_correlation``, which the web app's montage registration
calls) and ``:44`` (``align_images``). Numpy input goes to the keyword
``device`` (the card unless the caller asks for the CPU); a tensor keeps
its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensors import on_device
from .analysis import cross_correlation_coefficient
from .filters import generate_tapering_filter, threshold_data
from .transforms import pad_to_size, transform_image

__all__ = ["align_images", "phase_cross_correlation"]


def phase_cross_correlation(reference_image, moving_image, *, device="cuda"):
    """Integer-pixel shift maximizing the phase correlation (skimage's
    normalization="phase", no upsampling): the (row, col) shift to apply to
    moving_image to align it with reference_image, each wrapped into
    (-n/2, n/2]. Runs on the device of the tensors given. Returns (shifts
    float64 numpy, None, None)."""
    ref = on_device(reference_image, device)
    mov = torch.as_tensor(moving_image, dtype=torch.float32, device=ref.device)
    cross = torch.fft.fft2(ref) * torch.conj(torch.fft.fft2(mov))
    cross = cross / torch.clamp_min(torch.abs(cross), 1e-12)
    cc = torch.fft.ifftn(cross, dim=(-2, -1)).real
    idx = np.unravel_index(int(torch.argmax(cc)), tuple(cc.shape))
    shifts = np.asarray(idx, np.float64)
    for d, n in enumerate(ref.shape):
        if shifts[d] > n // 2:
            shifts[d] -= n
    return shifts, None, None


def align_images(image_moving, image_ref, scale_range, angle_range, check_polarity: bool = True,
                 check_flip: bool = True, return_aligned_moving_image: bool = False, *,
                 device="cuda"):
    """Align image_moving to image_ref over flip x polarity x (scale,
    angle), each pose's shift from the phase correlation and its score the
    correlation inside the moved taper (scipy's Nelder-Mead over (log
    scale, angle), or a bounded search over the angle when scale_range is
    0; neither when both ranges are 0). The images live on image_ref's
    device; the optimizer runs on the host.

    Returns (scale, angle_deg, shift (y, x) numpy, score[, the raw moving
    image at the winning pose]); with check_flip a leading bool (flipped)
    is prepended.
    """
    image_ref = on_device(image_ref, device)
    dev = image_ref.device
    image_moving = torch.as_tensor(image_moving, device=dev).to(torch.float32)
    assert 0 <= scale_range < 1, f"scale_range={scale_range} out of [0, 1)"

    if check_flip:
        kw = dict(check_polarity=check_polarity, check_flip=False,
                  return_aligned_moving_image=return_aligned_moving_image)
        result = align_images(image_moving, image_ref, scale_range, angle_range, **kw)
        result_flip = align_images(torch.flip(image_moving, dims=(0,)), image_ref, scale_range,
                                   angle_range, **kw)
        if result_flip[3] > result[3]:
            return (True, *result_flip)
        return (False, *result)

    taper_mov = generate_tapering_filter(tuple(image_moving.shape), fraction_start=(0.8, 0.8),
                                         device=dev)
    padded_taper = pad_to_size(taper_mov, tuple(image_ref.shape))
    padded_mov = pad_to_size(image_moving, tuple(image_ref.shape))
    mov_work = threshold_data(padded_taper * padded_mov, thresh_fraction=-1.0)
    taper_ref = generate_tapering_filter(tuple(image_ref.shape), fraction_start=(0.8, 0.8),
                                         device=dev)
    ref_work = threshold_data(taper_ref * image_ref, thresh_fraction=0.0)

    best = [1e10, 1.0, 0.0, np.zeros(2), None]

    def warp(img, scale, angle, shift):
        return transform_image(img, scale=scale, rotation=angle, post_translation=shift,
                               mode="wrap")

    def scale_rotation_score(x, angle0):
        if isinstance(x, np.ndarray):
            scale, angle = float(np.exp(x[0])), float(x[1])
        else:
            scale, angle = 1.0, float(x)
        angle += angle0
        rotated = transform_image(mov_work, scale=scale, rotation=angle, mode="constant")
        shift, _, _ = phase_cross_correlation(ref_work, rotated)
        shifted = warp(mov_work, scale, angle, shift)
        mask = warp(padded_taper, scale, angle, shift) > 0
        score = -cross_correlation_coefficient(ref_work[mask], shifted[mask])
        if score < best[0]:
            best[0], best[1], best[2] = score, scale, angle
            best[3], best[4] = shift, shifted
        return score

    from scipy.optimize import minimize, minimize_scalar

    for angle0 in [0] + ([180] if check_polarity else []):
        if scale_range > 0:
            minimize(
                scale_rotation_score, x0=np.array([0.0, 0.0]), args=(angle0,),
                bounds=[(-np.log(1 + scale_range), np.log(1 + scale_range)),
                        (-angle_range, angle_range)],
                method="Nelder-Mead", options=dict(xatol=0.01),
            )
        elif angle_range > 0:
            minimize_scalar(
                scale_rotation_score, bounds=(angle0 - angle_range, angle0 + angle_range),
                args=(0.0,), method="bounded", options=dict(xatol=0.01),
            )
        # both ranges 0: no optimization, the identity pose (the reference
        # probes neither the polarity flip nor a shift)

    _, scale, angle, shift, aligned_work = best
    if aligned_work is None:
        aligned_work = mov_work
    # the similarity at the winning pose
    mask = warp(padded_taper, scale, angle, shift) > 0
    ret = (scale, angle, shift, cross_correlation_coefficient(ref_work[mask], aligned_work[mask]))
    if return_aligned_moving_image:
        # the raw moving image at the winning pose, not the work image
        ret = (*ret, warp(padded_mov, scale, angle, shift))
    return ret
