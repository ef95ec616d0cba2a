"""2D image registration on ``torch.fft``.

Counterpart of ``helicon_tpu/core/alignment.py:22``
(``phase_cross_correlation``), which the web app's montage registration
calls. ``align_images`` is not ported yet (ROADMAP A12.3).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["phase_cross_correlation"]


def phase_cross_correlation(reference_image, moving_image):
    """Integer-pixel shift maximizing the phase correlation (skimage's
    normalization="phase", no upsampling): the (row, col) shift to apply to
    moving_image to align it with reference_image, each wrapped into
    (-n/2, n/2]. Runs on the device of the tensors given. Returns (shifts
    float64 numpy, None, None)."""
    ref = torch.as_tensor(reference_image, dtype=torch.float32)
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
