"""Helix orientation of a class average: is the filament vertical, and the
rotation and shift that lay it horizontally through the centre.

Counterpart of ``helicon_tpu/helix/orient.py:24`` (``is_vertical``) and
``:32`` (``auto_horizontalize``). The rotations run on the device of the
image given; the moment estimate and the Nelder-Mead search run on the
host (numpy, scipy), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["is_vertical", "auto_horizontalize"]


def is_vertical(data) -> bool:
    """True if the filament runs predominantly vertically: the largest
    column sum exceeds the largest row sum."""
    data = torch.as_tensor(data, dtype=torch.float32)
    return bool(data.sum(dim=0).max() > data.sum(dim=1).max())


def auto_horizontalize(data, refine: bool = False):
    """Rotate and shift an image so the helix lies horizontally through the
    centre: the moment estimate, then with ``refine`` a Nelder-Mead search
    (xtol 1e-2) for the rotation and y-shift that maximize the mirror
    symmetry (std of the folded row profile) of the rotated image, then an
    order-3 rotation. Returns (image tensor on data's device, theta_degree,
    shift_y_pixel)."""
    from ..core.analysis import estimate_helix_rotation_center_diameter
    from ..core.transforms import rotate_shift_image

    data = torch.as_tensor(data, dtype=torch.float32)
    data_work = torch.clamp_min(data, 0)
    theta, shift_y, _ = estimate_helix_rotation_center_diameter(data.cpu().numpy())

    if refine:
        from scipy.optimize import fmin

        def score_rotation_shift(x):
            th, sy = x
            tmp = rotate_shift_image(data_work, angle=th, post_shift=(sy, 0))
            y = tmp.sum(dim=1)[1:].cpu().numpy()
            return -np.std(y + y[::-1])

        theta, shift_y = fmin(score_rotation_shift, x0=(theta, shift_y), xtol=1e-2, disp=0)

    out = rotate_shift_image(data, angle=theta, post_shift=(shift_y, 0), order=3)
    return out, float(theta), float(shift_y)
