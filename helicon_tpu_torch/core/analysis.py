"""Geometry analysis the denovo3d prep chain needs: the cylindrical
volume mask and the grayscale-moment helix rotation/diameter estimator.

Counterpart of ``helicon_tpu/core/analysis.py:438`` (``_binary_closing``),
``:447`` (``estimate_helix_rotation_center_diameter``) and ``:504``
(``get_cylindrical_mask``). The moments and morphology are host numpy and
scipy, as in the reference; the one rotation runs through the port's
``transform_image`` on the CPU.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["estimate_helix_rotation_center_diameter", "get_cylindrical_mask"]


def _binary_closing(mask: np.ndarray) -> np.ndarray:
    """Binary closing with a 3x3 cross (edge values kept, skimage-like)."""
    from scipy import ndimage as ndi

    structure = ndi.generate_binary_structure(2, 1)
    dil = ndi.binary_dilation(mask, structure=structure)
    return ndi.binary_erosion(dil, structure=structure, border_value=1)


def estimate_helix_rotation_center_diameter(
    data, estimate_rotation: bool = True, estimate_center: bool = True, threshold: float = 0
):
    """Grayscale-moment estimate of helix rotation, y-shift, and diameter.

    Threshold + closing mask, then intensity-weighted second moments give
    the principal axis angle; the image is rotated level and the
    centroid/extent measured again. Returns (rotation_deg, shift_y,
    diameter_px).
    """
    from ..angular import set_to_periodic_range
    from .transforms import transform_image

    data = np.asarray(data, np.float32)
    ny, nx = data.shape

    def weighted_params(mask, intensity):
        ys, xs = np.where(mask)
        if len(ys) < 2:
            return 0.0, 0.0, ny
        w = intensity[ys, xs].astype(np.float64)
        w = w - w.min() + 1e-8
        cw = w.sum()
        cy = (ys * w).sum() / cw
        cx = (xs * w).sum() / cw
        uy = ys - cy
        ux = xs - cx
        i_yy = (uy * uy * w).sum() / cw
        i_xx = (ux * ux * w).sum() / cw
        i_xy = (uy * ux * w).sum() / cw
        theta = 0.5 * math.atan2(2.0 * i_xy, i_yy - i_xx)
        angle = math.degrees(theta) + 90.0
        if abs(angle) > 90.0:
            angle -= 180.0
        diameter = int(ys.max() - ys.min() + 1)
        shift = ny // 2 - cy if estimate_center else 0.0
        return angle, shift, diameter

    mask = _binary_closing(data > threshold)
    if not mask.any():
        return 0.0, 0.0, ny

    if estimate_rotation:
        rotation, _, _ = weighted_params(mask, data)
        rotation = set_to_periodic_range(rotation, min=-180, max=180)
        data_rot = transform_image(data, rotation=rotation).numpy()
    else:
        rotation = 0.0
        data_rot = data

    mask_rot = _binary_closing(data_rot > threshold)
    if not mask_rot.any():
        return rotation, 0.0, ny
    _, shift_y, diameter = weighted_params(mask_rot, data_rot)
    return rotation, shift_y, diameter


def get_cylindrical_mask(nz, ny, nx, rmin=0, rmax=-1, return_xyz: bool = False):
    """Boolean cylinder mask (axis = Z); optionally the (Z, Y, X) grids."""
    k = np.arange(nz, dtype=np.int32) - nz // 2
    j = np.arange(ny, dtype=np.int32) - ny // 2
    i = np.arange(nx, dtype=np.int32) - nx // 2
    Z, Y, X = np.meshgrid(k, j, i, indexing="ij")
    if rmax < 0:
        rmax = ny // 2 - 1
    mask = X * X + Y * Y < rmax * rmax
    if 0 < rmin < rmax:
        mask &= X * X + Y * Y >= rmin * rmin
    if return_xyz:
        return mask, (Z, Y, X)
    return mask
