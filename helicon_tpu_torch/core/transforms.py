"""Image transforms the denovo3d prep chain needs: ``transform_image``
(rotation about the centre), ``rotate_shift_image`` (rotation about a
centre with pre/post shifts) and ``pad_to_size``.

Counterpart of ``helicon_tpu/core/transforms.py:261``, ``:326`` and
``:401``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .interp import map_coordinates

__all__ = ["transform_image", "rotate_shift_image", "pad_to_size"]


def transform_image(image, rotation: float = 0.0, order: int = 1):
    """Rotate a 2D image by ``rotation`` degrees about its centre (ny/2,
    nx/2), sampling through the inverse map with zeros outside: the
    rotation-only case of the reference's skimage-style affine chain
    (to_center -> rotate -> from_center)."""
    image = torch.as_tensor(image, dtype=torch.float32)
    ny, nx = image.shape
    cy, cx = ny / 2.0, nx / 2.0
    theta = math.radians(rotation)
    M = np.array(
        [
            [math.cos(theta), -math.sin(theta), cx - math.cos(theta) * cx + math.sin(theta) * cy],
            [math.sin(theta), math.cos(theta), cy - math.sin(theta) * cx - math.cos(theta) * cy],
            [0.0, 0.0, 1.0],
        ]
    )
    Minv = np.linalg.inv(M)
    rr, cc = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=image.device),
        torch.arange(nx, dtype=torch.float32, device=image.device),
        indexing="ij",
    )
    x_src = float(Minv[0, 0]) * cc + float(Minv[0, 1]) * rr + float(Minv[0, 2])
    y_src = float(Minv[1, 0]) * cc + float(Minv[1, 1]) * rr + float(Minv[1, 2])
    return map_coordinates(image, (y_src, x_src), order=order, mode="constant")


def rotate_shift_image(data, angle: float = 0, pre_shift=(0, 0), post_shift=(0, 0),
                       rotation_center=None, order: int = 1):
    """Rotate a 2D image by ``angle`` degrees about rotation_center
    (default (ny // 2, nx // 2)) with (y, x) pre/post shifts: the output
    samples the input at m @ out + offset, zeros outside."""
    data = torch.as_tensor(data, dtype=torch.float32)
    if angle == 0 and tuple(pre_shift) == (0, 0) and tuple(post_shift) == (0, 0):
        return data * 1.0
    ny, nx = data.shape
    if rotation_center is None:
        rotation_center = np.array([ny // 2, nx // 2], dtype=np.float64)
    else:
        rotation_center = np.asarray(rotation_center, dtype=np.float64)
    ang = math.radians(angle)
    m = np.array([[math.cos(ang), math.sin(ang)], [-math.sin(ang), math.cos(ang)]])
    offset = -m @ np.asarray(post_shift, dtype=np.float64)
    offset += rotation_center - m @ rotation_center
    offset += -np.asarray(pre_shift, dtype=np.float64)
    rr, cc = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=data.device),
        torch.arange(nx, dtype=torch.float32, device=data.device),
        indexing="ij",
    )
    y_src = float(m[0, 0]) * rr + float(m[0, 1]) * cc + float(offset[0])
    x_src = float(m[1, 0]) * rr + float(m[1, 1]) * cc + float(offset[1])
    return map_coordinates(data, (y_src, x_src), order=order, mode="constant")


def pad_to_size(data, shape):
    """Zero-pad a 2D/3D array or tensor to the target shape, centred."""
    if data.ndim not in (2, 3):
        raise ValueError("pad_to_size takes a 2D or 3D array")
    if tuple(data.shape) == tuple(shape):
        return data
    ny, nx = data.shape[-2:]
    my, mx = shape[-2:]
    yb = max(0, (my - ny) // 2)
    ya = max(0, my - yb - ny)
    xb = max(0, (mx - nx) // 2)
    xa = max(0, mx - xb - nx)
    pads = [(yb, ya), (xb, xa)]
    if data.ndim == 3:
        nz, mz = data.shape[0], shape[0]
        zb = max(0, (mz - nz) // 2)
        pads.insert(0, (zb, max(0, mz - zb - nz)))
    if isinstance(data, torch.Tensor):
        return F.pad(data, [p for pair in reversed(pads) for p in pair])
    return np.pad(data, pads)
