"""Rotation matrices of the Euler conventions the port uses, on tensors.

Counterpart of ``helicon_tpu/core/rotation.py`` (``rot_x`` :23, ``rot_y``
:37, ``rot_z`` :51, ``euler_matrix`` :68, ``apply_rotation`` :89): scipy's
``Rotation.from_euler(seq, angles)`` semantics, uppercase axes intrinsic,
lowercase extrinsic; a matrix acts on column vectors (R @ v). Angles are
degrees; the matrices are float32 and batch over leading axes, on the
device of the angles given as a tensor, else on the keyword ``device``
(the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensors import on_device

__all__ = ["rot_x", "rot_y", "rot_z", "euler_matrix", "apply_rotation", "cos_sin"]

_DEG = np.float32(np.pi / 180)


def cos_sin(theta: torch.Tensor):
    """float32 cos and sin of the symmetry-copy angles theta (radians), the
    one place the core evaluates them (the denovo3d projectors' is
    ``projector_separable.cos_sin``). XLA's and PyTorch's float32 cos / sin
    differ by one unit in the last place on some angles; at twist 30 deg,
    where sin is 1/2, that moves samples across a voxel edge (ROADMAP
    C11)."""
    return torch.cos(theta), torch.sin(theta)


def _c_s(angle_deg, device):
    a = on_device(angle_deg, device) * float(_DEG)
    return torch.cos(a), torch.sin(a)


def _matrix(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_x(angle_deg, *, device="cuda") -> torch.Tensor:
    c, s = _c_s(angle_deg, device)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(angle_deg, *, device="cuda") -> torch.Tensor:
    c, s = _c_s(angle_deg, device)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(angle_deg, *, device="cuda") -> torch.Tensor:
    c, s = _c_s(angle_deg, device)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[c, -s, z], [s, c, z], [z, z, o]])


_AXES = {"x": rot_x, "y": rot_y, "z": rot_z}


def euler_matrix(seq: str, angles, *, device="cuda") -> torch.Tensor:
    """Rotation matrix of an Euler sequence (degrees): uppercase (intrinsic)
    R = R(a1) @ R(a2) @ R(a3), lowercase (extrinsic) R = R(a3) @ R(a2) @
    R(a1)."""
    angles = torch.atleast_1d(on_device(angles, device))
    mats = [_AXES[ax.lower()](angles[..., i]) for i, ax in enumerate(seq)]
    if seq.isupper():
        out = mats[0]
        for m in mats[1:]:
            out = out @ m
    elif seq.islower():
        out = mats[0]
        for m in mats[1:]:
            out = m @ out
    else:
        raise ValueError(f"mixed-case Euler sequence {seq!r} not supported")
    return out


def apply_rotation(matrix, vectors, inverse: bool = False, *, device="cuda") -> torch.Tensor:
    """Rotate (..., 3) vectors by R (v @ R^T); ``inverse=True`` applies R^T
    (v @ R). A stack of matrices (..., 3, 3) rotates its own vectors."""
    matrix = on_device(matrix, device, None)
    vectors = torch.as_tensor(vectors, device=matrix.device)
    if inverse:
        return vectors @ matrix
    return vectors @ matrix.transpose(-1, -2)
