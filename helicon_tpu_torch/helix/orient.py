"""Helix orientation of a class average (is the filament vertical, and the
rotation and shift that lay it horizontally through the centre) and the
symmetrized-map helpers of the web app: the x / y / z projections, the
symmetrize-then-reorient chain and the pose label.

Counterpart of ``helicon_tpu/helix/orient.py:24`` (``is_vertical``),
``:32`` (``auto_horizontalize``), ``:64`` (``generate_xyz_projections``),
``:77`` (``symmetrize_transform_map``) and ``:109`` (``tilt_psi_dy_str``).
The rotations run on the device of the image or map given (numpy on the
keyword ``device``, the card unless the caller asks for the CPU); the moment
estimate and the Nelder-Mead search run on the host (numpy, scipy), as in
the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensors import on_device

__all__ = ["is_vertical", "auto_horizontalize", "generate_xyz_projections",
           "symmetrize_transform_map", "tilt_psi_dy_str"]


def is_vertical(data, *, device="cuda") -> bool:
    """True if the filament runs predominantly vertically: the largest
    column sum exceeds the largest row sum."""
    data = on_device(data, device)
    return bool(data.sum(dim=0).max() > data.sum(dim=1).max())


def auto_horizontalize(data, refine: bool = False, *, device="cuda"):
    """Rotate and shift an image so the helix lies horizontally through the
    centre: the moment estimate, then with ``refine`` a Nelder-Mead search
    (xtol 1e-2) for the rotation and y-shift that maximize the mirror
    symmetry (std of the folded row profile) of the rotated image, then an
    order-3 rotation. Returns (image tensor on data's device, theta_degree,
    shift_y_pixel)."""
    from ..core.analysis import estimate_helix_rotation_center_diameter
    from ..core.transforms import rotate_shift_image

    data = on_device(data, device)
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


def generate_xyz_projections(map3d, is_amyloid: bool = False, apix=None, *, device="cuda"):
    """The x, y and z sum-projections of a map (sums over axes 2, 1, 0); an
    amyloid's z one sums only the central 4.75 A rung."""
    map3d = on_device(map3d, device, None)
    proj_xyz = [map3d.sum(dim=i) for i in (2, 1, 0)]
    if is_amyloid:
        nz = map3d.shape[0]
        nz_center = int(round(4.75 / apix))
        z0 = nz // 2 - nz_center // 2
        proj_xyz[-1] = map3d[z0 : z0 + nz_center].sum(dim=0)
    return proj_xyz


def symmetrize_transform_map(data, apix: float, twist_degree: float, rise_angstrom: float,
                             csym: int = 1, fraction: float = 1.0, new_size=None, new_apix=None,
                             axial_rotation: float = 0, tilt: float = 0, *, device="cuda"):
    """A 3D map low-passed to new_apix's Nyquist when it coarsens the
    pixel, helically symmetrized (apply_helical_symmetry), then rotated by
    axial_rotation and tilted (transform_map) when either is nonzero. Runs
    on the device of the map given."""
    from ..core.filters import low_high_pass_filter
    from ..core.transforms import apply_helical_symmetry, transform_map

    data = on_device(data, device)
    if new_apix is not None and new_apix > apix:
        data = low_high_pass_filter(data, low_pass_fraction=apix / new_apix)
    m = apply_helical_symmetry(data, apix=apix, twist_degree=twist_degree,
                               rise_angstrom=rise_angstrom, csym=csym, new_size=new_size,
                               new_apix=new_apix, fraction=fraction)
    if axial_rotation or tilt:
        m = transform_map(m, rot=axial_rotation, tilt=tilt)
    return m


def tilt_psi_dy_str(tilt, psi, dy, sep=" ", sep2="=", unit: bool = True) -> str:
    """A compact ``tilt=..° psi=..° dy=..Å`` label of the nonzero parts."""
    s = ""
    if tilt:
        s += f"{sep}tilt{sep2}{round(tilt, 2)}" + ("°" if unit else "")
    if psi:
        s += f"{sep}psi{sep2}{round(psi, 2)}" + ("°" if unit else "")
    if dy:
        s += f"{sep}dy{sep2}{round(dy, 2)}" + ("Å" if unit else "")
    return s
