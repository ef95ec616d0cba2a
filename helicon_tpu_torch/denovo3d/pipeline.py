"""Image preparation and size bookkeeping for one grid search, and the web
app's single task.

Counterpart of ``helicon_tpu/denovo3d/pipeline.py``: ``prepare_data`` :26,
``derive_task_geometry`` :60, ``_pixel_geometry`` :114,
``auto_sym_oversample`` :159 and ``process_one_task`` :174. The size
bookkeeping is host arithmetic, copied; ``tests/test_torch_prep.py`` pins
it to the originals.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["prepare_data", "derive_task_geometry", "auto_sym_oversample", "process_one_task"]


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


def process_one_task(
    ti,
    ntasks,
    data,
    imageFile,
    imageIndex,
    twist,
    rise,
    rise_range,
    csym,
    tilt,
    tilt_range,
    psi,
    psi_range,
    dy,
    dy_range,
    apix2d_orig,
    denoise,
    low_pass,
    transpose,
    horizontalize,
    target_apix3d,
    target_apix2d,
    thresh_fraction,
    positive_constraint,
    tube_length,
    tube_diameter,
    tube_diameter_inner,
    reconstruct_length,
    sym_oversample,
    interpolation,
    fsc_test,
    return_3d,
    score_metric,
    algorithm,
    verbose,
    n_cpu=1,
    device="cuda",
):
    """One web-app task: one (image, twist, rise, csym, tilt, psi, dy) on
    ``device`` (the card unless the caller asks for "cpu").

    The image (``data``, or image imageIndex (1-based) of imageFile when
    data is None) goes through prepare_data, the geometry
    (derive_task_geometry, the helix estimator's diameter when
    tube_diameter < 0), down_scale to target_apix2d and, with
    thresh_fraction >= 0, the background subtraction and threshold; then
    lsq_reconstruct, refining the pose over the tilt / psi / dy ranges for
    the models lsq, elasticnet, lasso and ridge. The asymmetric unit is
    re-symmetrized to max(nx, 1.2 pitches) at the original pixel size,
    transformed to the (refined) pose, and projected along x and y, with
    the central rise's z-sections, for display. None for a blank image.

    Returns (score, (x projection, y projection, z sections, (rec3d,
    half1, half2) or None, d2, d3, l2, l3), (data_orig, imageFile,
    imageIndex, target_apix3d, target_apix2d, twist, rise, csym, tilt, psi,
    dy)), the arrays float32 numpy, as the reference. ``n_cpu`` is
    accepted and unused."""
    from ..core.analysis import estimate_helix_rotation_center_diameter
    from ..core.filters import down_scale, threshold_data
    from ..core.transforms import apply_helical_symmetry, transform_map
    from ..helix.orient import tilt_psi_dy_str
    from .solver import consume_refined_params, lsq_reconstruct

    if data is None:
        from ..io.mrc import read_image_2d

        data = read_image_2d(imageFile, imageIndex - 1)
    data = torch.as_tensor(np.array(data, np.float32) if not isinstance(data, torch.Tensor)
                           else data, dtype=torch.float32, device=device)
    if not bool(torch.std(data, correction=0) != 0):
        logger.warning("input image %s:%s is blank", imageFile, imageIndex)
        return None
    data = prepare_data(data, apix2d_orig, denoise, low_pass, transpose, horizontalize,
                        device=device)
    ny, nx = data.shape
    ny_orig, nx_orig = ny, nx
    estimated_diameter = None
    if tube_diameter < 0:
        _, _, estimated_diameter = estimate_helix_rotation_center_diameter(data.cpu().numpy())
    g = derive_task_geometry((ny, nx), apix2d_orig, rise, rise_range, tilt_range, tube_length,
                             tube_diameter, tube_diameter_inner, reconstruct_length,
                             target_apix2d, target_apix3d, estimated_diameter)
    target_apix2d = g["target_apix2d"]
    data = down_scale(data, target_apix2d, apix2d_orig)
    ny, nx = data.shape
    if thresh_fraction >= 0:
        nr = min(ny // 2 - 1, int(np.ceil(g["reconstruct_diameter"] / 2 / target_apix2d) + 1))
        # the reference subtracts the median of the two background rows in
        # place on the array it keeps as data_orig, then thresholds a copy
        data = data - torch.quantile(data[[ny // 2 - nr, ny // 2 + nr]].reshape(-1), 0.5)
        data_orig = data
        data = threshold_data(data, thresh_fraction=thresh_fraction)
        data = data / data.max()
    else:
        data_orig = data
    pg = _pixel_geometry(g, (ny, nx), rise)
    target_apix3d = pg["target_apix3d"]
    if sym_oversample <= 0:
        sym_oversample = auto_sym_oversample(pg["l3"], pg["d3"], pg["d3_inner"], return_3d)
    refine_range = None
    if algorithm.get("model", "lsq") in ("lsq", "elasticnet", "lasso", "ridge"):
        r_dict = {}
        if tilt_range[1] > tilt_range[0]:
            r_dict["tilt"] = max(abs(tilt_range[0]), abs(tilt_range[1]))
        if psi_range > 0:
            r_dict["psi"] = psi_range
        if dy_range > 0:
            r_dict["dy"] = dy_range
        refine_range = r_dict or None

    pitch = round(rise * 360 / abs(twist), 1)
    (rec3d, rec3d_set_1, rec3d_set_2), score = lsq_reconstruct(
        projection_image=data, scale2d_to_3d=target_apix2d / target_apix3d, twist_degree=twist,
        rise_pixel=rise / target_apix3d, csym=csym, tilt_degree=tilt, psi_degree=psi,
        dy_pixel=dy / target_apix2d, thresh_fraction=thresh_fraction,
        positive_constraint=positive_constraint,
        reconstruct_diameter_3d_inner_pixel=pg["d3_inner"],
        reconstruct_diameter_2d_pixel=pg["d2"], reconstruct_diameter_3d_pixel=pg["d3"],
        reconstruct_length_2d_pixel=pg["l2"], reconstruct_length_3d_pixel=pg["l3"],
        sym_oversample=sym_oversample, interpolation=interpolation, fsc_test=fsc_test,
        score_metric=score_metric, target_apix2d=target_apix2d, verbose=verbose,
        algorithm=algorithm, refine_tilt_psi_dy_range=refine_range, device=device)

    # re-symmetrize the asymmetric unit to full length at the original
    # pixel size
    twist_degree = twist if abs(twist) < 90 else 180 - abs(twist)
    if abs(twist_degree) > 1e-2:
        pitch_pixel = int(360 / abs(twist_degree) * rise / apix2d_orig + 0.5)
    else:
        pitch_pixel = int(np.ceil(2 * rise / apix2d_orig))
    new_length = max(nx_orig, int(pitch_pixel * 1.2))
    rec3d_xform = apply_helical_symmetry(rec3d, apix=target_apix3d, twist_degree=twist,
                                         rise_angstrom=rise, csym=csym,
                                         new_size=(new_length, ny_orig, ny_orig),
                                         new_apix=apix2d_orig)
    tilt_viz, psi_viz, dy_viz = tilt, psi, dy
    refined = consume_refined_params()
    if refined:
        tilt_viz = refined.get("tilt", tilt)
        psi_viz = refined.get("psi", psi)
        dy_viz = refined.get("dy", dy)
    rec3d_xform_2 = transform_map(rec3d_xform, scale=1.0, tilt=tilt_viz, psi=psi_viz,
                                  dy=dy_viz / apix2d_orig)
    rec3d_x_proj = rec3d_xform_2.sum(dim=2).T
    rec3d_y_proj = rec3d_xform_2.sum(dim=1).T
    if rec3d_y_proj.max() > 0:
        rec3d_y_proj = rec3d_y_proj * (rec3d_x_proj.max() / rec3d_y_proj.max())
    nz_per_rise = max(1, int(np.ceil(rise / apix2d_orig)))
    z0 = rec3d_xform.shape[0] // 2 - nz_per_rise // 2
    rec3d_z_sections = rec3d_xform[z0 : z0 + nz_per_rise].sum(dim=0)
    vmin, vmax = rec3d_z_sections.min(), rec3d_z_sections.max()
    if vmax > vmin:
        lo, hi = rec3d_x_proj.min(), rec3d_x_proj.max()
        rec3d_z_sections = (rec3d_z_sections - vmin) * (hi - lo) / (vmax - vmin) + lo

    def host(t):
        return None if t is None else t.cpu().numpy()

    rec3d_x_proj, rec3d_y_proj, rec3d_z_sections = (
        host(t) for t in (rec3d_x_proj, rec3d_y_proj, rec3d_z_sections))
    vols = (host(rec3d), host(rec3d_set_1), host(rec3d_set_2)) if return_3d else None
    data_orig = host(data_orig)
    logger.info("Task %s/%s: %s-%s: pitch=%sA twist=%s rise=%sA csym=%s%s => score=%.6f",
                ti + 1, ntasks, imageFile, imageIndex, pitch, round(twist, 3), round(rise, 3),
                csym, tilt_psi_dy_str(tilt, psi, dy), score)
    return_data = (rec3d_x_proj, rec3d_y_proj, rec3d_z_sections, vols, pg["d2"], pg["d3"],
                   pg["l2"], pg["l3"])
    metadata = (data_orig, imageFile, imageIndex, target_apix3d, target_apix2d, twist, rise,
                csym, tilt, psi, dy)
    return (score, return_data, metadata)
