"""The proc3d options: apix, clip, fft_resample, flip_hand, helical_sym,
z_moving_average and denoiseCurvelet.

Counterpart of ``helicon_tpu/ops/proc3d/volume_ops.py``, with its
parameters, its messages and its deviation notes. Each handler takes and
returns the map as a float32 tensor on the command's device.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...utils.exceptions import HeliconError
from ...utils.system import parse_param_str, validate_param_dict
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _params(param, defaults):
    _, pd_ = parse_param_str(param)
    pd_, changed, unsupported = validate_param_dict(param=pd_, param_ref=defaults)
    if unsupported:
        logger.warning("ignoring unknown parameters: %s", unsupported)
    return pd_


def _add_apix(parser):
    parser.add_argument(
        "--apix", type=float, metavar="<A/pixel>", default=0,
        help="set the voxel size of the output map",
    )


def _h_apix(data, args, index_d, param, apix, nx, ny, nz):
    if param:
        apix = float(param)
        index_d["apix"] += 1
    return data, apix, nx, ny, nz


def _add_clip(parser):
    parser.add_argument(
        "--clip", type=str, default="",
        metavar="new_nx=<n>:new_ny=<n>:new_nz=<n>:center_x=<n>:center_y=<n>:center_z=<n>",
        help="crop/pad the map around a center",
    )


def _h_clip(data, args, index_d, param, apix, nx, ny, nz):
    from ...core.transforms import get_clip3d

    if param:
        pd_ = _params(
            param,
            dict(new_nx=nx, new_ny=ny, new_nz=nz,
                 center_x=nx // 2, center_y=ny // 2, center_z=nz // 2),
        )
        new_nx, new_ny, new_nz = (
            int(pd_["new_nx"]), int(pd_["new_ny"]), int(pd_["new_nz"])
        )
        if min(new_nx, new_ny, new_nz) < 1:
            raise HeliconError("new_nx/new_ny/new_nz must be > 0")
        data = get_clip3d(
            data,
            z0=int(pd_["center_z"]) - new_nz // 2,
            y0=int(pd_["center_y"]) - new_ny // 2,
            x0=int(pd_["center_x"]) - new_nx // 2,
            nz=new_nz, ny=new_ny, nx=new_nx,
        )
        nx, ny, nz = new_nx, new_ny, new_nz
    return data, apix, nx, ny, nz


def _add_fft_resample(parser):
    parser.add_argument(
        "--fft_resample", type=str, default="",
        metavar="new_nx=<n>:new_ny=<n>:new_nz=<n>",
        help="Fourier-resample the map to a new size",
    )


def _h_fft_resample(data, args, index_d, param, apix, nx, ny, nz):
    from ...core.transforms import fft_rescale

    if param:
        pd_ = _params(param, dict(new_nx=nx, new_ny=ny, new_nz=nz))
        new_nx, new_ny, new_nz = (
            int(pd_["new_nx"]), int(pd_["new_ny"]), int(pd_["new_nz"])
        )
        if min(new_nx, new_ny, new_nz) < 1:
            raise HeliconError("new_nx/new_ny/new_nz must be > 0")
        if len({new_nx / nx, new_ny / ny, new_nz / nz}) > 1:
            logger.warning(
                "FFT-resampling %dx%dx%d -> %dx%dx%d gives nonuniform "
                "pixel sizes", nx, ny, nz, new_nx, new_ny, new_nz,
            )
        fft = fft_rescale(
            data.to(torch.float32),
            apix=apix,
            cutoff_res=(
                2 * apix * nz / new_nz,
                2 * apix * ny / new_ny,
                2 * apix * nx / new_nx,
            ),
            output_size=(new_nz, new_ny, new_nx),
        )
        # DEVIATION from the original helicon's fft_resample.py:107, which
        # takes np.abs(), rectifying every negative voxel of a normalized
        # density map (solvent noise is negative). The inverse FFT of a
        # resampled real map is real up to rounding; real() is the correct
        # projection (as helicon_tpu takes it).
        data = torch.fft.ifftn(fft).real * (new_nx * new_ny * new_nz / (nx * ny * nz))
        del fft
        apix = round(apix * nx / new_nx, 4)
        nx, ny, nz = new_nx, new_ny, new_nz
    return data, apix, nx, ny, nz


def _add_flip_hand(parser):
    parser.add_argument(
        "--flip_hand", type=str, metavar="<x|y|z>", default="",
        help="mirror the map along one axis (handedness flip)",
    )


def _h_flip_hand(data, args, index_d, param, apix, nx, ny, nz):
    from ...core.transforms import flip_hand

    if param:
        axis = param.lower()
        if axis not in ("x", "y", "z"):
            raise HeliconError(f"invalid axis: {axis}")
        data = flip_hand(data, axis=axis)
    return data, apix, nx, ny, nz


def _add_helical_sym(parser):
    parser.add_argument(
        "--helical_sym", type=str, default="",
        metavar="twist=<deg>:rise=<A>[:csym=<n>][:center_len=<A>]"
        "[:center_n_rise=<n>][:center_fraction=<f>][:new_apix=<A>]"
        "[:new_nz=<n>][:new_nxy=<n>]",
        help="apply helical/cyclic symmetry averaging",
    )


def _h_helical_sym(data, args, index_d, param, apix, nx, ny, nz):
    from ...core.transforms import apply_helical_symmetry

    if param:
        pd_ = _params(
            param,
            dict(twist=0.0, rise=0.0, csym=1, center_len=0.0,
                 center_n_rise=0.0, center_fraction=0.0, new_apix=apix,
                 new_nz=nz, new_nxy=nx),
        )
        twist = float(pd_["twist"])
        rise = float(pd_["rise"])
        csym = int(pd_.get("csym", 1))
        if rise <= 0:
            raise HeliconError("rise (>0) must be specified")
        if csym <= 0:
            raise HeliconError("csym (>0) must be specified")
        new_apix = float(pd_.get("new_apix", apix))
        new_nz = int(pd_["new_nz"])
        new_nxy = int(pd_["new_nxy"])
        center_len = float(pd_["center_len"])
        center_n_rise = float(pd_["center_n_rise"])
        center_fraction = float(pd_["center_fraction"])
        n_set = sum(v > 0 for v in (center_len, center_n_rise, center_fraction))
        if n_set != 1:
            raise HeliconError(
                "exactly one of center_len / center_n_rise / center_fraction "
                "must be specified"
            )
        if center_len > 0:
            if center_len < rise:
                raise HeliconError(f"center_len must be > rise (= {rise} A)")
            center_fraction = center_len / (nz * apix)
        elif center_n_rise > 0:
            center_fraction = center_n_rise * rise / (nz * apix)
        center_fraction = max(rise / (nz * apix), min(1.0, center_fraction))
        data = apply_helical_symmetry(
            data=data.to(torch.float32),
            apix=apix,
            twist_degree=twist,
            rise_angstrom=rise,
            csym=csym,
            fraction=center_fraction,
            new_size=(new_nz, new_nxy, new_nxy),
            new_apix=new_apix,
        )
        apix = new_apix
        nz, ny, nx = data.shape
    return data, apix, nx, ny, nz


def _add_z_moving_average(parser):
    parser.add_argument(
        "--z_moving_average", type=str, default="",
        metavar="length=<A>|n_pixel=<n>",
        help="moving-average filter along z",
    )


def _h_z_moving_average(data, args, index_d, param, apix, nx, ny, nz):
    if param:
        pd_ = _params(param, dict(length=0.0, n_pixel=0))
        length = float(pd_["length"])
        n_pixel = int(float(pd_["n_pixel"]))
        if length <= 0 and n_pixel <= 0:
            raise HeliconError("length (>0) or n_pixel (>0) must be specified")
        if length > 0 and n_pixel > 0:
            raise HeliconError("specify either length or n_pixel, not both")
        if length > 0:
            n_pixel = int(np.round(length / apix))
        if not (1 <= n_pixel <= data.shape[0]):
            raise HeliconError(
                f"z_moving_average window of {n_pixel} pixels (length="
                f"{length} A at {apix} A/pixel) must be in [1, nz={nz}]"
            )
        tmp = torch.cumsum(data.to(torch.float64), dim=0)
        data = data.clone()
        # the reference's slice arithmetic: -n_pixel // 2 floors, so the
        # slice length matches nz - n_pixel
        data[n_pixel // 2 : -n_pixel // 2] = (
            (tmp[n_pixel:] - tmp[:-n_pixel]) / n_pixel
        ).to(data.dtype)
        index_d["z_moving_average"] += 1
    return data, apix, nx, ny, nz


def _add_denoiseCurvelet(parser):
    parser.add_argument(
        "--denoiseCurvelet", type=str, default="",
        metavar="[threshold_sigma=<n>][:n_scales=<n>]",
        help="curvelet-denoise the 3D map",
    )


def _h_denoiseCurvelet(data, args, index_d, param, apix, nx, ny, nz):
    from ...core.curvelet import denoise_curvelet_3d
    from ...utils.system import parse_param_str

    if param is not None:
        _, pd_ = parse_param_str(param) if param else (None, {})
        # the reference's sigma= / numScales= mini-language
        # (proc3d/denoiseCurvelet.py:81-111): transform default mct, and
        # only udct | mct for 3D maps (fdct is 2D-only there)
        transform = str(pd_.get("transform", "mct"))
        if transform not in ("udct", "mct"):
            raise HeliconError(
                f"\tERROR: unknown transform '{transform}' for "
                "--denoiseCurvelet. Use 'udct' or 'mct'."
            )
        sigma = float(pd_.get("sigma", pd_.get("threshold_sigma", 3.0)))
        num_scales = pd_.get("numScales", pd_.get("n_scales", None))
        n_scales = int(num_scales) if num_scales is not None else 4
        # nDirs=0: the isotropic radial bands (cheap mode for huge maps)
        n_dirs = int(pd_.get("nDirs", pd_.get("n_dirs", 6)))
        data = denoise_curvelet_3d(
            data.to(torch.float32), threshold_sigma=sigma, n_scales=n_scales, n_dirs=n_dirs
        )
        index_d["denoiseCurvelet"] += 1
    return data, apix, nx, ny, nz


PLUGINS = [
    Plugin("apix", _add_apix, _h_apix),
    Plugin("clip", _add_clip, _h_clip),
    Plugin("fft_resample", _add_fft_resample, _h_fft_resample),
    Plugin("flip_hand", _add_flip_hand, _h_flip_hand),
    Plugin("helical_sym", _add_helical_sym, _h_helical_sym),
    Plugin("z_moving_average", _add_z_moving_average, _h_z_moving_average),
    Plugin("denoiseCurvelet", _add_denoiseCurvelet, _h_denoiseCurvelet),
]
