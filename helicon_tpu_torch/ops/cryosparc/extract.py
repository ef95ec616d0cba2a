"""extractParticles: per-micrograph box extraction with recentering,
Fourier cropping, normalization, and fp16 output.

Counterpart of ``helicon_tpu/ops/cryosparc/extract.py``.
``extract_one_micrograph`` (:27) runs on ``args.device`` (the card by
default): the micrograph is read once, memory-mapped, and uploaded once;
its interior boxes are cut with one gather, and the batch is
Fourier-cropped, sign-flipped and normalised together. The few boxes
that cross the micrograph's edge are cut and filled on the host in
particle order, as the reference does, so that ``np.random.default_rng(0)``
gives the same draws; they are then cropped with the batch. The option's
metadata handling is host pandas, copied. CryoSPARC-server job IO is not
supported (no cryosparc-tools): provide local paths / micrographs_cs_file.
tests/test_torch_cryosparc.py pins the port to the original.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from ...utils.exceptions import HeliconError
from ...utils.system import parse_param_str, validate_param_dict
from ..registry import Plugin

logger = logging.getLogger(__name__)

# bytes of particle work one extraction pass may hold on the CPU; on the
# card, a quarter of its free memory
EXTRACT_CHUNK_BYTES_CPU = 1 << 28


def _edge_box(micrograph, x0, y0, box_size, mic_shape, fill_mode, rng):
    """One box that crosses the micrograph's edge, cut and filled on the
    host as the reference does (its zeros from ``rng`` in "random" mode)."""
    xs, xe = max(0, x0), min(int(mic_shape[1]), x0 + box_size)
    ys, ye = max(0, y0), min(int(mic_shape[0]), y0 + box_size)
    clip = np.asarray(micrograph[ys:ye, xs:xe], np.float32)
    buf = np.zeros((box_size, box_size), np.float32)
    buf[ys - y0: ye - y0, xs - x0: xe - x0] = clip
    clip = buf
    if fill_mode:
        zeros = clip == 0
        nz_vals = clip[~zeros]
        if nz_vals.size:
            if fill_mode == "mean":
                clip[zeros] = np.mean(nz_vals)
            elif fill_mode == "random":
                clip[zeros] = rng.normal(np.mean(nz_vals), np.std(nz_vals), int(zeros.sum()))
    return clip


def _chunk_particles(box_size: int, device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 4
    else:
        budget = EXTRACT_CHUNK_BYTES_CPU
    return max(1, budget // (box_size * box_size * 16))


def extract_particles(micrograph, loc_x, loc_y, box_size: int, fft_crop_size: int,
                      mic_shape, sign: int = -1, fill_mode: str = "random",
                      normalize: bool = True, fp16: bool = False, device="cuda") -> np.ndarray:
    """(n, fft_crop_size, fft_crop_size) particle boxes of one micrograph
    (numpy float16 with fp16, else float32), centred at (loc_x, loc_y)
    pixels: cut, Fourier-cropped, sign-flipped (max + min - box with
    sign < 0) and normalised (population std) on ``device``."""
    from ...core.transforms import fft_crop

    n = len(loc_x)
    dtype = np.float16 if fp16 else np.float32
    particles = np.zeros((n, fft_crop_size, fft_crop_size), dtype)
    if n == 0:
        return particles
    x0 = np.asarray(loc_x, np.int64) - box_size // 2
    y0 = np.asarray(loc_y, np.int64) - box_size // 2
    hy = min(int(mic_shape[0]), micrograph.shape[0])
    hx = min(int(mic_shape[1]), micrograph.shape[1])
    interior = (x0 >= 0) & (y0 >= 0) & (x0 + box_size <= hx) & (y0 + box_size <= hy)
    rng = np.random.default_rng(0)
    edges = {i: _edge_box(micrograph, int(x0[i]), int(y0[i]), box_size, mic_shape,
                          fill_mode, rng) for i in np.nonzero(~interior)[0]}
    windows = None
    if interior.any():
        mic = torch.as_tensor(np.array(micrograph, np.float32), device=device)
        windows = mic.unfold(0, box_size, 1).unfold(1, box_size, 1)
    step = _chunk_particles(box_size, device)
    for s in range(0, n, step):
        sl = slice(s, min(n, s + step))
        if windows is None:
            clips = torch.zeros((sl.stop - s, box_size, box_size), device=device)
        else:
            yi = torch.as_tensor(np.where(interior[sl], y0[sl], 0), device=device)
            xi = torch.as_tensor(np.where(interior[sl], x0[sl], 0), device=device)
            clips = windows[yi, xi]
        outer = [i for i in range(sl.start, sl.stop) if not interior[i]]
        if outer:
            clips[torch.as_tensor(outer, device=device) - s] = torch.as_tensor(
                np.stack([edges[i] for i in outer]), device=device)
        if fft_crop_size < box_size:
            clips = fft_crop(clips, output_size=(fft_crop_size, fft_crop_size))
        if sign < 0:
            clips = (clips.amax(dim=(-2, -1), keepdim=True)
                     + clips.amin(dim=(-2, -1), keepdim=True) - clips)
        if normalize:
            std, mean = torch.std_mean(clips, dim=(-2, -1), unbiased=False, keepdim=True)
            clips = torch.where(std != 0, (clips - mean) / torch.where(std != 0, std, 1.0),
                                clips)
        particles[sl] = clips.to(torch.float16 if fp16 else torch.float32).cpu().numpy()
    return particles


def extract_one_micrograph(
    subset: pd.DataFrame,
    box_size: int,
    fft_crop_size: int,
    input_project_folder: Path,
    output_project_folder: Path,
    output_particle_folder: str,
    sign: int = -1,
    fill_mode: str = "random",
    normalize: bool = True,
    fp16: bool = False,
    force: bool = False,
    device="cuda",
) -> pd.DataFrame:
    """Extract all particles of one micrograph on ``device`` and write
    them as one stack."""
    from ...io.mrc import mrc_header, read_mrc, write_mrc

    micrograph_path = subset["location/micrograph_path"].iloc[0]
    micrograph_file = Path(input_project_folder) / micrograph_path
    extracted = f"{output_particle_folder}/{Path(micrograph_path).stem}.mrcs"
    particle_file = Path(output_project_folder) / extracted
    particle_file.parent.mkdir(parents=True, exist_ok=True)
    apix = (
        float(subset["location/micrograph_psize_A"].iloc[0])
        * box_size
        / fft_crop_size
    )

    skip = False
    if not force and particle_file.exists():
        h = mrc_header(particle_file)
        if h.nz == len(subset) and h.ny == h.nx == fft_crop_size:
            skip = True

    if not skip:
        mic_shape = np.asarray(subset["location/micrograph_shape"].iloc[0])
        loc_x = np.rint(
            subset["location/center_x_frac"].values * mic_shape[1]
        ).astype(np.int32)
        loc_y = np.rint(
            subset["location/center_y_frac"].values * mic_shape[0]
        ).astype(np.int32)
        micrograph = np.squeeze(read_mrc(micrograph_file, mmap=True)[0])
        particles = extract_particles(micrograph, loc_x, loc_y, box_size, fft_crop_size,
                                      mic_shape, sign=sign, fill_mode=fill_mode,
                                      normalize=normalize, fp16=fp16, device=device)
        write_mrc(particle_file, particles, apix=apix)

    ret = subset.copy()
    ret["blob/path"] = str(extracted)
    ret["blob/idx"] = np.arange(len(ret))
    ret["blob/shape"] = [(fft_crop_size, fft_crop_size)] * len(ret)
    ret["blob/psize_A"] = apix
    ret["blob/sign"] = sign
    ret["blob/import_sig"] = 1
    return ret


def _add_extractParticles(parser):
    parser.add_argument(
        "--extractParticles", type=str, default="",
        metavar="box_size=<n>[:fft_crop_size=<n>][:recenter=0|1]"
        "[:normalize=0|1][:sign=-1|1][:fp16=0|1][:fill_mode=random|mean]"
        "[:micrographs_cs_file=<f>][:n_micrographs=<n>][:force=0|1]"
        "[:outdir=<dir>]",
        help="extract particle boxes from micrographs",
    )


def _h_extractParticles(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    from ...io.cs import read_cs

    if param:
        defaults = dict(
            box_size=0, fft_crop_size=0, flip_y=0, recenter=1, replace_ctf=0,
            normalize=1, fill_mode="random", sign=-1, n_micrographs=-1,
            fp16=1, micrographs_cs_file="", micrographs_job_id="",
            reuse_job_id="", force=0, plot_pdf=0, outdir="extract",
        )
        _, pd_ = parse_param_str(param)
        pd_, _, unsupported = validate_param_dict(param=pd_, param_ref=defaults)
        if unsupported:
            logger.warning("ignoring unknown parameters: %s", unsupported)
        box_size = int(pd_["box_size"])
        if box_size <= 0:
            raise HeliconError("box_size (>0) must be specified")
        fft_crop_size = int(pd_["fft_crop_size"])
        if fft_crop_size <= 0 or fft_crop_size > box_size:
            fft_crop_size = box_size
        if pd_["micrographs_job_id"]:
            raise HeliconError(
                "micrographs_job_id requires a CryoSPARC server (cryosparc-"
                "tools); use micrographs_cs_file with a local .cs file instead"
            )
        if int(pd_["replace_ctf"]) and not pd_["micrographs_cs_file"]:
            raise HeliconError(
                "micrographs_cs_file must be provided when replace_ctf "
                "is specified"
            )
        if pd_["micrographs_cs_file"]:
            mics = read_cs(pd_["micrographs_cs_file"])
            mdf = pd.DataFrame.from_records(mics.tolist(), columns=mics.dtype.names)
            for c in mdf.columns:  # .cs S-dtype strings arrive as bytes
                if mdf[c].dtype == object and len(mdf) and isinstance(
                    mdf[c].iloc[0], bytes
                ):
                    mdf[c] = mdf[c].str.decode("utf-8")
            if "uid" not in mdf or "micrograph_blob/path" not in mdf:
                raise HeliconError(
                    f"{pd_['micrographs_cs_file']} lacks uid/micrograph_blob "
                    "columns"
                )
            col_mid = "location/micrograph_uid"
            # every particle's micrograph uid must exist
            # (extractparticles.py:180-187)
            missing = set(data[col_mid]) - set(mdf["uid"])
            if missing:
                raise HeliconError(
                    f"{len(missing)} micrograph IDs in the input data are "
                    "not found in the micrographs dataset"
                )
            mdf = mdf.set_index("uid")
            data["location/micrograph_path"] = (
                data[col_mid].map(mdf["micrograph_blob/path"])
            )
            if "micrograph_blob/psize_A" in mdf:
                data["location/micrograph_psize_A"] = data[col_mid].map(
                    mdf["micrograph_blob/psize_A"]
                )
            if "micrograph_blob/shape" in mdf:
                data["location/micrograph_shape"] = data[col_mid].map(
                    mdf["micrograph_blob/shape"]
                )
            # per-micrograph CTF columns: fill the missing ones, or ALL
            # of them with replace_ctf=1 (extractparticles.py:192-222)
            cols_ctf = [c for c in mdf.columns if c.split("/")[0] == "ctf"]
            if int(pd_["replace_ctf"]):
                cols_ctf_to_copy = cols_ctf
            else:
                cols_ctf_to_copy = [c for c in cols_ctf if c not in data]
            for c in cols_ctf_to_copy:
                data[c] = data[col_mid].map(mdf[c])
        if "location/micrograph_path" not in data:
            raise HeliconError(
                "location/micrograph_path required (or provide "
                "micrographs_cs_file)"
            )
        if int(pd_["flip_y"]):
            data["location/center_y_frac"] = 1 - data["location/center_y_frac"]
        if int(pd_["recenter"]) and (
            "alignments3D/shift" in data or "alignments2D/shift" in data
        ):
            # fold alignment shifts into the picked locations, 3D first
            # (extractparticles.py:227-249); shifts are in ALIGNMENT
            # pixels, converted via the alignment psize, then zeroed so
            # downstream jobs do not apply them twice
            prefix = (
                "alignments3D" if "alignments3D/shift" in data else "alignments2D"
            )
            shifts = np.stack(data[f"{prefix}/shift"].values)
            if f"{prefix}/psize_A" in data:
                align_psize = np.asarray(data[f"{prefix}/psize_A"].values, float)
            elif "blob/psize_A" in data:
                align_psize = np.asarray(data["blob/psize_A"].values, float)
            else:
                align_psize = 1.0
            mic_psize = (
                np.asarray(data["location/micrograph_psize_A"].values, float)
                if "location/micrograph_psize_A" in data
                else 1.0
            )
            shapes = np.stack(data["location/micrograph_shape"].values)
            data["location/center_x_frac"] = (
                data["location/center_x_frac"]
                - align_psize * shifts[:, 0] / mic_psize / shapes[:, 1]
            )
            data["location/center_y_frac"] = (
                data["location/center_y_frac"]
                - align_psize * shifts[:, 1] / mic_psize / shapes[:, 0]
            )
            data[f"{prefix}/shift"] = [
                np.zeros(2, np.float32) for _ in range(len(data))
            ]
        outdir = str(pd_["outdir"])
        groups = list(data.groupby("location/micrograph_path", sort=False))
        n_mics = int(pd_["n_micrographs"])
        if n_mics > 0:
            groups = groups[:n_mics]
            logger.info("extracting only the first %d micrographs", n_mics)
        results = []
        for _, subset in groups:
            results.append(
                extract_one_micrograph(
                    subset,
                    box_size,
                    fft_crop_size,
                    Path("."),
                    Path("."),
                    outdir,
                    sign=int(pd_["sign"]),
                    fill_mode=str(pd_["fill_mode"]),
                    normalize=bool(int(pd_["normalize"])),
                    fp16=bool(int(pd_["fp16"])),
                    force=bool(int(pd_["force"])),
                    device=getattr(args, "device", "cuda"),
                )
            )
        attrs = dict(data.attrs)
        data = pd.concat(results).reset_index(drop=True)
        data.attrs.update(attrs)
        output_slots.add("blob")
        output_slots.add("location")
        output_title += f"->extracted {len(data)} particles"
    return data, output_title, output_slots, index_d


PLUGINS = [Plugin("extractParticles", _add_extractParticles, _h_extractParticles)]
