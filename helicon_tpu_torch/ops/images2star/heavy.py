"""Compute-heavy options: recoverFullFilaments, estimateHelicalAngleVariance,
calibratePixelSize, extractHelices, maskGold, denoiseCurvelet, process.

Reference: plugins/images2star/{recoverfullfilaments (412 LoC),
estimatehelicalanglevariance (353), calibratepixelsize (263),
extracthelices (173), maskgold (172), denoisecurvelet (371), process}.py.
The reference fans these out over joblib/thread pools.

The port's counterpart of ``helicon_tpu/ops/images2star/heavy.py``. The
options that touch pixels run on the command's device (``args.device``,
the card by default): calibratePixelSize's power spectra and polar
sampling (float64), extractHelices' strips (each micrograph uploaded
once), maskGold's high-pass filter and denoiseCurvelet. The metadata
logic, and maskGold's median, MAD, labelling, area filter and noise, stay
pandas, numpy and scipy on the host, as in the original.
recoverFullFilaments, estimateHelicalAngleVariance and process are copies.
tests/test_torch_images2star.py holds the options to the original.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from ...utils.collections import first_matched_attr, unique_attr_name
from ...utils.exceptions import HeliconError
from ...utils.path_utils import convert_dataframe_file_path
from ...utils.system import parse_param_str
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _unique_out_path(outdir: Path, src_name, used: dict) -> Path:
    """outdir/<basename> unless a DIFFERENT source already claimed that
    name (micrographs with equal basenames in different folders would
    silently overwrite each other); collisions get a resolved-path hash.
    """
    out = outdir / Path(src_name).name
    prev = used.get(str(out))
    if prev is not None and prev != str(src_name):
        import hashlib

        tag = hashlib.sha1(str(src_name).encode()).hexdigest()[:8]
        p = Path(src_name)
        out = outdir / f"{p.stem}-{tag}{p.suffix}"
    used[str(out)] = str(src_name)
    return out


# ------------------------------------------------------------------
# recoverFullFilaments (recoverfullfilaments.py)
# ------------------------------------------------------------------


def _add_recoverFullFilaments(parser):
    parser.add_argument(
        "--recoverFullFilaments", type=str, default="",
        metavar="minFraction=<f>[:forcePickJob=<0|1>][:fullStarFile=<file>]",
        help="re-add segments so kept filaments have >= minFraction of "
        "their original segments (undo Select2D fragmentation)",
    )


def get_input_star_file(starFile, arg="--i "):
    """Parse a RELION job's note.txt for the given command argument and
    return the referenced star file, resolved against the project folder
    (reference recoverfullfilaments.py:64-89). None when the star file is
    not inside a RELION job folder (no job_pipeline.star / note.txt)."""
    from pathlib import Path

    sf = Path(starFile).resolve()
    pipelineFile = sf.parent / "job_pipeline.star"
    if not pipelineFile.exists():
        return None
    noteFile = sf.parent / "note.txt"
    if not noteFile.exists():
        return None
    relionProjectFolder = noteFile.parent.parent.parent
    with open(noteFile) as fp:
        for line in fp.readlines()[::-1]:
            pos = line.find(arg)
            if pos == -1:
                continue
            l2 = line[pos:]
            pos2 = l2.find(" --")
            s = l2[:pos2] if pos2 != -1 else l2
            name = s[len(arg):].strip('"').strip().split()[0]
            return str(relionProjectFolder / name)
    return None


def trace_back_to_extract_job(inputStarFile, forcePickJob=0, history=None):
    """Walk RELION note.txt provenance back to the Extract/Polish star
    the particles came from (reference recoverfullfilaments.py:93-120).
    Appends every visited file to `history`; returns None when the trace
    dead-ends before reaching an Extract/Polish job."""
    if history is None:
        history = []
    history.append(str(inputStarFile))
    new_star = get_input_star_file(inputStarFile)
    if new_star is None:
        return None
    if "Polish" in new_star or "Extract" in new_star:
        if not forcePickJob:
            history.append(new_star)
            return new_star
        parent_pick = get_input_star_file(new_star, arg="--coord_list ")
        parent_reextract = get_input_star_file(
            new_star, arg="--reextract_data_star "
        )
        if parent_pick and "Pick" in parent_pick:
            history.append(new_star)
            return new_star
        if parent_reextract:
            history.append(new_star)
            return trace_back_to_extract_job(
                parent_reextract, forcePickJob, history
            )
    return trace_back_to_extract_job(new_star, forcePickJob, history)


def _h_recoverFullFilaments(data, args, index_d, param):
    from ...io.metadata import images2dataframe

    if len(param):
        pd_ = parse_param_str(param)[1] if "=" in param else {}
        required = "rlnImageName rlnHelicalTubeID".split()
        forcePickJob = int(pd_.get("forcePickJob", 0))
        if forcePickJob:
            required += (
                "rlnMicrographName rlnCoordinateX rlnCoordinateY "
                "rlnHelicalTrackLengthAngst"
            ).split()
        missing = [p for p in required if p not in data]
        assert not missing, f"required parameters {' '.join(missing)} missing"
        fullStarFile = pd_.get("fullStarFile", None)
        if fullStarFile is None:
            # auto-trace the Extract/Polish job from RELION note.txt
            # provenance (reference recoverfullfilaments.py:64-130)
            history: list = []
            fullStarFile = trace_back_to_extract_job(
                args.input_imageFiles[0], forcePickJob, history
            )
            if getattr(args, "verbose", 0) > 2:
                logger.info("\t%s", "\t->\n\t".join(history))
            if fullStarFile is None:
                if len(history) > 1:
                    fullStarFile = history[-1]
                    logger.warning(
                        "auto-traced back to '%s' but it is not a Polish/"
                        "Extract star file; using it for recovery — specify "
                        "--recoverFullFilaments fullStarFile=<file> to "
                        "override",
                        fullStarFile,
                    )
                else:
                    raise HeliconError(
                        "--recoverFullFilaments: the input star is not "
                        "inside a RELION project (no note.txt provenance); "
                        "specify fullStarFile=<file> explicitly"
                    )
        data = data.drop_duplicates(subset=["rlnImageName"], keep="last").reset_index(
            drop=True
        )
        data2 = images2dataframe(
            fullStarFile,
            alternative_folders=getattr(args, "folder", []),
            ignore_bad_particle_path=getattr(args, "ignoreBadParticlePath", 0),
            ignore_bad_micrograph_path=getattr(args, "ignoreBadMicrographPath", 1),
            warn_missing_ctf=0,
            target_convention="relion",
        )
        data2 = data2.drop_duplicates(
            subset=["rlnImageName"], keep="last"
        ).reset_index(drop=True)
        missing = [p for p in required if p not in data2]
        assert not missing, f"{fullStarFile} missing {' '.join(missing)}"
        if len(data) > len(data2):
            raise HeliconError(
                f"--recoverFullFilaments: {fullStarFile} must contain >= "
                f"{len(data)} particles"
            )
        key = "rlnImageName_abs"
        data[key] = (
            convert_dataframe_file_path(data, "rlnImageName", to="abs")
            .str.split("@", expand=True).iloc[:, -1]
        )
        data2[key] = (
            convert_dataframe_file_path(data2, "rlnImageName", to="abs")
            .str.split("@", expand=True).iloc[:, -1]
        )
        groups = dict(list(data.groupby([key, "rlnHelicalTubeID"], sort=False)))
        groups2 = dict(list(data2.groupby([key, "rlnHelicalTubeID"], sort=False)))
        missing_helices = [k for k in groups if k not in groups2]
        geom_cols = "rlnMicrographName rlnCoordinateX rlnCoordinateY".split()
        can_match_geometrically = all(
            c in data and c in data2 for c in geom_cols
        )
        if (forcePickJob or missing_helices) and can_match_geometrically:
            # different Extract/Pick jobs: exact stack keys cannot match;
            # match filaments by micrograph + endpoint colinearity
            # (reference recoverfullfilaments.py:246-307)
            helices = _match_filaments_by_geometry(data, data2, fullStarFile)
        elif missing_helices:
            raise HeliconError(
                f"{len(missing_helices)} helices of the input are absent in "
                f"{fullStarFile}; both files must come from the same Extract "
                "job (or provide rlnMicrographName/rlnCoordinateX/Y on both "
                "sides for geometric matching)"
            )
        else:
            helices = [
                (len(groups[k]), len(groups2[k]), list(groups2[k].index))
                for k in groups
            ]
        minFraction = float(pd_.get("minFraction", -1))
        if not (0 <= minFraction <= 1):
            n1 = sum(h[0] for h in helices)
            n2 = sum(h[1] for h in helices)
            ng = sum(h[0] for h in helices if h[0] / h[1] >= 0.5)
            minFraction = min(0.5, max(0, (n1 - ng) / max(1, n2 - 2 * ng)))
            logger.info("minFraction set to %.2f", minFraction)
        indices = []
        for n1, n2, helix_indices in helices:
            if n1 / n2 >= minFraction:
                indices += helix_indices
        attrs = dict(data2.attrs)
        data = data2.loc[sorted(indices)].drop(columns=[key]).reset_index(drop=True)
        data.attrs.update(attrs)
        index_d["recoverFullFilaments"] += 1
    return data, index_d


# ------------------------------------------------------------------
# estimateHelicalAngleVariance (estimatehelicalanglevariance.py)
# ------------------------------------------------------------------


def _add_estimateHelicalAngleVariance(parser):
    parser.add_argument(
        "--estimateHelicalAngleVariance", type=int, metavar="<0|1>", default=0,
        help="add per-filament tilt/psi/rot variance columns",
    )


def _h_estimateHelicalAngleVariance(data, args, index_d, param):
    from scipy.stats import circmean, circstd

    from ...angular import angular_difference

    if param:
        required = (
            "rlnImageName rlnHelicalTubeID rlnHelicalTrackLengthAngst "
            "rlnAngleTilt rlnAnglePsi rlnAngleRot"
        ).split()
        missing = [p for p in required if p not in data]
        assert not missing, f"required parameters {' '.join(missing)} missing"
        key = "rlnImageName_abs"
        data[key] = (
            convert_dataframe_file_path(data, "rlnImageName", to="abs")
            .str.split("@", expand=True).iloc[:, -1]
        )
        for _, g in data.groupby([key, "rlnHelicalTubeID"], sort=False):
            tilt = g["rlnAngleTilt"].astype(np.float32).values
            data.loc[g.index, "rlnAngleTiltSigma"] = round(
                float(np.rad2deg(circstd(np.deg2rad(tilt)))), 2
            )
            psi = g["rlnAnglePsi"].astype(np.float32).values
            psi = np.rad2deg(np.arccos(np.cos(2 * np.deg2rad(psi))))
            data.loc[g.index, "rlnAnglePsiSigma"] = round(
                float(np.rad2deg(circstd(np.deg2rad(psi))) / 2), 2
            )
            rot = g["rlnAngleRot"].astype(np.float32).values
            if len(rot) > 1:
                pos = g["rlnHelicalTrackLengthAngst"].astype(np.float32).values
                dpos = pos[1:] - pos[:-1]
                dpos[dpos == 0] = 1e-6
                delta_rot = angular_difference(rot[1:], rot[:-1]) / dpos
                rot_sigma = float(np.rad2deg(circstd(np.deg2rad(delta_rot))))
                # per-filament rot change rate (deg/A), wrap-unwrapped
                rot_u = np.rad2deg(np.unwrap(np.deg2rad(rot.astype(np.float64))))
                i, j = np.triu_indices(len(rot_u), k=1)
                dp = pos[j] - pos[i]
                ok = dp != 0
                rates = (rot_u[j][ok] - rot_u[i][ok]) / dp[ok]
                data.loc[g.index, "rlnAngleRotRate"] = round(
                    float(np.median(rates)) if len(rates) else 0.0, 4
                )
            else:
                rot_sigma = 0.0
            data.loc[g.index, "rlnAngleRotSigma"] = round(rot_sigma, 2)
        data.drop(columns=[key], inplace=True)
        index_d["estimateHelicalAngleVariance"] += 1
    return data, index_d


# ------------------------------------------------------------------
# calibratePixelSize (calibratepixelsize.py)
# ------------------------------------------------------------------


def _add_calibratePixelSize(parser):
    choices = "graphene graphene_oxide go gold ice".split()
    parser.add_argument(
        "--calibratePixelSize", type=str, default="no",
        metavar="<%s>" % "|".join(choices),
        help="calibrate pixel size against the diffraction ring of a "
        "standard sample (graphene 2.13 A, gold 2.355 A, ice 3.661 A). "
        "default: no",
    )


# images' pixels and polar samples of a calibratePixelSize chunk, at most
CALIBRATE_CHUNK_SAMPLES = 1 << 24


def _h_calibratePixelSize(data, args, index_d, param):
    """Find the standard sample's diffraction ring in the power spectra
    and rescale the pixel size so the ring lands at its known resolution
    (reference calibratepixelsize.py: polar NUFFT sampling of the
    +/-5% annulus; here the fft power spectrum is sampled on the same
    polar grid with bilinear interpolation — no finufft dependency).

    The spectra and the sampling run on the command's device in float64
    (complex128), a chunk of images a call; the curve's median, MAD and
    argmax on the host."""
    import torch

    from ...commands import command_device
    from ...core.interp import map_coordinates
    from ...io.metadata import getPixelSize, setPixelSize
    from ...io.mrc import read_mrc

    if param and param != "no":
        standards = dict(
            graphene=2.13, graphene_oxide=2.13, go=2.13, gold=2.355, ice=3.661
        )  # Angstrom (calibratepixelsize.py:47-50)
        if str(param).lower() not in standards:
            raise HeliconError(
                f"--calibratePixelSize: unknown standard {param!r}; "
                f"supported: {' '.join(standards)}"
            )
        target_res = standards[str(param).lower()]
        apix, pixelSize_source = getPixelSize(data, return_pixelSize_source=True)
        if apix is None:
            raise HeliconError(
                "cannot find rlnImagePixelSize or rlnMicrographPixelSize"
            )
        apix = float(apix)
        half_corner_res = 1.0 / (1 / (2 * apix) * (1 + np.sqrt(2)) / 2)
        if target_res <= half_corner_res:
            raise HeliconError(
                f"target resolution {target_res} A for {param} is beyond "
                f"the limit ({half_corner_res:.2f} A)"
            )
        search_range = 0.05  # +/- 5% (calibratepixelsize.py:61)
        corner_res = 2 * apix / np.sqrt(2)
        res_low = target_res * (1 + search_range)
        res_high = max(corner_res, target_res * (1 - search_range))
        r_samples = 100  # 0.1% radial steps
        theta_samples = (
            int(
                np.pi
                / ((1 / res_high - 1 / res_low) / (r_samples - 1) / (1 / target_res))
            )
            + 1
        )
        freqs = np.linspace(1 / res_low, 1 / res_high, r_samples)  # 1/A
        thetas = np.linspace(0, np.pi, theta_samples, endpoint=False)

        mapping = dict(
            rlnImagePixelSize="rlnImageName",
            rlnMicrographPixelSize="rlnMicrographName",
        )
        name_col = mapping.get(pixelSize_source, "rlnImageName")
        if name_col not in data:
            name_col = next(c for c in mapping.values() if c in data)
        imageFiles = (
            data[name_col].astype(str).str.split("@", expand=True)
            .iloc[:, -1].unique()
        )

        device = command_device(getattr(args, "device", "cuda"))
        curves, weights = [], []
        for f in imageFiles:
            imgs, _ = read_mrc(f, mmap=True)
            if imgs.ndim == 2:
                imgs = imgs[None]
            n_img, ny, nx = imgs.shape
            # polar sample positions in (row, col) pixel units of the
            # shifted spectrum: freq f (1/A) -> f * N * apix pixels
            fy = freqs[None, :] * np.sin(thetas)[:, None] * ny * apix + ny // 2
            fx = freqs[None, :] * np.cos(thetas)[:, None] * nx * apix + nx // 2
            fy = torch.as_tensor(fy, dtype=torch.float64, device=device)
            fx = torch.as_tensor(fx, dtype=torch.float64, device=device)
            chunk = max(1, CALIBRATE_CHUNK_SAMPLES // (ny * nx + fy.numel()))
            pwr_1d = None
            for i0 in range(0, n_img, chunk):
                x = torch.as_tensor(
                    np.array(imgs[i0 : i0 + chunk], np.float32), device=device
                ).to(torch.float64)
                F = torch.fft.fftshift(
                    torch.abs(torch.fft.fft2(x)), dim=(-2, -1)
                )  # (n, ny, nx)
                # one 3D sampling of the chunk: an integral image coordinate
                # takes each image's own bilinear samples (its second tap
                # has weight 0)
                b = torch.arange(F.shape[0], dtype=torch.float64, device=device)
                pwr = map_coordinates(
                    F, (b[:, None, None], fy[None], fx[None]), order=1,
                    mode="nearest",
                )  # (n, theta, r)
                m = pwr.amax(dim=(0, 1))
                pwr_1d = m if pwr_1d is None else torch.maximum(pwr_1d, m)
                del x, F, pwr
            pwr_1d = pwr_1d.cpu().numpy()
            pwr_1d = pwr_1d - np.median(pwr_1d)
            from scipy.stats import median_abs_deviation

            mad = median_abs_deviation(pwr_1d)
            curves.append(pwr_1d / (mad if mad > 0 else 1.0))
            weights.append(n_img)
        pwr_mean = np.average(np.stack(curves), axis=0, weights=weights)
        res_peak = 1.0 / freqs[int(np.argmax(pwr_mean))]
        apix_new = round(apix * target_res / res_peak, 3)  # 0.1% precision
        if apix_new != apix:
            setPixelSize(data, apix_new=apix_new, update_defocus=True)
            logger.info(
                "calibrated %s: %.4f -> %.4f A (%s ring %.3f A found at "
                "%.3f A)", pixelSize_source, apix, apix_new, param,
                target_res, res_peak,
            )
        else:
            logger.info("pixel size %.4f A is accurate; no adjustment", apix)
        index_d["calibratePixelSize"] += 1
    return data, index_d


# ------------------------------------------------------------------
# extractHelices (extracthelices.py)
# ------------------------------------------------------------------


def _add_extractHelices(parser):
    parser.add_argument(
        "--extractHelices", type=str, action="append", default=[],
        metavar="width=<px>:outPath=<dir>[:topLength=<n>]"
        "[:topLengthFraction=<f>][:lengthCutoffAngst=<A>]",
        help="extract whole filaments from micrographs as straightened strips",
    )


def _h_extractHelices(data, args, index_d, param):
    """Rotated-strip extraction of whole filaments (reference
    extracthelices.py: ThreadPool; here each micrograph is uploaded to the
    command's device once and its strips cut there by get_rotated_clip)."""
    import torch

    from ...commands import command_device
    from ...core.transforms import get_rotated_clip
    from ...io.mrc import mrc_header, read_mrc, write_mrc
    from ...io.star import read_star

    if len(param):
        pd_ = parse_param_str(param)[1] if "=" in param else {}
        width = int(pd_.get("width", 300))
        outPath = Path(pd_.get("outPath", "./helicon.helices/")).resolve()
        topLength = pd_.get("topLength", None)
        topLengthFraction = pd_.get("topLengthFraction", None)
        lengthCutoffAngst = pd_.get("lengthCutoffAngst", None)
        outPath.mkdir(parents=True, exist_ok=True)

        rows = []
        apix_by_mic = {}
        for _, rec in data.iterrows():
            mic_name = rec["rlnMicrographName"]
            coordfile = rec.get("rlnCoordinateFileName", rec.iloc[-1])
            if mic_name not in apix_by_mic:
                apix_by_mic[mic_name] = mrc_header(mic_name).apix
            apix = apix_by_mic[mic_name]
            blocks = read_star(coordfile)
            cf = next(
                (v for v in blocks.values() if isinstance(v, pd.DataFrame)), None
            )
            if cf is None:
                continue
            cf = cf[["rlnCoordinateX", "rlnCoordinateY"]].reset_index(drop=True)
            starts = cf.iloc[::2].reset_index(drop=True)
            ends = cf.iloc[1::2].reset_index(drop=True)
            for (sx, sy), (ex, ey) in zip(starts.values, ends.values):
                rows.append(
                    dict(
                        startX=sx, startY=sy, endX=ex, endY=ey,
                        rlnMicrographName=mic_name,
                        helixLength=np.hypot(ex - sx, ey - sy) * apix,
                    )
                )
        if not rows:
            raise HeliconError(
                "--extractHelices: no filament coordinates found in the "
                "coordinate star files"
            )
        coord_df = pd.DataFrame(rows).sort_values("helixLength", ascending=False)
        if topLengthFraction:
            coord_df = coord_df.iloc[: int(len(coord_df) * float(topLengthFraction))]
        if topLength:
            coord_df = coord_df.iloc[: int(topLength)]
        if lengthCutoffAngst:
            coord_df = coord_df[coord_df["helixLength"] >= float(lengthCutoffAngst)]
        # length sort applied the top-N/cutoff filters above; regroup by
        # micrograph for extraction so the single-entry micrograph cache
        # actually works (interleaved micrographs re-read each full
        # multi-hundred-MB file once per helix)
        coord_df = coord_df.sort_values(
            ["rlnMicrographName", "helixLength"],
            ascending=[True, False], kind="stable",
        )
        device = command_device(getattr(args, "device", "cuda"))
        out_rows = []
        mic_cache = {}
        for hi, rec in enumerate(coord_df.itertuples()):
            if rec.rlnMicrographName not in mic_cache:
                mic_cache.clear()  # one micrograph at a time
                mic = np.squeeze(read_mrc(rec.rlnMicrographName)[0]).astype(np.float32)
                mic_cache[rec.rlnMicrographName] = torch.as_tensor(mic, device=device)
            mic = mic_cache[rec.rlnMicrographName]
            strip = get_rotated_clip(
                mic, rec.startY, rec.startX, rec.endY, rec.endX, width
            ).cpu().numpy()
            out = outPath / f"helix_{hi:05d}.mrc"
            write_mrc(out, strip, apix=apix_by_mic[rec.rlnMicrographName])
            out_rows.append(
                dict(
                    rlnImageName=f"000001@{out}",
                    rlnMicrographName=rec.rlnMicrographName,
                    helixLength=rec.helixLength,
                )
            )
        attrs = dict(data.attrs)
        data = pd.DataFrame(out_rows)
        data.attrs.update(attrs)
        index_d["extractHelices"] += 1
    return data, index_d


# ------------------------------------------------------------------
# maskGold (maskgold.py)
# ------------------------------------------------------------------


def _add_maskGold(parser):
    parser.add_argument(
        "--maskGold", type=str, action="append", default=[],
        metavar="value_sigma=<n>:gradient_sigma=<A>:min_area=<A^2>"
        ":both_sides=<0|1>:outdir=<dir>:force=<0|1>",
        help="mask electron-dense gold/ice pixels in particles or micrographs",
    )


def gold_mask(img, apix, value_sigma, gradient_sigma, min_area, both_sides, device):
    """maskGold's decision on one image: (the image it masks, a float32
    host array, high-passed on `device` when gradient_sigma > 0; the
    outlier mask; the median; the MAD). The median, MAD, labelling and
    area filter run on the host, as in the original."""
    import torch
    from scipy import ndimage

    from ...core.filters import low_high_pass_filter

    if gradient_sigma > 0:
        frac = 2 * apix / gradient_sigma
        x = torch.as_tensor(img, device=device)
        img = (x - low_high_pass_filter(x, low_pass_fraction=min(frac, 1.0))).cpu().numpy()
    med = np.median(img)
    mad = np.median(np.abs(img - med)) + 1e-12
    outlier = img > med + value_sigma * mad * 1.4826
    if both_sides:
        outlier |= img < med - value_sigma * mad * 1.4826
    # drop connected regions smaller than min_area
    lab, n = ndimage.label(outlier)
    if n:
        areas = ndimage.sum(outlier, lab, range(1, n + 1)) * apix * apix
        small = np.isin(lab, np.where(areas < min_area)[0] + 1)
        outlier &= ~small
    return img, outlier, med, mad


def _h_maskGold(data, args, index_d, param):
    from ...commands import command_device
    from ...io.mrc import mrc_header, read_image_2d, write_mrc

    if param:
        attrs_required = "rlnImageName rlnMicrographName".split()
        attrSrc = first_matched_attr(data, attrs_required)
        if attrSrc is None:
            raise HeliconError(
                f"input lacks all of the columns: {' '.join(attrs_required)}"
            )
        _, pd_ = parse_param_str(param)
        value_sigma = float(pd_.get("value_sigma", 4.0))
        gradient_sigma = float(pd_.get("gradient_sigma", 0))
        min_area = float(pd_.get("min_area", 100))
        both_sides = int(pd_.get("both_sides", 1))
        force = int(pd_.get("force", 1))
        outdir = Path(
            pd_.get("outdir", Path(getattr(args, "output_starFile", "maskGold")).stem)
        )
        outdir.mkdir(parents=True, exist_ok=True)

        attr = unique_attr_name(data, attr_prefix=f"{attrSrc}Orig")
        data[attr] = data[attrSrc]
        tmp = data[attrSrc].str.split("@", expand=True)
        names = tmp.iloc[:, -1]
        pids = tmp.iloc[:, 0] if tmp.shape[1] > 1 else pd.Series(1, index=data.index)

        # auto gradient_sigma for large micrographs (maskgold.py:83-94)
        if gradient_sigma == 0:
            h0 = mrc_header(names.iloc[0])
            if h0.ny > 2048 and h0.nx > 2048:
                gradient_sigma = float(np.sqrt(min_area) * 10)

        rng = np.random.default_rng(0)
        device = command_device(getattr(args, "device", "cuda"))

        def _mask_one(img, apix):
            img, outlier, med, mad = gold_mask(
                img, apix, value_sigma, gradient_sigma, min_area, both_sides, device
            )
            noise = rng.normal(med, mad * 1.4826, size=img.shape)
            return np.where(outlier, noise, img).astype(np.float32)

        used_out: dict = {}
        for name, particles in names.groupby(names, sort=False):
            out = _unique_out_path(outdir, name, used_out)
            if out.exists():
                if out.samefile(name):
                    # (maskgold.py:100-104) never overwrite the source
                    raise HeliconError(
                        f"output {out.as_posix()} will overwrite original image"
                    )
                if not force:
                    h_out = mrc_header(out)
                    if h_out.nz == len(particles):
                        new_names = (
                            pd.Series(
                                range(1, len(particles) + 1),
                                index=particles.index,
                            ).map("{:06d}".format)
                            + "@"
                            + str(out)
                        )
                        if attrSrc == "rlnImageName":
                            data.loc[particles.index, attrSrc] = new_names.values
                        else:
                            data.loc[particles.index, attrSrc] = str(out)
                        continue  # reuse the existing masked stack
            h = mrc_header(name)
            apix = h.apix or 1.0
            if attrSrc == "rlnImageName":
                imgs = []
                for pid in pids.loc[particles.index].astype(int):
                    img = read_image_2d(
                        name, int(pid) - 1 if tmp.shape[1] > 1 else 0
                    )
                    imgs.append(_mask_one(img, apix))
                write_mrc(out, np.stack(imgs), apix=apix)
                new_names = (
                    pd.Series(
                        range(1, len(imgs) + 1), index=particles.index
                    ).map("{:06d}".format)
                    + "@"
                    + str(out)
                )
                data.loc[particles.index, attrSrc] = new_names.values
            else:
                # micrograph fallback: mask each unique path ONCE and
                # write a 2D micrograph (the per-row loop used to mask
                # slice 0 N times and emit an N-slice "micrograph")
                img = read_image_2d(name, 0)
                write_mrc(out, _mask_one(img, apix), apix=apix)
                data.loc[particles.index, attrSrc] = str(out)
        index_d["maskGold"] += 1
    return data, index_d


# ------------------------------------------------------------------
# denoiseCurvelet (denoisecurvelet.py)
# ------------------------------------------------------------------


def _add_denoiseCurvelet(parser):
    parser.add_argument(
        "--denoiseCurvelet", type=str, action="append", default=[],
        nargs="?", const="",
        metavar="[transform=<mct|udct|fdct>][:sigma=<n>][:numScales=<n>]"
        "[:tileSize=<n>][:overlap=<n>][:outdir=<dir>]",
        help="curvelet-denoise particle images or micrographs "
        "(bare flag = MCT defaults, like the reference)",
    )


def _h_denoiseCurvelet(data, args, index_d, param):
    import torch

    from ...commands import command_device
    from ...core.curvelet import BATCH_PIXELS
    from ...core.curvelet import denoise_curvelet_2d as _dn2d
    from ...core.curvelet import denoise_curvelet_2d_tiled
    from ...io.mrc import mrc_header, read_image_2d, write_mrc

    # reference denoisecurvelet.py: a bare flag (param == "") runs with
    # defaults; only param=None (option absent) is a no-op
    if param is not None:
        _, pd_ = parse_param_str(param) if param else (None, {})
        transform = str(pd_.get("transform", "mct"))
        if transform not in ("mct", "udct", "fdct"):
            raise HeliconError(
                f"\tERROR: unknown transform '{transform}' for "
                "--denoiseCurvelet. Choose from: mct, udct, fdct"
            )
        # gpu= is validated before any file IO (reference
        # denoisecurvelet.py:287-290); on TPU the accelerator choice is
        # the backend's, so a truthy gpu flag is only meaningful as the
        # reference's mct incompatibility check
        gpu_flag = str(pd_.get("gpu", "")).lower() in ("1", "true", "yes")
        if transform == "mct" and gpu_flag:
            raise HeliconError(
                "\tERROR: MCT does not support GPU. Use transform=udct "
                "for GPU."
            )
        # reference knob is sigma= (<= 0 selects the elbow threshold);
        # threshold_sigma= accepted as the historical alias
        threshold_sigma = float(
            pd_.get("sigma", pd_.get("threshold_sigma", 3.0))
        )
        num_scales = pd_.get("numScales", None)
        n_scales = int(num_scales) if num_scales is not None else None
        if n_scales is not None and n_scales < 2:
            n_scales = None  # reference: values < 2 trigger auto-decide
        tile_size = pd_.get("tileSize", None)
        tile_size = int(tile_size) if tile_size is not None else None
        overlap = int(pd_.get("overlap", 32))
        # absolute output paths in the rewritten table (reference
        # denoisecurvelet.py:76,177 resolves outdir)
        outdir = Path(pd_.get("outdir", None) or "./denoised/").resolve()

        extra = dict(n_scales=n_scales) if n_scales is not None else {}
        if tile_size is not None:
            def denoise_curvelet_2d(img, transform, threshold_sigma):
                return denoise_curvelet_2d_tiled(
                    img, tile_size=tile_size, overlap=overlap,
                    transform=transform, threshold_sigma=threshold_sigma,
                    **extra,
                )
        else:
            def denoise_curvelet_2d(img, transform, threshold_sigma):
                return _dn2d(
                    img, transform=transform,
                    threshold_sigma=threshold_sigma, **extra,
                )

        device = command_device(getattr(args, "device", "cuda"))
        has_img = "rlnImageName" in data
        has_mic = "rlnMicrographName" in data
        if not has_img and not has_mic:
            # reference: skip with a note — downstream options still run
            if getattr(args, "verbose", 0):
                logger.info(
                    "\tdenoiseCurvelet: no rlnImageName or "
                    "rlnMicrographName column in data, skipping"
                )
            index_d["denoiseCurvelet"] += 1
            return data, index_d
        outdir.mkdir(parents=True, exist_ok=True)
        attrSrc = "rlnImageName" if has_img else "rlnMicrographName"
        tmp = data[attrSrc].str.split("@", expand=True)
        names = tmp.iloc[:, -1]
        pids = tmp.iloc[:, 0] if tmp.shape[1] > 1 else pd.Series(1, index=data.index)
        used_out: dict = {}
        if attrSrc == "rlnMicrographName":
            # micrograph fallback (reference denoisecurvelet.py:173-252):
            # each unique path denoised ONCE however many rows reference
            # it, all paths in one call through the seam
            # core.curvelet.curvelet_denoise_batch_<transform> (a patch of
            # that attribute intercepts the whole batch); the micrographs
            # stay on the host and the batch takes them to the device one
            # at a time
            unique = list(dict.fromkeys(names))
            imgs, apixes = [], {}
            for name in unique:
                hdr = mrc_header(name)
                if hdr.nz > 1:
                    raise HeliconError(
                        "\tERROR: --denoiseCurvelet micrograph fallback "
                        f"expects 2D MRC files in rlnMicrographName. {name} "
                        "has 3 dimensions. Use helicon proc3d "
                        "--denoiseCurvelet for 3D maps."
                    )
                imgs.append(read_image_2d(name, 0))
                apixes[name] = hdr.apix
            if tile_size is not None:
                denoised = [
                    denoise_curvelet_2d(
                        torch.as_tensor(img, device=device), transform=transform,
                        threshold_sigma=threshold_sigma,
                    ).cpu()
                    for img in imgs
                ]
            else:
                from ...core import curvelet as _cv

                batch = getattr(_cv, f"curvelet_denoise_batch_{transform}")
                denoised = batch(imgs, threshold_sigma=threshold_sigma, device=device, **extra)
            new_map = {}
            for name, den in zip(unique, denoised):
                out = _unique_out_path(outdir, name, used_out)
                den = den.cpu().numpy() if isinstance(den, torch.Tensor) else den
                write_mrc(out, np.asarray(den, np.float32), apix=apixes[name])
                new_map[name] = str(out)
            data[attrSrc] = names.map(new_map).values
            index_d["denoiseCurvelet"] += 1
            return data, index_d
        for name, particles in names.groupby(names, sort=False):
            apix = mrc_header(name).apix
            out = _unique_out_path(outdir, name, used_out)
            imgs = np.stack([
                read_image_2d(name, int(pid) - 1)
                for pid in pids.loc[particles.index].astype(int)
            ])
            if tile_size is not None:
                dens = [
                    denoise_curvelet_2d(
                        torch.as_tensor(img, device=device), transform=transform,
                        threshold_sigma=threshold_sigma,
                    ).cpu().numpy()[None]
                    for img in imgs
                ]
            else:
                # a stack's images in chunks on the device, each image
                # thresholded on its own noise level
                per = max(1, BATCH_PIXELS // (imgs.shape[1] * imgs.shape[2]))
                dens = [
                    denoise_curvelet_2d(
                        torch.as_tensor(imgs[i : i + per], device=device),
                        transform=transform, threshold_sigma=threshold_sigma,
                    ).cpu().numpy()
                    for i in range(0, len(imgs), per)
                ]
            imgs = np.concatenate(dens)
            write_mrc(out, imgs, apix=apix)
            new_names = (
                pd.Series(
                    range(1, len(imgs) + 1), index=particles.index
                ).map("{:06d}".format)
                + "@"
                + str(out)
            )
            data.loc[particles.index, attrSrc] = new_names.values
        index_d["denoiseCurvelet"] += 1
    return data, index_d


# ------------------------------------------------------------------
# process (plugins/images2star/process.py — vestigial in the reference)
# ------------------------------------------------------------------


def _add_process(parser):
    parser.add_argument(
        "--process", type=str, nargs="+", metavar="<proc>", action="append",
        default=[], help="(vestigial in the reference; unsupported)",
    )


def _h_process(data, args, index_d, param):
    if param:
        raise HeliconError(
            "--process is vestigial: the reference implementation calls "
            "helicon.dataframe_jspr2dict/outplaceprocs which do not exist "
            "(plugins/images2star/process.py:50-57)"
        )
    return data, index_d


PLUGINS = [
    Plugin(
        "recoverFullFilaments", _add_recoverFullFilaments, _h_recoverFullFilaments
    ),
    Plugin(
        "estimateHelicalAngleVariance",
        _add_estimateHelicalAngleVariance,
        _h_estimateHelicalAngleVariance,
    ),
    Plugin("calibratePixelSize", _add_calibratePixelSize, _h_calibratePixelSize),
    Plugin("extractHelices", _add_extractHelices, _h_extractHelices),
    Plugin("maskGold", _add_maskGold, _h_maskGold),
    Plugin("denoiseCurvelet", _add_denoiseCurvelet, _h_denoiseCurvelet),
    Plugin("process", _add_process, _h_process),
]


def _match_filaments_by_geometry(data, data2, fullStarFile):
    """Match input filaments to full-filament candidates by endpoint
    colinearity per micrograph (reference recoverfullfilaments.py:246-307:
    both input endpoints must lie ON the candidate's line segment within
    epsilon=1 pixel). Returns [(n_input_segments, n_full_segments,
    full_indices)] like the exact-key path."""

    def on_line_segment(px, py, ax, ay, bx, by, epsilon=1.0):
        d1 = np.hypot(px - ax, py - ay)
        d2 = np.hypot(px - bx, py - by)
        d = np.hypot(bx - ax, by - ay)
        return abs(d - d1 - d2) < epsilon

    # one record PER FULL FILAMENT: several input fragments of the same
    # fragmented filament merge into it (appending per fragment used to
    # emit the full filament's particles once per matching fragment)
    by_full: dict = {}
    mgraphs2 = dict(list(data2.groupby("rlnMicrographName", sort=False)))
    for mgraph_name, mg in data.groupby("rlnMicrographName", sort=False):
        if mgraph_name not in mgraphs2:
            logger.error("micrograph %s is not in %s", mgraph_name, fullStarFile)
            continue
        filaments2 = list(
            mgraphs2[mgraph_name].groupby("rlnHelicalTubeID", sort=False)
        )
        for tube_id, seg in mg.groupby("rlnHelicalTubeID", sort=False):
            cx = seg["rlnCoordinateX"].astype(float).values
            cy = seg["rlnCoordinateY"].astype(float).values
            matched = False
            for tube2_id, seg2 in filaments2:
                cx2 = seg2["rlnCoordinateX"].astype(float).values
                cy2 = seg2["rlnCoordinateY"].astype(float).values
                if on_line_segment(
                    cx[0], cy[0], cx2[0], cy2[0], cx2[-1], cy2[-1]
                ) and on_line_segment(
                    cx[-1], cy[-1], cx2[0], cy2[0], cx2[-1], cy2[-1]
                ):
                    matched = True
                    rec = by_full.get((mgraph_name, tube2_id))
                    if rec is None:
                        by_full[(mgraph_name, tube2_id)] = [
                            len(seg), len(seg2), list(seg2.index),
                        ]
                    else:
                        rec[0] += len(seg)
                    break  # a fragment belongs to one full filament
            if not matched:
                logger.warning(
                    "%s:helicalTubeID=%s: cannot find a matching helix in %s",
                    mgraph_name, tube_id, fullStarFile,
                )
    helices = [tuple(v) for v in by_full.values()]
    if not helices:
        raise HeliconError(
            f"--recoverFullFilaments: no filament of the input could be "
            f"matched geometrically to {fullStarFile}"
        )
    return helices
