"""cryosparc exposure-group + pixel-size options:
assignExposureGroupByBeamShiftLabel, assignExposureGroupByBeamShiftXY,
assignExposureGroupByTime, assignExposureGroupPerMicrograph,
changePixelSize, copyExposureGroupAssignments,
copyExposureGroupParameters, resetExposureGroups, splitByMicrograph.

A copy of ``helicon_tpu/ops/cryosparc/exposure_ops.py`` (host pandas):

- ``data`` duck-typing: handlers accept a pandas DataFrame (the local
  .cs path) or a cryosparc-tools ``Dataset``-alike (server mode) —
  column reads go through ``np.asarray(data[col])``, writes through
  whole-column assignment.
- the helpers of ``io/`` and ``utils/`` are the port's own, imported by
  each handler when it runs.
- ``index_d`` is never touched by a cryosparc handler — the command
  loop advances repeated options itself.

tests/test_torch_cryosparc.py pins the copy to the original.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from ...utils.exceptions import HeliconError
from ...utils.system import parse_param_str, validate_param_dict
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _col(data, name):
    """Column as ndarray — DataFrame and Dataset alike."""
    return np.asarray(data[name])


def _set_where(data, name, mask, value):
    """Masked column write for DataFrame / Dataset / structured alike."""
    arr = np.asarray(data[name]).copy()
    arr[mask] = value
    data[name] = arr


def _ensure_column(data, name, dtype):
    if name in data:
        return
    if hasattr(data, "add_fields"):  # cryosparc-tools Dataset
        data.add_fields([name], [dtype])
    else:
        data[name] = np.zeros(len(data), np.dtype(dtype))


def _add_changePixelSize(parser):
    parser.add_argument(
        "--changePixelSize", type=float, metavar="<Angstrom>", default=0,
        help="change the pixel size to this value. Adjust defocus and Cs "
        "accordingly. disabled by default",
    )


def _h_changePixelSize(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    # reference changepixelsize.py: rescale df (^2) and cs (^4); no
    # title/slots updates
    if param > 0:
        col_apix = "blob/psize_A"
        if col_apix not in data:
            raise HeliconError(f"required parameter {col_apix} is not available")
        apix_orig = float(_col(data, col_apix)[0])
        apix_new = param
        data[col_apix] = np.full(len(data), apix_new, np.float32)
        for col in ("ctf/df1_A", "ctf/df2_A"):
            if col in data:
                data[col] = _col(data, col) * (apix_new / apix_orig) ** 2
        for col in ("ctf/cs_mm",):
            if col in data:
                data[col] = _col(data, col) * (apix_new / apix_orig) ** 4
        if getattr(args, "verbose", 0) > 1:
            logger.info(
                "\tPixel size: %.4f -> %s Angstrom/pixel", apix_orig, apix_new
            )
    return data, output_title, output_slots, index_d


def _add_resetExposureGroups(parser):
    parser.add_argument(
        "--resetExposureGroups", type=int, metavar="<0|1>", default=0,
        help="reset all exposure groups to a single group. disabled by default",
    )


def _h_resetExposureGroups(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    from ...io.groups import sync_group_columns

    if param:
        source_group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        data[exp_group_id_name] = np.ones(len(data), np.uint32)
        sync_group_columns(
            data, exp_group_id_name
        )
        group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        output_slots.add(exp_group_id_name.split("/")[0])
        output_title += f"->{len(group_ids)} group"
        if getattr(args, "verbose", 0) > 1:
            logger.info(
                "\t%d -> %d exposure groups", len(source_group_ids), len(group_ids)
            )
    return data, output_title, output_slots, index_d


def _add_assignPerMicrograph(parser):
    parser.add_argument(
        "--assignExposureGroupPerMicrograph", type=int, metavar="<0|1>",
        default=0,
        help="assign images to exposure groups, one group per micrograph. "
        "disabled by default",
    )


def _h_assignPerMicrograph(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    from ...io.groups import per_micrograph_ids, sync_group_columns

    if param:
        source_group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        data[exp_group_id_name] = per_micrograph_ids(_col(data, micrograph_name))
        sync_group_columns(
            data, exp_group_id_name
        )
        group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        output_slots.add(exp_group_id_name.split("/")[0])
        output_title += f"->{len(group_ids)} per-micrograph groups"
        if getattr(args, "verbose", 0) > 1:
            logger.info(
                "\t%d -> %d exposure groups", len(source_group_ids), len(group_ids)
            )
    return data, output_title, output_slots, index_d


def _add_assignByBeamShiftLabel(parser):
    parser.add_argument(
        "--assignExposureGroupByBeamShiftLabel", type=str, metavar="0|1",
        default=None,
        help="assign images to exposure groups by beam shift label from "
        "filenames. One group per distinct beam shift value. disabled by "
        "default",
    )


def _h_assignByBeamShiftLabel(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    from ...io.epu import (
        assign_beamshift_groups,
        guess_data_collection_software,
        movie_filename_patterns,
    )
    from ...io.groups import combine_groups, propagate_ctf_median, sync_group_columns

    if param is not None and param != "0":
        source_group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        names = _col(data, micrograph_name).astype(str)
        software = guess_data_collection_software(names[0])
        if software is None:
            logger.warning(
                "cannot detect the data collection software using %s: %s\n"
                "\tI only know the filenames by %s",
                micrograph_name,
                names[0],
                ", ".join(sorted(
                    movie_filename_patterns().keys()
                )),
            )
            raise HeliconError("cannot detect data collection software")

        micrographs = np.sort(np.unique(names))
        if software in ("EPU", "serialEM_pncc", "serialEM_embl_heidelberg"):
            mapping = assign_beamshift_groups(micrographs, software)
        else:
            logger.warning(
                "software %s does not have a beam shift label in its "
                "filenames. Try --assignExposureGroupByTime instead.",
                software,
            )
            raise HeliconError(
                f"software {software} does not have a beam shift label in "
                "its filenames"
            )
        exposure_groups = np.array([mapping[m] for m in names])
        data[exp_group_id_name] = combine_groups(
            _col(data, exp_group_id_name), exposure_groups
        )
        sync_group_columns(
            data, exp_group_id_name
        )
        propagate_ctf_median(
            data, exp_group_id_name
        )
        group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        output_slots.add(exp_group_id_name.split("/")[0])
        output_title += (
            f" {len(source_group_ids)}->{len(group_ids)} beamshift label groups"
        )
    return data, output_title, output_slots, index_d


def _add_assignByBeamShiftXY(parser):
    parser.add_argument(
        "--assignExposureGroupByBeamShiftXY", type=str, default=None,
        metavar="0|1|xml_folder=<path>:min_micrographs_per_group=<n>",
        help="assign images to exposure groups by beam shift XY coordinates "
        "from EPU XML files. Requires EPU_old FoilHole XML files. disabled "
        "by default",
    )


def _h_assignByBeamShiftXY(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    from ...io.epu import (
        EPU_micrograph_path_2_movie_xml_path,
        EPU_xml_2_beamshift,
        check_foilhole_xml_files,
    )
    from ...io.groups import combine_groups, propagate_ctf_median, sync_group_columns
    from ...commands import command_device
    from ...io.metadata import assign_beamshifts_to_cluster

    if param is not None and param != "0":
        source_group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        names = _col(data, micrograph_name).astype(str)
        micrographs = np.sort(np.unique(names))

        _, param_dict = parse_param_str(param)
        xml_folder = str(param_dict.get("xml_folder", ""))
        min_cluster_size = int(param_dict.get("min_micrographs_per_group", 4))
        project_folder = getattr(args, "input_project_folder", None)

        check_foilhole_xml_files(
            micrographs, xml_folder
        )
        to_xml = EPU_micrograph_path_2_movie_xml_path
        to_shift = EPU_xml_2_beamshift
        xml_files = {
            m: to_xml(
                micrograph_path=(
                    project_folder / m if project_folder is not None else m
                ),
                xml_folder=xml_folder,
            )
            for m in micrographs
        }
        shifts_by_m = {m: to_shift(xml_file=xml_files[m]) for m in micrographs}
        beamshifts = np.array(list(shifts_by_m.values()))
        labels = assign_beamshifts_to_cluster(
            beamshifts=beamshifts,
            range_n_clusters=range(2, 200),
            min_cluster_size=min_cluster_size,
            cpu=getattr(args, "cpu", -1),
            verbose=getattr(args, "verbose", 0),
            device=command_device(getattr(args, "device", "cuda")),
        )
        cluster_of = dict(zip(shifts_by_m.keys(), np.asarray(labels)))

        if "mscope_params/beam_shift" in data:
            data["mscope_params/beam_shift"] = np.array(
                [shifts_by_m[m] for m in names]
            )
        exposure_groups = np.array([cluster_of[m] for m in names])
        data[exp_group_id_name] = combine_groups(
            _col(data, exp_group_id_name), exposure_groups
        )
        sync_group_columns(
            data, exp_group_id_name
        )
        propagate_ctf_median(
            data, exp_group_id_name
        )
        group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        output_slots.add(exp_group_id_name.split("/")[0])
        output_title += (
            f" {len(source_group_ids)}->{len(group_ids)} beamshift XY groups"
        )
    return data, output_title, output_slots, index_d


def _add_assignByTime(parser):
    parser.add_argument(
        "--assignExposureGroupByTime", type=int, metavar="<n>", default=-1,
        help="assign images to exposure groups according to data collection "
        "time, n movies per group. disabled by default",
    )


def _h_assignByTime(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    from ...io.groups import (
        assign_time_groups,
        propagate_ctf_median,
        sync_group_columns,
    )

    if abs(param) > 0:
        time_group_size = param
        source_group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        # negative: merge existing groups into one before splitting by time
        if time_group_size < 0 and len(source_group_ids) > 1:
            if getattr(args, "verbose", 0) > 1:
                logger.info(
                    "\tCombining %d exposure groups into 1 group",
                    len(source_group_ids),
                )
            data[exp_group_id_name] = np.ones(len(data), np.uint32)
            source_group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        time_group_size = abs(time_group_size)

        micrographs = _col(data, micrograph_name)
        new_group_ids, _, _ = assign_time_groups(
            micrographs=micrographs,
            source_group_ids=source_group_ids,
            group_id_lookup=_col(data, exp_group_id_name),
            time_group_size=time_group_size,
            verbose=getattr(args, "verbose", 0),
            use_mtime_fallback=None,
        )
        data[exp_group_id_name] = new_group_ids
        sync_group_columns(
            data, exp_group_id_name
        )
        propagate_ctf_median(
            data, exp_group_id_name
        )
        group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        output_slots.add(exp_group_id_name.split("/")[0])
        output_title += f"->{len(group_ids)} time groups"
        if getattr(args, "verbose", 0) > 1:
            logger.info(
                "\t%d -> %d exposure groups", len(source_group_ids), len(group_ids)
            )
    return data, output_title, output_slots, index_d


def _add_copyAssignments(parser):
    parser.add_argument(
        "--copyExposureGroupAssignments", type=str, metavar="<star file>",
        default=0,
        help="copy the optics group assignments from this star file. "
        "rlnMicrographMovieName and rlnOpticsGroup must be in this star "
        "file. disabled by default",
    )


def _h_copyAssignments(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    """Reference copyexposuregroupassignments.py: map movie-name stems from
    a RELION star file's rlnMicrographMovieName/rlnOpticsGroup onto the
    dataset's micrograph names by substring match."""
    from ...io.groups import sync_group_columns
    from ...io.metadata import images2dataframe
    from ...utils.path_utils import check_required_columns

    if param:
        source_group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        dataFrom = images2dataframe(
            inputFiles=param,
            ignore_bad_particle_path=True,
            ignore_bad_micrograph_path=True,
            warn_missing_ctf=0,
            target_convention="relion",
        )
        check_required_columns(
            dataFrom, required_cols=["rlnMicrographMovieName", "rlnOpticsGroup"]
        )
        og = dataFrom["rlnOpticsGroup"].astype(int)
        dataFrom["rlnOpticsGroup"] = og - np.min(og) + 1
        mapping = {}
        for _, row in dataFrom.iterrows():
            key = Path(row["rlnMicrographMovieName"]).stem.split(".")[0]
            mapping[key] = row["rlnOpticsGroup"]

        names = _col(data, micrograph_name).astype(str)
        for m in np.unique(names):
            group = 0
            for k, v in mapping.items():
                if m.find(k) != -1:
                    group = v
                    break
            _set_where(data, exp_group_id_name, names == m, group)
            if group == 0:
                logger.warning(
                    "cannot find matching optics group info in %s for %s. "
                    "Assign it to exposure group 0",
                    param,
                    m,
                )
        sync_group_columns(
            data, exp_group_id_name
        )
        group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        output_slots.add(exp_group_id_name.split("/")[0])
        output_title += (
            f"->{len(group_ids)} exposure groups copied from {Path(param).name}"
        )
        if getattr(args, "verbose", 0) > 1:
            logger.info(
                "\t%d -> %d exposure groups", len(source_group_ids), len(group_ids)
            )
    return data, output_title, output_slots, index_d


def _add_copyParameters(parser):
    parser.add_argument(
        "--copyExposureGroupParameters", type=str, default=0,
        metavar="source_cs_file=<filename>|source_job_id=<Jxx>"
        "[:beam_tilt=<0|1>:trefoil=<0|1>:tetrafoil=<0|1>:cs=<0|1>"
        ":anisomag=<0|1>]",
        help="copy exposure group parameters (beam tilt, trefoil, "
        "tetrafoil, cs, anisotropic distortion, etc.). disabled by default",
    )


def _load_source_cs(path):
    """dict-of-columns view of a .cs file (Dataset.load stand-in)."""
    from ...io.cs import read_cs

    arr = read_cs(path)
    return {n: np.asarray(arr[n]) for n in arr.dtype.names}


def _h_copyParameters(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    """Reference copyexposuregroupparameters.py: re-assign exposure groups
    by micrograph uid from a source dataset, then copy per-group CTF
    parameter medians (beam tilt / cs / trefoil / tetrafoil / anisomag)."""
    from ...utils.collections import all_matched_attrs, first_matched_attr

    if param:
        defaults = dict(
            source_cs_file="", source_job_id="", beam_tilt=1, cs=1,
            trefoil=1, tetrafoil=1, anisomag=1,
        )
        _, param_dict = parse_param_str(param)
        param_dict, param_changed, param_unsupported = validate_param_dict(
            param=param_dict, param_ref=defaults
        )
        if len(param_unsupported):
            logger.warning("ignoring unknown parameters: %s", param_unsupported)
        if getattr(args, "verbose", 0) > 2:
            logger.info("\tCustom parameters: %s", param_changed)

        if param_dict["source_cs_file"]:
            if param_dict["source_job_id"]:
                logger.warning(
                    "both source_cs_file and source_job_id are specified. "
                    "I will use source_cs_file"
                )
            source_data_name = param_dict["source_cs_file"]
            source_data = _load_source_cs(param_dict["source_cs_file"])
        elif param_dict["source_job_id"]:
            # server mode: load the source job's particle/exposure output
            # (reference copyexposuregroupparameters.py:111-133)
            from ...io.metadata import connect_cryosparc

            cs_client = connect_cryosparc()
            source_job = cs_client.find_job(
                args.projectID, param_dict["source_job_id"]
            )
            group_name = next(
                (
                    g["name"]
                    for g in source_job.doc["output_result_groups"]
                    if g["type"] in ("particle", "exposure")
                ),
                None,
            )
            if not group_name:
                raise HeliconError(
                    f"{source_job} does not provide particles or exposures"
                )
            source_data_name = source_job.doc["uid"]
            source_data = source_job.load_output(group_name)
        else:
            raise HeliconError(
                "either source_cs_file or source_job_id must be specified"
            )
        if not all_matched_attrs(
            source_data, query_str="exp_group_id"
        ):
            raise HeliconError(
                f"{source_data_name} does not contain exp_group_id"
            )

        fm = first_matched_attr
        source_gid = fm(
            source_data,
            attrs="ctf/exp_group_id location/exp_group_id "
            "mscope_params/exp_group_id".split(),
        )
        source_group_ids = np.unique(np.asarray(source_data[source_gid]))
        source_mid = fm(source_data, attrs="location/micrograph_uid uid".split())
        mid_name = fm(data, attrs="location/micrograph_uid uid".split())

        mapping = {}
        for sgid in source_group_ids:
            sel = np.asarray(source_data[source_gid]) == sgid
            for uid in np.asarray(source_data[source_mid])[sel]:
                mapping[uid] = int(sgid)
        unknown_egid = np.min(np.array(list(mapping.values()))) - 1

        mids_all = _col(data, mid_name)
        for mid in np.unique(mids_all):
            _set_where(
                data, exp_group_id_name, mids_all == mid,
                mapping.get(mid, unknown_egid),
            )

        ctf_params_to_copy = []
        if int(param_dict["beam_tilt"]):
            ctf_params_to_copy.append("ctf/tilt_A")
        if int(param_dict["cs"]):
            ctf_params_to_copy.append("ctf/cs_mm")
        if int(param_dict["trefoil"]):
            ctf_params_to_copy.append("ctf/trefoil_A")
        if int(param_dict["tetrafoil"]):
            ctf_params_to_copy.append("ctf/tetra_A")
        if int(param_dict["anisomag"]):
            ctf_params_to_copy.append("ctf/anisomag")
        ctf_params_to_copy = [p for p in ctf_params_to_copy if p in source_data]
        if not ctf_params_to_copy:
            logger.warning(
                "No exposure group ctf parameters found in the source "
                "dataset. I will only copy the exposure group assignments"
            )

        group_ids = np.sort(np.unique(_col(data, exp_group_id_name)))
        src_gids = np.asarray(source_data[source_gid])
        for group_id in group_ids:
            mask = _col(data, exp_group_id_name) == group_id
            if group_id in source_group_ids:
                sel = src_gids == group_id
                for p in ctf_params_to_copy:
                    _set_where(
                        data, p, mask,
                        np.median(np.asarray(source_data[p])[sel], axis=0),
                    )
            else:
                for p in ctf_params_to_copy:
                    _set_where(
                        data, p, mask, np.median(np.asarray(source_data[p]), axis=0)
                    )

        output_slots.add(exp_group_id_name.split("/")[0])
        output_slots.add("ctf")
        output_title += (
            f"->copied params {' '.join(ctf_params_to_copy)} of "
            f"{len(group_ids)} exposure groups from {source_data_name}"
        )
        if getattr(args, "verbose", 0) > 1:
            msg = (
                f"{len(original_exp_group_ids)} -> {len(group_ids)} "
                "exposure groups"
            )
            if len(ctf_params_to_copy):
                msg += f": {' '.join(ctf_params_to_copy)}"
            logger.info("\t%s", msg)
    return data, output_title, output_slots, index_d


def _add_splitByMicrograph(parser):
    parser.add_argument(
        "--splitByMicrograph", type=int, metavar="<0|1>", default=0,
        help="split the dataset by micrograph. disabled by default",
    )


def _h_splitByMicrograph(
    data, args, index_d, param, output_title, output_slots,
    exp_group_id_name, micrograph_name, original_exp_group_ids,
):
    from ...utils.collections import split_array

    if param:
        col_mid = (
            "location/micrograph_uid"
            if "location/micrograph_uid" in data
            else micrograph_name
        )
        mids_all = _col(data, col_mid)
        mids = np.unique(mids_all)
        masks = [mids_all == mid for mid in mids]
        counts = [int(np.sum(m)) for m in masks]
        group1, group2 = split_array(counts)
        col_split = "alignments3D/split"
        _ensure_column(data, col_split, "u4")
        for gi, g in enumerate([group1, group2]):
            for mid_index in g:
                _set_where(data, col_split, masks[mid_index], gi)
        output_slots.add("alignments3D")
        output_title += "->per-micrograph split"
        if getattr(args, "verbose", 0) > 1:
            split = _col(data, col_split)
            logger.info(
                "\twhole  dataset: %d micrographs, %d particles",
                len(mids), len(data),
            )
            logger.info(
                "\thalf dataset 1: %d micrographs, %d particles",
                len(group1), int(np.sum(split == 0)),
            )
            logger.info(
                "\thalf dataset 2: %d micrographs, %d particles",
                len(group2), int(np.sum(split == 1)),
            )
    return data, output_title, output_slots, index_d


PLUGINS = [
    Plugin("changePixelSize", _add_changePixelSize, _h_changePixelSize),
    Plugin("resetExposureGroups", _add_resetExposureGroups, _h_resetExposureGroups),
    Plugin(
        "assignExposureGroupPerMicrograph",
        _add_assignPerMicrograph,
        _h_assignPerMicrograph,
    ),
    Plugin(
        "assignExposureGroupByBeamShiftLabel",
        _add_assignByBeamShiftLabel,
        _h_assignByBeamShiftLabel,
    ),
    Plugin(
        "assignExposureGroupByBeamShiftXY",
        _add_assignByBeamShiftXY,
        _h_assignByBeamShiftXY,
    ),
    Plugin("assignExposureGroupByTime", _add_assignByTime, _h_assignByTime),
    Plugin(
        "copyExposureGroupAssignments", _add_copyAssignments, _h_copyAssignments
    ),
    Plugin(
        "copyExposureGroupParameters", _add_copyParameters, _h_copyParameters
    ),
    Plugin("splitByMicrograph", _add_splitByMicrograph, _h_splitByMicrograph),
]
