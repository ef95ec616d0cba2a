"""Parameter-editing options: addParm, multParm, setParm, delParm,

A copy of ``helicon_tpu/ops/images2star/parm.py`` (host code:
numpy and pandas); tests/test_torch_images2star.py pins the copy to the original.

keepParm, copyParm, duplicateParm, renameParm, replaceStr,
replaceImageName.

Reference: plugins/images2star/{addparm,multparm,setparm,delparm,
keepparm,copyparm,duplicateparm,renameparm,replacestr,
replaceimagename}.py.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from ...utils.exceptions import HeliconError
from ...utils.path_utils import convert_dataframe_file_path
from ...utils.system import parse_param_str  # noqa: F401 (sibling modules import)
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _add_addParm(parser):
    parser.add_argument(
        "--addParm", metavar="<var> <val>", type=str, nargs=2,
        help="modify parameter: var+=val", action="append", default=[],
    )


def _h_addParm(data, args, index_d, param):
    if len(param) == 2:
        var, val = param
        if var not in data:
            logger.error("parameter %s does not exist; cannot add to it", var)
        else:
            data.loc[:, var] = data[var] + float(val)
        index_d["addParm"] += 1
    return data, index_d


def _add_multParm(parser):
    parser.add_argument(
        "--multParm", metavar="<var> <val>", type=str, nargs=2,
        help="modify parameter: var*=val", action="append", default=[],
    )


def _h_multParm(data, args, index_d, param):
    if len(param) == 2:
        var, val = param
        if var not in data:
            logger.error("parameter %s does not exist; cannot multiply it", var)
        else:
            data[var] = data[var] * float(val)
        index_d["multParm"] += 1
    return data, index_d


def _add_setParm(parser):
    parser.add_argument(
        "--setParm", metavar="<var> <val>", type=str, nargs="+",
        help="set parameter var val pair for each image", action="append",
        default=[],
    )


def _h_setParm(data, args, index_d, param):
    from ...io.metadata import Relion_OpticsGroup_Parameters
    from ...io.metadata import guess_data_type

    if param:
        if len(param) % 2:
            raise HeliconError(
                "--setParm requires an even number of arguments (var val pairs)"
            )
        for i in range(len(param) // 2):
            var, val = param[2 * i : 2 * (i + 1)]
            typed = guess_data_type(val)(val)
            if var in Relion_OpticsGroup_Parameters and data.attrs.get("optics") is not None:
                data.attrs["optics"][var] = typed
            else:
                data[var] = typed
        index_d["setParm"] += 1
    return data, index_d


def _add_delParm(parser):
    parser.add_argument(
        "--delParm", metavar="<var>", type=str, nargs="+", action="append",
        help="remove parameter var for each image", default=[],
    )


def _h_delParm(data, args, index_d, param):
    if len(param):
        drop, invalid = [], []
        for p in param:
            p = p.strip("_")
            (drop if p in data else invalid).append(p)
        if invalid:
            logger.warning("%s do not exist", invalid)
        if drop:
            data = data.drop(columns=drop)
        index_d["delParm"] += 1
    return data, index_d


def _add_keepParm(parser):
    parser.add_argument(
        "--keepParm", metavar="<var>", type=str, nargs="+", action="append",
        help="keep parameter var for each image, remove other parameters",
        default=[],
    )


def _h_keepParm(data, args, index_d, param):
    if len(param):
        data = data.drop(columns=[c for c in data if c not in param])
        index_d["keepParm"] += 1
    return data, index_d


def _add_copyParm(parser):
    parser.add_argument(
        "--copyParm", metavar="<starfile< var ~var ...>>", type=str, nargs="+",
        help="copy the specified parameters (all if unspecified; ~var skips var)",
        default=[],
    )


def _h_copyParm(data, args, index_d, param):
    """Copy columns from another metadata file matched on rlnImageName
    (reference copyparm.py)."""
    from ...io.metadata import images2dataframe

    if len(param) >= 1:
        starFile = param[0]
        vars = list(param[1:])
        data = data.drop_duplicates(subset=["rlnImageName"], keep="last")
        from .select import _load_ref

        data2 = _load_ref(starFile, args)
        data2 = data2.drop_duplicates(subset=["rlnImageName"], keep="last")
        if len(data) > len(data2):
            raise HeliconError(
                f"--copyParm: {starFile} has fewer particles "
                f"({len(data2)}) than the input ({len(data)})"
            )
        if vars:
            copyVars = [v for v in vars if v[0] != "~"]
            skipVars = [v[1:] for v in vars if v[0] == "~"]
            if copyVars:
                invalid = [v for v in copyVars if v not in data2]
                if invalid:
                    logger.warning("parameters %s not in %s; ignored", invalid, starFile)
                validParms = [v for v in copyVars if v in data2]
            else:
                validParms = [
                    v for v in data2 if v not in skipVars + ["rlnImageName"]
                ]
        else:
            validParms = [v for v in data2 if v != "rlnImageName"]
        for v in validParms:
            if v not in data:
                data[v] = np.nan
        attrs = dict(data.attrs)
        key1 = convert_dataframe_file_path(data, "rlnImageName", to="abs")
        key2 = convert_dataframe_file_path(data2, "rlnImageName", to="abs")
        data = data.set_index(key1)
        data2 = data2.set_index(key2)
        missing = set(data.index) - set(data2.index)
        if missing:
            raise HeliconError(
                f"--copyParm: {starFile} must contain a superset of the "
                f"input particles ({len(missing)} missing)"
            )
        data[validParms] = data2.loc[data.index, validParms]
        data = data.reset_index(drop=True)
        data.attrs.update(attrs)
        index_d["copyParm"] += 1
    return data, index_d


def _add_duplicateParm(parser):
    parser.add_argument(
        "--duplicateParm", metavar="<from> <to>", type=str, nargs=2,
        help="duplicate parameter", action="append", default=[],
    )


def _h_duplicateParm(data, args, index_d, param):
    if len(param):
        for var_from, var_to in zip(*[iter(np.ravel(param))] * 2):
            if var_from not in data:
                logger.warning("%s does not exist; cannot duplicate", var_from)
                continue
            if var_to in data:
                logger.warning("%s already exists; not duplicating", var_to)
                continue
            data[var_to] = data[var_from]
        index_d["duplicateParm"] += 1
    return data, index_d


def _add_renameParm(parser):
    parser.add_argument(
        "--renameParm", metavar="<old> <new>", type=str, nargs=2,
        help="rename parameter", action="append", default=[],
    )


def _h_renameParm(data, args, index_d, param):
    if len(param):
        cols = {}
        for var_old, var_new in zip(*[iter(np.ravel(param))] * 2):
            if var_old not in data:
                logger.warning("%s does not exist; cannot rename", var_old)
                continue
            if var_new in data:
                logger.warning("%s already exists; cannot rename onto it", var_new)
                continue
            cols[var_old] = var_new
        data.rename(columns=cols, inplace=True)
        index_d["renameParm"] += 1
    return data, index_d


def _add_replaceStr(parser):
    parser.add_argument(
        "--replaceStr", metavar=("<var>", "<original str>", "<new str>"),
        type=str, nargs=3, help="replace substr in the variable with new str",
        action="append", default=[],
    )


def _h_replaceStr(data, args, index_d, param):
    if len(param) == 3:
        var, oldStr, newStr = param
        if var in data:
            data[var] = data[var].str.replace(oldStr, newStr, regex=False)
        else:
            logger.warning("variable %s does not exist; skipped", var)
        index_d["replaceStr"] += 1
    return data, index_d


def _add_replaceImageName(parser):
    parser.add_argument(
        "--replaceImageName", metavar="<new mrcs file>", type=str, default="",
        help="replace rlnImageName column by the provided mrcs file with the "
        "same number of particles",
    )


def _h_replaceImageName(data, args, index_d, param):
    from ...io.mrc import get_image_number

    if param:
        if not Path(param).exists():
            raise HeliconError(f"{param} does not exist")
        nImage = get_image_number(param)
        if nImage != len(data):
            raise HeliconError(
                f"{param} contains {nImage} particles, expected {len(data)}"
            )
        data["rlnImageName"] = (
            pd.Series(range(1, nImage + 1), index=data.index).map("{:06d}".format)
            + "@"
            + param
        )
        index_d["replaceImageName"] += 1
    return data, index_d


PLUGINS = [
    Plugin("addParm", _add_addParm, _h_addParm),
    Plugin("multParm", _add_multParm, _h_multParm),
    Plugin("setParm", _add_setParm, _h_setParm),
    Plugin("delParm", _add_delParm, _h_delParm),
    Plugin("keepParm", _add_keepParm, _h_keepParm),
    Plugin("copyParm", _add_copyParm, _h_copyParm),
    Plugin("duplicateParm", _add_duplicateParm, _h_duplicateParm),
    Plugin("renameParm", _add_renameParm, _h_renameParm),
    Plugin("replaceStr", _add_replaceStr, _h_replaceStr),
    Plugin("replaceImageName", _add_replaceImageName, _h_replaceImageName),
]
