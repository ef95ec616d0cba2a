"""Selection options: select, selectValueRange, selectRatioRange,

A copy of ``helicon_tpu/ops/images2star/select.py`` (host code:
numpy and pandas); tests/test_torch_images2star.py pins the copy to the original.

selectFile, excludeFile, selectCommonHelices, randomSample, sets.

Reference: plugins/images2star/{select,selectvaluerange,selectratiorange,
selectFile,excludeFile,selectcommonhelices,randomsample,sets}.py.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import pandas as pd

from ...utils.exceptions import HeliconError
from ...utils.path_utils import convert_dataframe_file_path
from ...utils.system import parse_param_str
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _load_ref(sf, args):
    from ...io.metadata import images2dataframe

    return images2dataframe(
        sf,
        alternative_folders=getattr(args, "folder", []),
        ignore_bad_particle_path=getattr(args, "ignoreBadParticlePath", 0),
        ignore_bad_micrograph_path=getattr(args, "ignoreBadMicrographPath", 1),
        warn_missing_ctf=0,
        target_convention="relion",
    )


def _add_select(parser):
    parser.add_argument(
        "--select", type=str, metavar=("<var>", "<val1<,val2>...>"), nargs=2,
        help="select images with exact matching of the variable value(s)",
        default=[],
    )


def _h_select(data, args, index_d, param):
    if len(param) == 2:
        var, val = param
        if var in data:
            vmin, vmax = data[var].min(), data[var].max()
            vals = val.split(",")
            if pd.api.types.is_integer_dtype(data[var]):
                vals = list(map(int, vals))
            elif pd.api.types.is_float_dtype(data[var]):
                vals = list(map(float, vals))
            data = data[data[var].isin(vals)]
            if len(data) < 1:
                raise HeliconError(
                    f"selection excluded all images (data range [{vmin}, {vmax}])"
                )
        elif getattr(args, "verbose", 0):
            logger.warning("variable %s does not exist for --select", var)
        index_d["select"] += 1
    return data, index_d


def _add_selectValueRange(parser):
    parser.add_argument(
        "--selectValueRange", type=str, nargs=3,
        metavar=("<var>", "<valmin>", "<valmax>"),
        help="select images with the variable value in the range", default=[],
    )


def _h_selectValueRange(data, args, index_d, param):
    if len(param) == 3:
        var, val1, val2 = param
        if var in data:
            vmin, vmax = data[var].min(), data[var].max()
            if pd.api.types.is_integer_dtype(data[var]):
                val1, val2 = int(val1), int(val2)
            else:
                val1, val2 = float(val1), float(val2)
            data = data.loc[(data[var] > val1) & (data[var] < val2)]
            if len(data) < 1:
                raise HeliconError(
                    f"selection excluded all images (data range [{vmin}, {vmax}])"
                )
        elif getattr(args, "verbose", 0):
            logger.warning("variable %s does not exist for --selectValueRange", var)
        index_d["selectValueRange"] += 1
    return data, index_d


def _add_selectRatioRange(parser):
    parser.add_argument(
        "--selectRatioRange", type=str, nargs=3,
        metavar=("<var>", "<ratio min>", "<ratio max>"),
        help="select images with the variable value in the ratio range",
        default=[],
    )


def _h_selectRatioRange(data, args, index_d, param):
    if len(param) == 3:
        var, val1, val2 = param
        if var in data:
            vmin, vmax = data[var].min(), data[var].max()
            if not (
                pd.api.types.is_integer_dtype(data[var])
                or pd.api.types.is_float_dtype(data[var])
            ):
                raise HeliconError(
                    f"--selectRatioRange: variable {var} is not numeric"
                )
            data = data.copy()
            data[var] = data[var].astype(float)
            val1, val2 = float(val1), float(val2)
            n1 = int(len(data) * val1)
            if n1 <= 0:
                valmin = data[var].min()
            else:
                valmin = data[var].nsmallest(n1).iloc[-1]
            if val2 == 1:
                valmax = data[var].max() + 0.1
            else:
                valmax = data[var].nsmallest(int(len(data) * val2) + 1).iloc[-1]
            data = data.loc[(data[var] >= valmin) & (data[var] < valmax)]
            if len(data) < 1:
                raise HeliconError(
                    f"selection excluded all images (data range [{vmin}, {vmax}])"
                )
        elif var.lower() == "index":
            # positional slice by fraction (selectratiorange.py:77-84)
            val1 = int(round(float(val1) * len(data)))
            val2 = int(round(float(val2) * len(data)))
            if val1 < 0:
                val1 = 0
            if val2 < 0:
                val2 = len(data)
            data = data.iloc[val1:val2]
            if not len(data):
                raise HeliconError(
                    "selection excluded all images (--selectRatioRange index)"
                )
        else:
            # raise regardless of verbosity (the reference gates this on
            # args.verbose, making correctness depend on the log level —
            # deviation documented)
            raise HeliconError(
                f'the variable "{var}" specified by --selectRatioRange '
                "does NOT exist"
            )
        index_d["selectRatioRange"] += 1
    return data, index_d


def _select_by_file(data, col1, sids, pattern, invert=False):
    """Match col1 against a cleaned id series (reference selectFile.py)."""
    dids = convert_dataframe_file_path(data, col1, to="abs")
    dids = dids.apply(lambda row: row.lstrip("0"))
    sids = sids.apply(lambda row: row.lstrip("0"))
    if pattern:
        dids = dids.str.extract(pattern, expand=False)
        sids = sids.str.extract(pattern, expand=False)
    if invert:
        dids = dids[~dids.isin(sids)]
    else:
        dids = dids[dids.isin(sids)]
    return data.loc[dids.index, :].reset_index(drop=True)


def _file_filter(data, args, index_d, param, option, invert):
    if len(param) > 0:
        sf, pd_ = parse_param_str(param)
        col1 = pd_.get("col1", "rlnImageName")
        col2 = pd_.get("col2", "rlnImageName")
        if col1 not in data:
            raise HeliconError(
                f"column {col1} not found; available: {list(data.columns)}"
            )
        pattern = pd_.get("pattern", None)
        if sf is None or not os.path.exists(sf):
            raise HeliconError(
                f"--{option}: a star/cs filename must lead the parameter "
                f"string (got {param!r})" if sf is None
                else f"--{option}: file {sf} does not exist"
            )
        data_sf = _load_ref(sf, args)
        if col2 not in data_sf:
            raise HeliconError(
                f"column {col2} not found in {sf}; available: "
                f"{list(data_sf.columns)}"
            )
        sids = convert_dataframe_file_path(data_sf, col2, to="abs")
        attrs = dict(data.attrs)
        data2 = _select_by_file(data, col1, sids, pattern, invert=invert)
        data2.attrs.update(attrs)
        if len(data2):
            data = data2
        elif not invert:
            raise HeliconError(
                f"--{option}: no common image found between the input and {sf}"
            )
        else:
            # reference excludeFile.py:87-95 KEEPS the original data
            # when the exclusion would empty it (an empty frame crashes
            # the next pipeline op); warn loudly that nothing was removed
            logger.warning(
                "--%s would remove every image; keeping the input "
                "unchanged (reference behavior)", option,
            )
        index_d[option] += 1
    return data, index_d


def _add_selectFile(parser):
    parser.add_argument(
        "--selectFile", type=str, action="append", default=[],
        metavar="starFile:col1=<name>:col2=<name>:pattern=<str>",
        help="select images whose <col1> is present in the file's <col2>",
    )


def _h_selectFile(data, args, index_d, param):
    return _file_filter(data, args, index_d, param, "selectFile", invert=False)


def _add_excludeFile(parser):
    parser.add_argument(
        "--excludeFile", type=str, action="append", default=[],
        metavar="starFile:col1=<name>:col2=<name>:pattern=<str>",
        help="exclude images whose <col1> is present in the file's <col2>",
    )


def _h_excludeFile(data, args, index_d, param):
    return _file_filter(data, args, index_d, param, "excludeFile", invert=True)


def _add_selectCommonHelices(parser):
    parser.add_argument(
        "--selectCommonHelices", type=str, action="append", default=[],
        metavar="starFile",
        help="select helices (micrograph + tube id) present in the file",
    )


def _h_selectCommonHelices(data, args, index_d, param):
    if len(param) > 0:
        sf, _ = parse_param_str(param)
        assert "rlnMicrographName" in data and "rlnHelicalTubeID" in data
        if sf is None or not Path(sf).exists():
            raise HeliconError(f"--selectCommonHelices: {sf} does not exist")
        data_sf = _load_ref(sf, args)
        assert "rlnMicrographName" in data_sf and "rlnHelicalTubeID" in data_sf
        common = ["rlnMicrographName", "rlnHelicalTubeID"]
        attrs = dict(data.attrs)
        data2 = data.merge(
            data_sf[common], on=common, how="inner", suffixes=["", "_dup"]
        )
        data2 = data2[data.columns].drop_duplicates().reset_index(drop=True)
        data2.attrs.update(attrs)
        if len(data2):
            data = data2
        else:
            raise HeliconError(
                f"--selectCommonHelices: no common helix with {sf}"
            )
        index_d["selectCommonHelices"] += 1
    return data, index_d


def _add_randomSample(parser):
    parser.add_argument(
        "--randomSample", type=int, metavar="<n>", default=0,
        help="randomly sample n images per rlnRandomSubset group",
    )


def _h_randomSample(data, args, index_d, param):
    if 0 < param < len(data):
        idx = []
        group = "rlnRandomSubset" if "rlnRandomSubset" in data else None
        groups = data.groupby(group, sort=False) if group else [(None, data)]
        for _, g in groups:
            idx.extend(g.sample(n=min(param, len(g))).index.tolist())
        attrs = dict(data.attrs)
        data = data.loc[idx].reset_index(drop=True)
        data.attrs.update(attrs)
        index_d["randomSample"] += 1
    return data, index_d


def _add_sets(parser):
    parser.add_argument(
        "--sets", type=int, metavar="<n>", default=0,
        help="split into n sets, keep the subset given by --subset",
    )
    parser.add_argument(
        "--subset", type=int, metavar="<i>", default=0,
        help="which subset (0-based) to keep with --sets",
    )


def _h_sets(data, args, index_d, param):
    if param > 1:
        data = data[getattr(args, "subset", 0) :: param]
        index_d["sets"] += 1
    return data, index_d


PLUGINS = [
    Plugin("select", _add_select, _h_select),
    Plugin("selectValueRange", _add_selectValueRange, _h_selectValueRange),
    Plugin("selectRatioRange", _add_selectRatioRange, _h_selectRatioRange),
    Plugin("selectFile", _add_selectFile, _h_selectFile),
    Plugin("excludeFile", _add_excludeFile, _h_excludeFile),
    Plugin("selectCommonHelices", _add_selectCommonHelices, _h_selectCommonHelices),
    Plugin("randomSample", _add_randomSample, _h_randomSample),
    Plugin("sets", _add_sets, _h_sets),
]
