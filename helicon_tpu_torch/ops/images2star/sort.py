"""Ordering/metadata options: sortby, rsortby, showTime, path.

A copy of ``helicon_tpu/ops/images2star/sort.py`` (host code:
numpy and pandas); tests/test_torch_images2star.py pins the copy to the original.

Reference: plugins/images2star/{sortby,rsortby,showtime,path}.py.
"""

from __future__ import annotations

import logging
from pathlib import Path

from ...utils.collections import first_matched_attr, unique_attr_name
from ...utils.path_utils import convert_dataframe_file_path
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _sort_dataframe(data, cols, ascending=True):
    from ...utils.exceptions import HeliconError

    bad = [c for c in cols if c not in data]
    if bad:
        # reference sortby.py:48 fails loudly: a typo must not produce
        # an unsorted file the user believes was sorted
        raise HeliconError(f"parameter {bad[0]} does not exist")
    if not cols:
        return data
    # rlnImageName sorts as "filename@index" (sortby.py:50-58) so each
    # stack's particles stay contiguous — raw "index@filename" ordering
    # interleaves stacks by the per-stack particle index
    tmp_col = None
    if "rlnImageName" in cols and "@" in str(data["rlnImageName"].iloc[0]):
        tmp_col = unique_attr_name(data, attr_prefix="tmp_sort_rlnImageName")
        parts = data["rlnImageName"].str.split("@", expand=True)
        data = data.copy()
        data[tmp_col] = parts.iloc[:, -1] + "@" + parts.iloc[:, 0]
        cols = [tmp_col if c == "rlnImageName" else c for c in cols]
    attrs = dict(data.attrs)
    out = data.sort_values(by=cols, ascending=ascending).reset_index(drop=True)
    if tmp_col is not None:
        out = out.drop(columns=[tmp_col])
    out.attrs.update(attrs)
    return out


def _add_sortby(parser):
    parser.add_argument(
        "--sortby", type=str, nargs="+", metavar="<var>", action="append",
        default=[],
        help="sort images by the specified variables (ascending)",
    )


def _h_sortby(data, args, index_d, param):
    if param:
        data = _sort_dataframe(data, param, ascending=True)
        index_d["sortby"] += 1
    return data, index_d


def _add_rsortby(parser):
    parser.add_argument(
        "--rsortby", type=str, nargs="+", metavar="<var>", action="append",
        default=[],
        help="sort images by the specified variables (descending)",
    )


def _h_rsortby(data, args, index_d, param):
    if param:
        data = _sort_dataframe(data, param, ascending=False)
        index_d["rsortby"] += 1
    return data, index_d


def _add_showTime(parser):
    parser.add_argument(
        "--showTime", type=str, metavar="<var>", default="",
        help="add a column with the file create time of the given attribute",
    )


def _h_showTime(data, args, index_d, param):
    if param:
        fileAttr = param if param in data else first_matched_attr(
            data,
            attrs="rlnMicrographMovieName rlnMicrographName rlnImageName".split(),
        )
        if fileAttr is None:
            from ...utils.exceptions import HeliconError

            raise HeliconError(
                "--showTime needs a file-name column "
                "(rlnMicrographMovieName/rlnMicrographName/rlnImageName)"
            )
        tmpCol = unique_attr_name(data, attr_prefix=fileAttr)
        data[tmpCol] = data[fileAttr].str.split("@", expand=True).iloc[:, -1]
        timeCol = f"{fileAttr}CreateTime"
        for fileName, fileParticles in data.groupby(tmpCol, sort=False):
            try:
                t = Path(fileName).stat().st_ctime
            except OSError:
                t = float("nan")
            data.loc[fileParticles.index, timeCol] = t
        data.drop(columns=[tmpCol], inplace=True)
    return data, index_d


def _add_path(parser):
    parser.add_argument(
        "--path", type=str,
        metavar="<absolute|relative|real|shortest|current>",
        choices=["absolute", "abs", "relative", "rel", "real", "shortest",
                 "current"],
        default="current",
        help="convert image/micrograph paths to absolute or relative form",
    )


def _h_path(data, args, index_d, param):
    from ...io.metadata import get_relion_project_folder

    if param != "current":
        for attr in "rlnImageName rlnMicrographName rlnMovieName".split():
            if attr in data:
                output_star = Path(
                    getattr(args, "output_starFile", ".") or "."
                ).resolve()
                proj = get_relion_project_folder(str(output_star))
                relpath_start = str(output_star.parent) if proj is None else proj
                data[attr] = convert_dataframe_file_path(
                    data, attr, to=param, relpath_start=relpath_start
                )
        index_d["path"] += 1
    return data, index_d


PLUGINS = [
    Plugin("sortby", _add_sortby, _h_sortby),
    Plugin("rsortby", _add_rsortby, _h_rsortby),
    Plugin("showTime", _add_showTime, _h_showTime),
    Plugin("path", _add_path, _h_path),
]
