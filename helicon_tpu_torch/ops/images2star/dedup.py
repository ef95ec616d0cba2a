"""Dedup/split options: removeDuplicates, minDuplicates,

A copy of ``helicon_tpu/ops/images2star/dedup.py`` (host code:
numpy and pandas); tests/test_torch_images2star.py pins the copy to the original.

keepOneParticlePerHelicalTube, keepOneParticlePerMicrograph,
splitByMicrograph, psiPrior180.

Reference: plugins/images2star/{removeduplicates,minduplicates,
keeponeparticleperhelicaltube,keeponeparticlepermicrograph,
splitbymicrograph,psiprior180}.py.
"""

from __future__ import annotations

import logging
from pathlib import Path

import pandas as pd

from ...utils.exceptions import HeliconError, HeliconExit
from ...utils.path_utils import convert_dataframe_file_path
from ...utils.system import ceil_power_of_10
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _add_removeDuplicates(parser):
    parser.add_argument(
        "--removeDuplicates", type=str, nargs="+", metavar="<var>", default=[],
        help="remove images with duplicate values of the given variables",
    )


def _h_removeDuplicates(data, args, index_d, param):
    if param:
        invalid = [v for v in param if v not in data]
        if invalid:
            logger.warning("%s are not valid parameters", invalid)
        vars = [v for v in param if v in data]
        if vars:
            attrs = dict(data.attrs)
            data = data.drop_duplicates(vars).reset_index(drop=True)
            data.attrs.update(attrs)
    return data, index_d


def _add_minDuplicates(parser):
    parser.add_argument(
        "--minDuplicates", type=int, metavar="<n>", default=0,
        help="keep one copy of images that occur at least n times",
    )


def _h_minDuplicates(data, args, index_d, param):
    if param > 0:
        attr = next(
            (a for a in ("rlnImageName", "rlnMicrographName") if a in data), None
        )
        if attr is None:
            raise HeliconError(
                "--minDuplicates requires rlnImageName or rlnMicrographName"
            )
        tmp = convert_dataframe_file_path(data, attr, to="abs")
        retained = tmp.map(tmp.value_counts() >= param)
        data2 = data[retained]
        if len(data2) < 1:
            raise HeliconError("--minDuplicates retained no image")
        attrs = dict(data.attrs)
        data = data2.drop_duplicates([attr]).reset_index(drop=True)
        data.attrs.update(attrs)
    return data, index_d


def _keep_one_per(data, extra_group=None):
    """Group by micrograph (or stack file) [+ tube id] and keep firsts."""
    var = next(
        (v for v in ("rlnMicrographName", "rlnImageName") if v in data), ""
    )
    if not var:
        raise HeliconError("rlnMicrographName or rlnImageName must be available")
    attrs = dict(data.attrs)
    if "@" in str(data[var].iloc[0]):
        tmp = data[var].str.split("@", expand=True)
        var = "filename"
        data = data.copy()
        data[var] = tmp.iloc[:, 1]
    keys = [var] + ([extra_group] if extra_group else [])
    # head(1) keeps an ACTUAL first row per group; groupby().first()
    # takes the first non-NA value PER COLUMN, blending fields from
    # different particles into a chimeric record when the first row has
    # NaNs (e.g. unclassified particles without rlnClassNumber)
    data = data.groupby(keys, sort=False).head(1).reset_index(drop=True)
    if var == "filename":
        data = data.drop(columns=["filename"])
    data.attrs.update(attrs)
    return data


def _add_keepOnePerTube(parser):
    parser.add_argument(
        "--keepOneParticlePerHelicalTube", type=int, metavar="<0|1>", default=0,
        help="keep only the first particle of each helical tube",
    )


def _h_keepOnePerTube(data, args, index_d, param):
    if param:
        if "rlnHelicalTubeID" not in data:
            raise HeliconError("rlnHelicalTubeID is not available")
        data = _keep_one_per(data, "rlnHelicalTubeID")
    return data, index_d


def _add_keepOnePerMicrograph(parser):
    parser.add_argument(
        "--keepOneParticlePerMicrograph", type=int, metavar="<0|1>", default=0,
        help="keep only the first particle of each micrograph",
    )


def _h_keepOnePerMicrograph(data, args, index_d, param):
    if param:
        data = _keep_one_per(data)
    return data, index_d


def _add_splitByMicrograph(parser):
    parser.add_argument(
        "--splitByMicrograph", type=int, metavar="<0|1>", default=0,
        help="save each micrograph's particles into its own star file",
    )


def _h_splitByMicrograph(data, args, index_d, param):
    from ...io.metadata import dataframe2file

    if param:
        if "rlnMicrographName" in data:
            names = data["rlnMicrographName"]
        else:
            names = data["rlnImageName"].str.split("@", expand=True).iloc[:, -1]
        outp = Path(getattr(args, "output_starFile", "output.star"))
        # keep the output DIRECTORY (bare .stem wrote into the CWD) and
        # uniquify duplicate micrograph stems from different folders
        prefix = outp.parent / outp.stem
        used: dict = {}
        for i, (name, particles) in enumerate(names.groupby(names, sort=False)):
            stem = Path(name).stem
            if used.get(stem, name) != name:
                import hashlib

                stem = f"{stem}-{hashlib.sha1(str(name).encode()).hexdigest()[:8]}"
            used[Path(name).stem] = name
            out = f"{prefix}.{stem}.star"
            dataframe2file(data.loc[particles.index], out)
        raise HeliconExit()
    return data, index_d


def _add_psiPrior180(parser):
    parser.add_argument(
        "--psiPrior180", type=int, metavar="<0|1>", default=0,
        help="duplicate all particles with rlnAnglePsiPrior rotated 180 deg",
    )


def _h_psiPrior180(data, args, index_d, param):
    if param:
        var = "rlnAnglePsiPrior"
        if var not in data:
            raise HeliconError(f"parameter {var} does not exist")
        data2 = data.copy()
        data2[var] = data2[var] + 180.0
        if "rlnHelicalTubeID" in data2:
            idMax = ceil_power_of_10(int(data2["rlnHelicalTubeID"].astype(int).max()))
            data2["rlnHelicalTubeID"] = data2["rlnHelicalTubeID"] + idMax
        attrs = dict(data.attrs)
        # reset_index: duplicate index labels would make later
        # label-based ops (loc/groupby-index paths) double-select rows
        data = pd.concat((data, data2), axis=0).reset_index(drop=True)
        data.attrs.update(attrs)
        index_d["psiPrior180"] += 1
    return data, index_d


PLUGINS = [
    Plugin("removeDuplicates", _add_removeDuplicates, _h_removeDuplicates),
    Plugin("minDuplicates", _add_minDuplicates, _h_minDuplicates),
    Plugin(
        "keepOneParticlePerHelicalTube", _add_keepOnePerTube, _h_keepOnePerTube
    ),
    Plugin(
        "keepOneParticlePerMicrograph",
        _add_keepOnePerMicrograph,
        _h_keepOnePerMicrograph,
    ),
    Plugin("splitByMicrograph", _add_splitByMicrograph, _h_splitByMicrograph),
    Plugin("psiPrior180", _add_psiPrior180, _h_psiPrior180),
]
