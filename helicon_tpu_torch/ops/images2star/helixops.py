"""Helix-aware options: breakFilaments, resetInterSegmentDistance,

A copy of ``helicon_tpu/ops/images2star/helixops.py`` (host code:
numpy and pandas); tests/test_torch_images2star.py pins the copy to the original.

estimateHelicalTubeLength, normEulerDist.

Reference: plugins/images2star/{breakfilaments,resetintersegmentdistance,
estimatehelicaltubelength,normeulerdist}.py.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import pandas as pd

from ...core.analysis import (
    estimate_helicalTube_length,
    find_elbow_point,
    reset_inter_segment_distance,
)
from ...utils.exceptions import HeliconError
from ...utils.system import parse_param_str
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _add_breakFilaments(parser):
    parser.add_argument(
        "--breakFilaments", type=str, metavar="maxSegments=<n>",
        action="append", default=[],
        help="break long filaments into pieces of at most maxSegments segments",
    )


def _h_breakFilaments(data, args, index_d, param):
    if len(param):
        _, pd_ = parse_param_str(param)
        max_segments = int(pd_.get("maxSegments", 50))
        if max_segments < 1:
            raise HeliconError("maxSegments must be >= 1")
        if "rlnHelicalTubeID" not in data:
            raise HeliconError("rlnHelicalTubeID is required for --breakFilaments")
        var = next(
            (v for v in ("rlnMicrographName", "rlnImageName") if v in data), ""
        )
        if not var:
            raise HeliconError("rlnMicrographName or rlnImageName must be available")
        if "@" in str(data[var].iloc[0]):
            tmp = data[var].str.split("@", expand=True)
            group_var = "filename"
            data[group_var] = tmp.iloc[:, 1]
        else:
            group_var = var
        if "rlnHelicalTubeIDOriginal" not in data:
            data["rlnHelicalTubeIDOriginal"] = data["rlnHelicalTubeID"]
        # reference breakfilaments.py semantics exactly, vectorized:
        # filaments within the limit keep their original row order;
        # oversized filaments are ordered by track length before
        # chunking; new tube IDs are 0-based in group-encounter order
        # (reference's enumerate). ngroup(sort=False) IS encounter
        # order, and a stable lexsort by (gid, track, original row)
        # reproduces the per-group track-length sort without a Python
        # loop over groups (~100k-row frames).
        gid = (
            data.groupby([group_var, "rlnHelicalTubeID"], sort=False)
            .ngroup()
            .to_numpy()
        )
        n_rows = len(data)
        if "rlnHelicalTrackLengthAngst" in data:
            trk = data["rlnHelicalTrackLengthAngst"].to_numpy(np.float64)
        else:
            trk = np.zeros(n_rows)  # stable sort keeps original order
        order = np.lexsort((np.arange(n_rows), trk, gid))
        gs = gid[order]
        group_start = np.zeros(n_rows, bool)
        group_start[0] = True
        group_start[1:] = gs[1:] != gs[:-1]
        start_pos = np.maximum.accumulate(
            np.where(group_start, np.arange(n_rows), 0)
        )
        pos_in_group = np.arange(n_rows) - start_pos
        # track-length order only matters for oversized groups; within
        # the limit every row lands in chunk 0 regardless of ordering,
        # matching the reference's "no sort for small filaments" path
        chunk = pos_in_group // max_segments
        boundary = group_start.copy()
        boundary[1:] |= chunk[1:] != chunk[:-1]
        new_id_sorted = np.cumsum(boundary) - 1
        new_ids = np.empty(n_rows, np.int64)
        new_ids[order] = new_id_sorted
        data["rlnHelicalTubeID"] = new_ids
        if group_var != var:
            data.drop(columns=[group_var], inplace=True)
        index_d["breakFilaments"] += 1
    return data, index_d


def _add_resetInterSegmentDistance(parser):
    parser.add_argument(
        "--resetInterSegmentDistance", type=float, metavar="<A>", default=0,
        help="resample filament segments at the new inter-segment distance",
    )


def _h_resetInterSegmentDistance(data, args, index_d, param):
    if param > 0:
        bad = [
            v
            for v in "rlnImageName rlnHelicalTubeID rlnCoordinateX rlnCoordinateY".split()
            if v not in data
        ]
        if bad:
            raise HeliconError(f"parameters {' '.join(bad)} do not exist")
        apix_micrograph = 0
        optics = data.attrs.get("optics")
        if optics is not None:
            for attr in ("rlnMicrographPixelSize", "rlnMicrographOriginalPixelSize"):
                if attr in optics:
                    apix_micrograph = optics[attr].iloc[0]
                    break
        if apix_micrograph <= 0:
            raise HeliconError(
                "neither rlnMicrographPixelSize nor "
                "rlnMicrographOriginalPixelSize is available"
            )
        data = reset_inter_segment_distance(
            data,
            new_inter_segment_distance=param,
            apix_micrograph=apix_micrograph,
            verbose=getattr(args, "verbose", 0),
        )
    return data, index_d


def _add_estimateHelicalTubeLength(parser):
    parser.add_argument(
        "--estimateHelicalTubeLength", type=int, metavar="<0|1>", default=0,
        help="add per-segment filament length/position columns",
    )


def _h_estimateHelicalTubeLength(data, args, index_d, param):
    if param:
        bad = [
            v
            for v in "rlnImageName rlnHelicalTubeID rlnCoordinateX rlnCoordinateY".split()
            if v not in data
        ]
        if bad:
            raise HeliconError(f"parameters {' '.join(bad)} do not exist")
        data = estimate_helicalTube_length(
            data, verbose=getattr(args, "verbose", 0)
        )
    return data, index_d


def _add_normEulerDist(parser):
    parser.add_argument(
        "--normEulerDist", type=float, nargs=2, metavar=("<bin>", "<nkeep>"),
        default=[], help="prune over-populated Euler angle bins",
    )


def _h_normEulerDist(data, args, index_d, param):
    if len(param) == 2:
        bin_, nkeep = param
        nkeep = int(nkeep)

        def assignEulerBins(rottilt):
            rot, tilt = rottilt
            tilt = int(tilt / bin_ + 0.5) * bin_
            if tilt == 0 or tilt == 180:
                rot = 0
            else:
                step = bin_ / math.sin(math.radians(tilt))
                rot = int(rot / step + 0.5) * step
            return (tilt, rot)

        binAngles = data[["rlnAngleRot", "rlnAngleTilt"]].apply(
            assignEulerBins, axis=1
        )
        binAssignments = binAngles.groupby(binAngles, sort=False)
        counts = binAssignments.size().sort_values(ascending=True)
        from ...commands import command_device

        elbow = counts.iloc[find_elbow_point(
            counts.values, device=command_device(getattr(args, "device", "cuda")))]
        if nkeep < 1:
            nkeep = int(elbow)
        indices = []
        for be, bm in dict(list(binAssignments)).items():
            binPtcls = data.loc[bm.index, :]
            if "rlnLogLikeliContribution" in binPtcls:
                binPtcls2 = binPtcls.sort_values(
                    "rlnLogLikeliContribution", ascending=True
                ).tail(n=nkeep)
            elif len(binPtcls) > nkeep:
                binPtcls2 = binPtcls.sample(n=nkeep)
            else:
                binPtcls2 = binPtcls
            indices.extend(binPtcls2.index)
        indices.sort()
        attrs = dict(data.attrs)
        data = data.loc[indices, :]
        data.attrs.update(attrs)
        index_d["normEulerDist"] += 1
    return data, index_d


PLUGINS = [
    Plugin("breakFilaments", _add_breakFilaments, _h_breakFilaments),
    Plugin(
        "resetInterSegmentDistance",
        _add_resetInterSegmentDistance,
        _h_resetInterSegmentDistance,
    ),
    Plugin(
        "estimateHelicalTubeLength",
        _add_estimateHelicalTubeLength,
        _h_estimateHelicalTubeLength,
    ),
    Plugin("normEulerDist", _add_normEulerDist, _h_normEulerDist),
]
