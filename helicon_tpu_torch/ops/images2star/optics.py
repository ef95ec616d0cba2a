"""Optics/CTF options: apix, resetOpticGroup, assignOpticGroupPerMicrograph,

A copy of ``helicon_tpu/ops/images2star/optics.py`` (host code:
numpy and pandas); tests/test_torch_images2star.py pins the copy to the original.

assignOpticGroupByBeamShiftLabel, assignOpticGroupByBeamShiftXY,
assignOpticGroupByTime, setBeamTiltClass, setCTF, copyCtf.

Reference: plugins/images2star/{apix,resetopticgroup,
assignopticgrouppermicrograph,assignopticgroupbybeamshiftlabel,
assignopticgroupbybeamshiftxy,assignopticgroupbytime,setbeamtiltclass,
setctf,copyctf}.py.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from ...utils.collections import first_matched_attr
from ...utils.exceptions import HeliconError
from ..registry import Plugin

logger = logging.getLogger(__name__)


def _require_optics(data):
    optics = data.attrs.get("optics")
    if optics is None:
        raise HeliconError("data_optics block must be available")
    return optics


def _image_name_col(data):
    name = first_matched_attr(
        data, attrs="rlnMicrographMovieName rlnMicrographName rlnImageName".split()
    )
    if name is None:
        raise HeliconError(
            "rlnMicrographMovieName, rlnMicrographName or rlnImageName required"
        )
    return name


def _rebuild_optics_rows(optics_orig, n_groups, source_groups=None):
    """Fresh optics table for n_groups regrouped optics groups.

    source_groups[i] (optional): the ORIGINAL rlnOpticsGroup whose
    parameter row seeds new group i+1. Without it every new row clones
    row 0 — wrong pixel size/voltage for particles that came from a
    different original group in merged multi-optics datasets.
    """
    rows = []
    for gi in range(n_groups):
        row = optics_orig.iloc[[0]]
        if source_groups is not None and "rlnOpticsGroup" in optics_orig:
            m = (
                optics_orig["rlnOpticsGroup"].astype(int)
                == int(source_groups[gi])
            )
            if m.any():
                row = optics_orig.loc[m].iloc[[0]]
        rows.append(row)
    optics = pd.concat(rows, ignore_index=True)
    for gi in range(n_groups):
        optics.loc[gi, "rlnOpticsGroup"] = gi + 1
        optics.loc[gi, "rlnOpticsGroupName"] = f"opticsGroup{gi + 1}"
    return optics


def _modal_source_groups(old_groups, new_groups, n_groups):
    """For each new group id 1..n_groups, the most common ORIGINAL
    optics-group id among its particles (None when unknowable)."""
    if old_groups is None:
        return None
    old = np.asarray(old_groups, int)
    new = np.asarray(new_groups, int)
    out = []
    for g in range(1, n_groups + 1):
        sel = old[new == g]
        out.append(int(np.bincount(sel).argmax()) if len(sel) else 1)
    return out


def _add_apix(parser):
    parser.add_argument(
        "--apix", type=float, metavar="<A/pixel>", default=0,
        help="set mag to have this sampling",
    )


def _h_apix(data, args, index_d, param):
    from ...io.metadata import setPixelSize

    if param > 0:
        setPixelSize(data, apix_new=param)
        index_d["apix"] += 1
    return data, index_d


def _add_resetOpticGroup(parser):
    parser.add_argument(
        "--resetOpticGroup", type=int, metavar="<0|1>", default=0,
        help="merge all optics groups into one",
    )


def _h_resetOpticGroup(data, args, index_d, param):
    if param:
        optics_orig = _require_optics(data)
        data["rlnOpticsGroup"] = 1
        data.attrs["optics"] = _rebuild_optics_rows(optics_orig, 1)
    return data, index_d


def _add_assignPerMicrograph(parser):
    parser.add_argument(
        "--assignOpticGroupPerMicrograph", type=int, metavar="<0|1>", default=0,
        help="one optics group per micrograph",
    )


def _h_assignPerMicrograph(data, args, index_d, param):
    from ...io.groups import per_micrograph_mapping

    if param:
        optics_orig = _require_optics(data)
        image_name = _image_name_col(data)
        if "rlnOpticsGroup" not in data:
            raise HeliconError("rlnOpticsGroup must be available")
        names = data[image_name].str.split("@", expand=True).iloc[:, -1]
        unique_names = names.unique()
        mapping = per_micrograph_mapping(unique_names)
        old_groups = data["rlnOpticsGroup"].astype(int).to_numpy()
        data["rlnOpticsGroup"] = names.map(mapping)
        data.attrs["optics"] = _rebuild_optics_rows(
            optics_orig, len(unique_names),
            _modal_source_groups(
                old_groups, data["rlnOpticsGroup"], len(unique_names)
            ),
        )
    return data, index_d


def _add_assignByBeamShiftLabel(parser):
    parser.add_argument(
        "--assignOpticGroupByBeamShiftLabel", type=str, default="no",
        metavar="<no|auto|EPU|serialEM_pncc|serialEM_embl_heidelberg|serialEM_cuhksz>",
        help="optics groups from the beam-shift label in movie filenames",
    )


def _h_assignByBeamShiftLabel(data, args, index_d, param):
    from ...io.epu import (
        assign_beamshift_groups,
        guess_data_collection_software,
        verify_data_collection_software,
    )

    if param != "no":
        optics_orig = _require_optics(data)
        image_name = _image_name_col(data)
        if "rlnOpticsGroup" not in data:
            raise HeliconError("rlnOpticsGroup must be available")
        if param == "auto":
            software = guess_data_collection_software(str(data[image_name].iloc[0]))
            if software is None:
                raise HeliconError(
                    f"cannot detect filename format: {data[image_name].iloc[0]}"
                )
        else:
            software = param
            if verify_data_collection_software(
                str(data[image_name].iloc[0]), software
            ) is None:
                raise HeliconError(
                    f"format {software} inconsistent with {data[image_name].iloc[0]}"
                )
        if software == "EPU_old":
            raise HeliconError(
                "EPU_old data require the xml files; use "
                "--assignOpticGroupByBeamShiftXY instead"
            )
        names = data[image_name].str.split("@", expand=True).iloc[:, -1]
        mapping = assign_beamshift_groups(list(names.unique()), software)
        old_groups = (
            data["rlnOpticsGroup"].astype(int).to_numpy()
            if "rlnOpticsGroup" in data else None
        )
        data["rlnOpticsGroup"] = names.map(mapping)
        n_new = len(set(mapping.values()))
        data.attrs["optics"] = _rebuild_optics_rows(
            optics_orig, n_new,
            _modal_source_groups(old_groups, data["rlnOpticsGroup"], n_new),
        )
    return data, index_d


def _add_assignByBeamShiftXY(parser):
    parser.add_argument(
        "--assignOpticGroupByBeamShiftXY", type=str, default="",
        metavar="nClusters=<n>:xmlFolder=<path>",
        help="optics groups by clustering beam shifts read from EPU XMLs",
    )


def _h_assignByBeamShiftXY(data, args, index_d, param):
    from ...io.epu import (
        EPU_micrograph_path_2_movie_xml_path,
        EPU_xml_2_beamshift,
        check_foilhole_xml_files,
    )
    from ...io.metadata import assign_beamshifts_to_cluster
    from ...utils.system import parse_param_str

    # reference assignopticgroupbybeamshiftxy.py: "0" disables; the param
    # mini-language carries xml_folder / min_micrographs_per_group; the
    # helpers are read from their modules at each call (patchable)
    if param is not None and param != "0":
        _, pd_ = parse_param_str(str(param))
        xml_folder = str(pd_.get("xml_folder", pd_.get("xmlFolder", "")))
        min_cluster_size = int(pd_.get("min_micrographs_per_group", 4))
        n_clusters = int(pd_["nClusters"]) if "nClusters" in pd_ else None
        optics_orig = _require_optics(data)
        image_name = _image_name_col(data)
        names = data[image_name].astype(str).str.split("@", expand=True).iloc[:, -1]
        unique_names = np.sort(names.unique())
        check_foilhole_xml_files(unique_names, xml_folder)
        shifts = np.array(
            [
                EPU_xml_2_beamshift(
                    EPU_micrograph_path_2_movie_xml_path(
                        micrograph_path=m, xml_folder=xml_folder
                    )
                )
                for m in unique_names
            ]
        )
        labels = assign_beamshifts_to_cluster(
            shifts, n_clusters=n_clusters, min_cluster_size=min_cluster_size
        )
        mapping = dict(zip(unique_names, np.asarray(labels)))
        old_groups = (
            data["rlnOpticsGroup"].astype(int).to_numpy()
            if "rlnOpticsGroup" in data else None
        )
        data["rlnOpticsGroup"] = names.map(mapping)
        n_new = int(np.max(labels))
        data.attrs["optics"] = _rebuild_optics_rows(
            optics_orig, n_new,
            _modal_source_groups(old_groups, data["rlnOpticsGroup"], n_new),
        )
    return data, index_d


def _add_assignByTime(parser):
    parser.add_argument(
        "--assignOpticGroupByTime", type=int, metavar="<n per group>", default=0,
        help="split each optics group into time-ordered groups of n movies",
    )


def _h_assignByTime(data, args, index_d, param):
    from ...io.epu import guess_data_collection_software
    from ...io.groups import assign_time_groups

    if param > 0:
        optics_orig = _require_optics(data)
        # reference assignopticgroupbytime.py: movie name preferred;
        # non-EPU data falls back to rlnMicrographMovieName's file
        # mtime when present
        image_name = _image_name_col(data)
        if "rlnOpticsGroup" not in data:
            raise HeliconError("rlnOpticsGroup must be available")
        software = guess_data_collection_software(filename=data[image_name].iloc[0])
        if software not in ("EPU", "EPU_old") and "rlnMicrographMovieName" in data:
            image_name = "rlnMicrographMovieName"
        movies = data[image_name].values
        source_group_ids = np.sort(data["rlnOpticsGroup"].unique())
        new_ids, m2t, m2ts = assign_time_groups(
            micrographs=movies,
            source_group_ids=source_group_ids,
            group_id_lookup=data["rlnOpticsGroup"].values,
            time_group_size=param,
            verbose=getattr(args, "verbose", 0),
        )
        old_groups = data["rlnOpticsGroup"].astype(int).to_numpy()
        data["rlnOpticsGroup"] = new_ids
        data["rlnMovieCollectionTime"] = pd.Series(movies, index=data.index).map(
            m2ts
        )
        data.attrs["optics"] = _rebuild_optics_rows(
            optics_orig, int(np.max(new_ids)),
            _modal_source_groups(old_groups, new_ids, int(np.max(new_ids))),
        )
    return data, index_d


def _add_setBeamTiltClass(parser):
    parser.add_argument(
        "--setBeamTiltClass", type=int, metavar="<0|1>", default=0,
        help="set rlnBeamTiltClass to one class per micrograph",
    )


def _h_setBeamTiltClass(data, args, index_d, param):
    if param:
        names = data["rlnImageName"].str.split("@", expand=True).iloc[:, -1]
        for mi, (name, particles) in enumerate(names.groupby(names, sort=False)):
            data.loc[particles.index, "rlnBeamTiltClass"] = mi + 1
        index_d["setBeamTiltClass"] += 1
    return data, index_d


def read_ctfparm_file(path) -> dict:
    """EMAN1-style ctfparm.txt: ``<micrograph id>\\t<comma separated vals>``
    with values defocus, dfdiff, dfang, bfactor, ampcont, noise..., voltage,
    cs, apix. The reference plugin calls readCtfparmFile without defining it
    (plugins/images2star/setctf.py:52 — a vestige); this parser implements
    the evident EMAN1 format."""
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            continue
        mid, vals = parts
        v = [float(x) for x in vals.replace(",", " ").split()]
        if len(v) < 8:
            continue
        out[mid] = dict(
            defocus=v[0], dfdiff=v[1], dfang=v[2], bfactor=v[3],
            ampcont=v[4], voltage=v[-3], cs=v[-2], apix=v[-1],
        )
    return out


def _add_setCTF(parser):
    parser.add_argument(
        "--setCTF", type=str, metavar="<ctfparm.txt>", default="",
        help="set CTF parameters from an EMAN1 ctfparm.txt file",
    )


def _h_setCTF(data, args, index_d, param):
    from ...io.metadata import eman_astigmatism_to_relion

    if param:
        for col in (
            "rlnVoltage", "rlnSphericalAberration", "rlnAmplitudeContrast",
            "rlnMagnification", "rlnDefocusU", "rlnDefocusV", "rlnDefocusAngle",
        ):
            data[col] = 0.0  # float init: int columns reject float .loc writes
        if "rlnDetectorPixelSize" not in data:
            data["rlnDetectorPixelSize"] = 5.0
        ctfparms = read_ctfparm_file(param)
        names = data["rlnImageName"].str.split("@", expand=True).iloc[:, -1]
        for name, particles in names.groupby(names, sort=False):
            mid = Path(name).stem
            d = ctfparms.get(mid) or ctfparms.get(mid.split(".")[0])
            if d is None:
                raise HeliconError(f"no ctf parameters for micrograph {name}")
            idx = particles.index
            data.loc[idx, "rlnVoltage"] = d["voltage"]
            data.loc[idx, "rlnSphericalAberration"] = d["cs"]
            data.loc[idx, "rlnAmplitudeContrast"] = d["ampcont"] / 100.0
            data.loc[idx, "rlnMagnification"] = (
                data.loc[idx, "rlnDetectorPixelSize"] * 1e4 / d["apix"]
            )
            u, v, a = eman_astigmatism_to_relion(
                d["defocus"], d["dfdiff"], d["dfang"]
            )
            data.loc[idx, "rlnDefocusU"] = u
            data.loc[idx, "rlnDefocusV"] = v
            data.loc[idx, "rlnDefocusAngle"] = a
        index_d["setCTF"] += 1
    return data, index_d


def _add_copyCtf(parser):
    parser.add_argument(
        "--copyCtf", type=str, metavar="<starFile>", default="",
        help="copy per-micrograph mean CTF parameters from another star file",
    )


def _h_copyCtf(data, args, index_d, param):
    """Per-micrograph averaged defocus/astigmatism copy + optics-group
    beam-tilt copy (reference copyctf.py)."""
    from ...io.metadata import images2dataframe

    if len(param) >= 1:
        data = data.drop_duplicates(subset=["rlnImageName"], keep="last")
        data2 = images2dataframe(
            param,
            alternative_folders=getattr(args, "folder", []),
            ignore_bad_particle_path=getattr(args, "ignoreBadParticlePath", 0),
            ignore_bad_micrograph_path=getattr(args, "ignoreBadMicrographPath", 1),
            warn_missing_ctf=1,
            target_convention="relion",
        )
        data2 = data2.drop_duplicates(subset=["rlnImageName"], keep="last")
        optics = data.attrs.get("optics")
        optics2 = data2.attrs.get("optics")
        if optics is not None and optics2 is not None:
            common = set(optics["rlnOpticsGroup"].values) & set(
                optics2["rlnOpticsGroup"].values
            )
            tilt_parms = [
                k
                for k in (
                    "rlnBeamTiltX", "rlnBeamTiltY", "rlnOddZernike", "rlnEvenZernike"
                )
                if k in optics2
            ]
            for k in tilt_parms:
                if k not in optics:
                    optics[k] = 0.0  # int columns reject float .loc writes
            for og in common:
                optics.loc[optics["rlnOpticsGroup"] == og, tilt_parms] = (
                    optics2.loc[optics2["rlnOpticsGroup"] == og, tilt_parms].values
                )
            data.attrs["optics"] = optics
        ctf_parms = [
            "rlnDefocusU", "rlnDefocusV", "rlnDefocusAngle",
            "rlnCtfBfactor", "rlnCtfScalefactor", "rlnPhaseShift",
        ]
        # backfill only the TARGET (copyctf.py:108-110); inventing 0.0
        # columns in the source would overwrite real values with zeros
        # (rlnCtfScalefactor=0 multiplies the CTF away in RELION)
        for v in ctf_parms:
            if v not in data:
                data[v] = np.nan
        data2 = data2.copy()
        data2["mean_defocus"] = (data2["rlnDefocusU"] + data2["rlnDefocusV"]) / 2
        delta = (data2["rlnDefocusU"] - data2["rlnDefocusV"]) / 2
        data2["astig_x"] = delta * np.cos(np.deg2rad(data2["rlnDefocusAngle"]))
        data2["astig_y"] = delta * np.sin(np.deg2rad(data2["rlnDefocusAngle"]))
        num = data2.select_dtypes(include=[np.number]).columns.tolist()
        agg = data2.groupby("rlnMicrographName")[num].mean()
        agg["mean_astig"] = np.sqrt(agg["astig_x"] ** 2 + agg["astig_y"] ** 2)
        agg["mean_astig_angle"] = np.rad2deg(
            np.arctan2(agg["astig_y"], agg["astig_x"])
        )
        # exact string match first; fall back to BASENAME matching for
        # differently-rooted paths (relative vs absolute spellings left
        # the backfilled NaN defocus in the output, which RELION rejects)
        src_by_base: dict = {}
        for m in agg.index:
            src_by_base.setdefault(Path(str(m)).name, []).append(m)
        tgt_base = data["rlnMicrographName"].map(lambda s: Path(str(s)).name)
        for micrograph in agg.index:
            rows = data["rlnMicrographName"] == micrograph
            if not rows.any():
                base = Path(str(micrograph)).name
                if len(src_by_base[base]) > 1:
                    continue  # ambiguous basename: no safe fallback
                rows = tgt_base == base
            if not rows.any():
                continue
            data.loc[rows, "rlnDefocusU"] = (
                agg.loc[micrograph, "mean_defocus"] + agg.loc[micrograph, "mean_astig"]
            )
            data.loc[rows, "rlnDefocusV"] = (
                agg.loc[micrograph, "mean_defocus"] - agg.loc[micrograph, "mean_astig"]
            )
            extra = [
                c for c in ("rlnCtfBfactor", "rlnCtfScalefactor", "rlnPhaseShift")
                if c in agg.columns
            ]
            data.loc[rows, ["rlnDefocusAngle"] + extra] = agg.loc[
                micrograph, ["mean_astig_angle"] + extra
            ].values
        unmatched = int(data["rlnDefocusU"].isna().sum())
        if unmatched:
            logger.warning(
                "--copyCtf: %d particles matched no source micrograph "
                "(their defocus stays NaN)", unmatched,
            )
    return data, index_d


PLUGINS = [
    Plugin("apix", _add_apix, _h_apix),
    Plugin("resetOpticGroup", _add_resetOpticGroup, _h_resetOpticGroup),
    Plugin(
        "assignOpticGroupPerMicrograph",
        _add_assignPerMicrograph,
        _h_assignPerMicrograph,
    ),
    Plugin(
        "assignOpticGroupByBeamShiftLabel",
        _add_assignByBeamShiftLabel,
        _h_assignByBeamShiftLabel,
    ),
    Plugin(
        "assignOpticGroupByBeamShiftXY",
        _add_assignByBeamShiftXY,
        _h_assignByBeamShiftXY,
    ),
    Plugin("assignOpticGroupByTime", _add_assignByTime, _h_assignByTime),
    Plugin("setBeamTiltClass", _add_setBeamTiltClass, _h_setBeamTiltClass),
    Plugin("setCTF", _add_setCTF, _h_setCTF),
    Plugin("copyCtf", _add_copyCtf, _h_copyCtf),
]
