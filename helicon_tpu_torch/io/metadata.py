"""Metadata wrangling: STAR/CS/cisTEM/CSV <-> pandas DataFrames.

A copy of ``helicon_tpu/io/metadata.py`` (host code:
numpy and pandas); tests/test_torch_metadata.py pins the copy to the original.

Reference: lib/io.py (2497 LoC). DataFrames carry the same side-channel
attrs as the reference: attrs["optics"] (RELION optics-group DataFrame or
None), attrs["convention"] ("relion" | "cryosparc"), attrs["source_path"].

Parity map (all citations into reference lib/io.py):
  preferred_relion_star_column_order / reorder_dataframe_columns .. 49-92
  pixelSizeAttrForImageAttr / getPixelSize / setPixelSize        .. 93-213
  get_relion_project_folder                                      .. 214-243
  assign_beamshifts_to_cluster                                   .. 244-350
  images2dataframe / image2dataframe / dataframe2file            .. 365-580
  guess_data_type / dataframe_guess_data_type                    .. 581-698
  star_dissolve/build_opticsgroup                                .. 699-977
  star2dataframe / dataframe2star                                .. 978-1186
  cs2dataframe / dataframe2cs                                    .. 1412-1560
  cistem2dataframe                                               .. 1561-1711
  relion/eman astigmatism conversion                             .. 1918-1983
  get_dataframe_convention / dataframe_convert                   .. 1984-2067
  _electron_wavelength                                           .. 2068-2089
  clean_cs_micrograph_path / dataframe_cryosparc_to_relion       .. 2090-2370
  mrc2mrcs                                                       .. 2371-2433

Additions over the reference: dataframe_relion_to_cryosparc is actually
implemented (the reference calls it at io.py:2056 but never defines it).
"""

from __future__ import annotations

import logging
import math
import os
from pathlib import Path

import numpy as np
import pandas as pd

from ..utils.exceptions import HeliconIOError, HeliconValueError
from .cs import read_cs, write_cs
from .mrc import get_image_number
from .star import read_star

logger = logging.getLogger(__name__)

__all__ = [
    "Relion_OpticsGroup_Parameters",
    "assign_beamshifts_to_cluster",
    "cs2dataframe",
    "cistem2dataframe",
    "csv2dataframe",
    "dataframe2cs",
    "dataframe2file",
    "dataframe2star",
    "dataframe_convert",
    "dataframe_cryosparc_to_relion",
    "dataframe_relion_to_cryosparc",
    "dataframe_guess_data_type",
    "eman_astigmatism_to_relion",
    "get_dataframe_convention",
    "get_relion_project_folder",
    "getPixelSize",
    "guess_data_type",
    "image2dataframe",
    "images2dataframe",
    "mrc2mrcs",
    "pixelSizeAttrForImageAttr",
    "preferred_relion_star_column_order",
    "relion_astigmatism_to_eman",
    "reorder_dataframe_columns",
    "setPixelSize",
    "star2dataframe",
    "star_build_opticsgroup",
    "star_dissolve_opticsgroup",
    "connect_cryosparc",
]


# ---------------------------------------------------------------------------
# column ordering (io.py:49-92)
# ---------------------------------------------------------------------------


def preferred_relion_star_column_order() -> list:
    return (
        "rlnImageName rlnMicrographMovieName rlnMicrographName "
        "rlnCoordinateX rlnCoordinateY rlnHelicalTubeID "
        "rlnHelicalTrackLengthAngst rlnAngleRot rlnAngleTilt rlnAnglePsi "
        "rlnOriginXAngst rlnOriginYAngst rlnDefocusU rlnDefocusV "
        "rlnDefocusAngle rlnPhaseShift rlnCtfMaxResolution rlnOpticsGroup "
        "rlnClassNumber rlnRandomSubset"
    ).split()


def reorder_dataframe_columns(data: pd.DataFrame) -> pd.DataFrame:
    pref = [c for c in preferred_relion_star_column_order() if c in data.columns]
    rest = [c for c in data.columns if c not in pref]
    out = data[pref + rest]
    out.attrs = dict(data.attrs)
    return out


# ---------------------------------------------------------------------------
# pixel size (io.py:93-213)
# ---------------------------------------------------------------------------


def pixelSizeAttrForImageAttr(imageAttr: str):
    mapping = {
        "rlnImageName": "rlnImagePixelSize",
        "rlnMicrographName": "rlnMicrographPixelSize",
        "rlnMicrographMovieName": "rlnMicrographOriginalPixelSize",
    }
    return mapping.get(imageAttr)


def getPixelSize(
    data: pd.DataFrame,
    attrs=(
        "rlnImagePixelSize",
        "rlnMicrographPixelSize",
        "rlnMicrographOriginalPixelSize",
        "rlnImageName",
        "rlnMicrographName",
    ),
    return_pixelSize_source: bool = False,
):
    """Pixel size from the optics block, the data, or MRC headers —
    searched in priority order (io.py:116-184)."""
    sources = []
    optics = data.attrs.get("optics") if hasattr(data, "attrs") else None
    if optics is not None:
        sources.append(optics)
    sources.append(data)
    for source in sources:
        for attr in attrs:
            if attr not in source:
                continue
            if attr in ("rlnImageName", "rlnMicrographName"):
                from .mrc import mrc_header

                src = data.attrs.get("source_path")
                folder = Path(src[0] if isinstance(src, list) else src or ".")
                if folder.is_symlink():
                    folder = folder.readlink()
                folder = folder.resolve().parent
                filename = str(source[attr].iloc[0]).split("@")[-1]
                for cand in (Path(filename), folder / filename,
                             (folder / "../.." / filename).resolve()):
                    try:
                        apix = float(mrc_header(cand).apix)
                        if return_pixelSize_source:
                            return apix, attr
                        return apix
                    except (OSError, ValueError):
                        continue
            else:
                apix = float(source[attr].iloc[0])
                if return_pixelSize_source:
                    return apix, attr
                return apix
    if return_pixelSize_source:
        return None, None
    return None


def setPixelSize(data: pd.DataFrame, apix_new: float, update_defocus: bool = False):
    """Set pixel size; optionally rescale defocus by (new/old)^2
    (io.py:185-213)."""
    apix_old, source = getPixelSize(data, return_pixelSize_source=True)
    if update_defocus and apix_old:
        for attr in ("rlnDefocusU", "rlnDefocusV"):
            if attr in data:
                data.loc[:, attr] = data[attr].astype(float) * (
                    (apix_new / apix_old) ** 2
                )
    # DEVIATION from reference io.py:185-213: when getPixelSize sourced
    # the value from an MRC header via an image-NAME column, the
    # reference writes apix_new into that name column, destroying every
    # path. Map to the corresponding pixel-size column instead.
    target = pixelSizeAttrForImageAttr(source) or source
    optics = data.attrs.get("optics")
    if optics is not None and (target in optics or source != target):
        optics.loc[:, target] = apix_new
    if target in data or source != target:
        data.loc[:, target] = apix_new


def get_relion_project_folder(starFile: str):
    """Walk up from the star file looking for a RELION project root
    (io.py:214-243)."""
    p = Path(starFile).resolve()
    for parent in p.parents:
        if (parent / "default_pipeline.star").exists() or (
            parent / ".relion_lock"
        ).exists():
            return str(parent)
        # Job folder layout: <project>/<JobType>/jobNNN/file.star
        if parent.name.lower().startswith("job") and len(parent.parents) >= 2:
            return str(parent.parents[1])
    return None


# ---------------------------------------------------------------------------
# type guessing (io.py:581-698)
# ---------------------------------------------------------------------------


def guess_data_type(string):
    """int | float | str for one string value (io.py:581-606)."""
    s = str(string)
    try:
        int(s)
        return int
    except ValueError:
        pass
    try:
        float(s)
        return float
    except ValueError:
        pass
    return str


def dataframe_guess_data_type(data: pd.DataFrame) -> pd.DataFrame:
    """Convert string columns to numeric where they parse (io.py:607-698)."""
    for col in data.columns:
        if data[col].dtype != object:
            continue
        if len(data) and isinstance(data[col].iloc[0], bytes):
            data[col] = data[col].str.decode("utf-8", errors="replace")
            continue
        if len(data) and isinstance(data[col].iloc[0], (list, np.ndarray)):
            continue
        converted = pd.to_numeric(data[col], errors="coerce")
        if converted.notna().all():
            if (converted == converted.round()).all() and not any(
                "." in str(v) for v in data[col].iloc[: min(5, len(data))]
            ):
                data[col] = converted.astype(np.int64)
            else:
                data[col] = converted
    return data


# ---------------------------------------------------------------------------
# optics groups (io.py:699-977)
# ---------------------------------------------------------------------------

Relion_OpticsGroup_Parameters = (
    "rlnOpticsGroup rlnOpticsGroupName rlnMtfFileName "
    "rlnVoltage rlnSphericalAberration rlnAmplitudeContrast "
    "rlnMagnification rlnDetectorPixelSize "
    "rlnMicrographOriginalPixelSize rlnMicrographPixelSize rlnMicrographBinning "
    "rlnImagePixelSize rlnImageSize rlnImageDimensionality "
    "rlnBeamTiltX rlnBeamTiltY "
    "rlnOddZernike rlnEvenZernike "
    "rlnMagMat00 rlnMagMat01 rlnMagMat10 rlnMagMat11 "
    "rlnCtfDataAreCtfPremultiplied"
).split()


def star_dissolve_opticsgroup(data: pd.DataFrame) -> None:
    """Copy optics-block parameters down into the particle rows
    (io.py:699-753)."""
    assert data.attrs.get("convention") == "relion"
    optics = data.attrs.get("optics")

    def canon(v):
        """Group label as canonical string ('1', not '1.0')."""
        try:
            return str(int(float(v)))
        except (TypeError, ValueError):
            return str(v)

    if optics is not None:
        optics = optics.copy()
        optics["rlnOpticsGroup"] = optics["rlnOpticsGroup"].map(canon)
        data["rlnOpticsGroup"] = data["rlnOpticsGroup"].map(canon)
        og_names = set(optics["rlnOpticsGroup"].unique())
        for gn, g in data.groupby("rlnOpticsGroup", sort=False):
            if gn not in og_names:
                raise HeliconValueError(
                    f"optic group {gn} not available ({sorted(og_names)})"
                )
            idx = g.index
            sel = optics["rlnOpticsGroup"] == gn
            for attr in (
                "rlnAmplitudeContrast rlnImagePixelSize rlnSphericalAberration "
                "rlnVoltage rlnMagnification rlnDetectorPixelSize"
            ).split():
                if attr in optics:
                    data.loc[idx, attr] = optics.loc[sel, attr].values[0]
    data.attrs["optics"] = None


def star_build_opticsgroup(data: pd.DataFrame) -> None:
    """Move shared optics parameters into attrs["optics"] (io.py:769-825)."""
    assert data.attrs.get("convention") == "relion"
    vars = [
        v
        for v in Relion_OpticsGroup_Parameters
        if v in data and v != "rlnOpticsGroup"
    ]
    if "rlnOpticsGroup" in data:
        if not vars:
            return
        rows = []
        for gn, gdata in data.groupby("rlnOpticsGroup", sort=False):
            d = {"rlnOpticsGroup": gn, "rlnOpticsGroupName": f"opticsGroup{gn}"}
            for v in vars:
                d[v] = gdata[v].values[0]
            rows.append(d)
        data.attrs["optics"] = pd.DataFrame(rows)
        data.drop(columns=vars, inplace=True)
        return
    if not vars:
        return
    rows = []
    group_ids = pd.Series(0, index=data.index, dtype=np.int64)
    for gi, (gn, gdata) in enumerate(
        data.groupby(vars if len(vars) > 1 else vars[0], sort=False)
    ):
        d = {"rlnOpticsGroup": gi + 1, "rlnOpticsGroupName": f"opticsGroup{gi + 1}"}
        for v in vars:
            d[v] = gdata[v].values[0]
        rows.append(d)
        group_ids.loc[gdata.index] = gi + 1
    data["rlnOpticsGroup"] = group_ids
    data.attrs["optics"] = pd.DataFrame(rows)
    data.drop(columns=vars, inplace=True)


def remove_invalid_opticsgroup_parameters(data: pd.DataFrame) -> None:
    """Drop non-RELION columns from the optics block (io.py:826-977)."""
    optics = data.attrs.get("optics")
    if optics is None:
        return
    bad = [c for c in optics.columns if c not in Relion_OpticsGroup_Parameters]
    if bad:
        optics.drop(columns=bad, inplace=True)


# ---------------------------------------------------------------------------
# readers (io.py:365-547, 978-1058, 1412-1537, 1561-1711)
# ---------------------------------------------------------------------------


def star2dataframe(
    starFile,
    alternative_folders=(),
    ignore_bad_particle_path: int = 0,
    ignore_bad_micrograph_path: int = 1,
) -> pd.DataFrame:
    """RELION star -> DataFrame with optics attached (io.py:978-1058)."""
    blocks = read_star(starFile)
    data = None
    for k in ("movies", "micrographs", "particles", "coordinate_files"):
        if k in blocks and isinstance(blocks[k], pd.DataFrame):
            data = blocks[k]
            break
    if data is None and "images" in blocks:
        data = blocks["images"]
    if data is None:
        # fall back to the first loop block that is not optics
        for k, v in blocks.items():
            if k != "optics" and isinstance(v, pd.DataFrame):
                data = v
                break
    assert data is not None, f"{starFile}: no data block found"
    if "optics" in blocks and isinstance(blocks["optics"], pd.DataFrame):
        data.attrs["optics"] = blocks["optics"]
    data = dataframe_guess_data_type(data)
    nans = data.isnull().any(axis=1)
    if nans.sum() > 0:
        logger.warning(
            "%s: %d/%d corrupted rows ignored", starFile, int(nans.sum()), len(data)
        )
        attrs = dict(data.attrs)
        data = data[~nans]
        data.attrs.update(attrs)
    data.attrs["source_path"] = str(starFile)
    data.attrs["convention"] = "relion"
    dataframe_normalize_filename(
        data, alternative_folders, ignore_bad_particle_path, ignore_bad_micrograph_path
    )
    return data


def csv2dataframe(
    csvFile,
    alternative_folders=(),
    ignore_bad_particle_path: int = 0,
    ignore_bad_micrograph_path: int = 1,
) -> pd.DataFrame:
    """CryoSPARC v0/v1 csv -> DataFrame (io.py csv reader)."""
    data = pd.read_csv(csvFile, comment="#")
    data = dataframe_guess_data_type(data)
    data.attrs["source_path"] = str(csvFile)
    data.attrs["convention"] = "cryosparc"
    return data


def cs2dataframe(
    csFile,
    passthrough_files=(),
    alternative_folders=(),
    ignore_bad_particle_path: int = 0,
    ignore_bad_micrograph_path: int = 1,
    warn_missing_ctf: int = 1,
) -> pd.DataFrame:
    """CryoSPARC v2+ .cs -> DataFrame with passthrough merge
    (io.py:1412-1537)."""
    cs = read_cs(csFile)
    data = pd.DataFrame.from_records(cs.tolist(), columns=cs.dtype.names)
    pt_final = list(passthrough_files)
    if not pt_final:
        p = Path(csFile)
        pattern = (
            f"*J[0-9]*_passthrough_{p.name}"
            if p.name.startswith("particles_")
            else "*J[0-9]*_passthrough_particles.cs"
        )
        ptfs = sorted(p.parent.glob(pattern))
        if ptfs:
            pt_final.append(ptfs[0])
    for f in pt_final:
        extra = read_cs(f)
        extra_df = pd.DataFrame.from_records(extra.tolist(), columns=extra.dtype.names)
        drop = [c for c in extra_df.columns if c != "uid" and c in data.columns]
        if drop:
            extra_df = extra_df.drop(columns=drop)
        data = data.merge(extra_df, on="uid", how="left")
    data = data.loc[:, ~data.columns.duplicated()]
    if "blob/path" not in data and "micrograph_blob/path" not in data:
        raise HeliconIOError(
            f"{csFile}: no particle/micrograph path info; columns: "
            f"{list(data.columns)}"
        )
    if (
        warn_missing_ctf
        and "ctf/accel_kv" not in data
        and "templates_selected.cs" not in str(csFile)
    ):
        logger.warning("CTF info not found; provide the passthrough file with CTF")
    if "ctf/type" in data:
        data = data.drop("ctf/type", axis=1)
    data = dataframe_guess_data_type(data)
    # drop corrupted rows (io.py:1515-1529): uids missing from the
    # passthrough leave NaN cells after the how="left" merge; keeping
    # them crashes downstream int casts or writes literal nans
    nans = data.isnull().any(axis=1)
    if nans.sum() > 0:
        logger.warning(
            "%s: %d/%d particle rows are corrupted and thus ignored",
            csFile, int(nans.sum()), len(data),
        )
        data = data[~nans]
    data.attrs["source_path"] = str(csFile)
    data.attrs["convention"] = "cryosparc"
    dataframe_normalize_filename(
        data, alternative_folders, ignore_bad_particle_path, ignore_bad_micrograph_path
    )
    return data


def cistem2dataframe(
    dbFile,
    alternative_folders=(),
    ignore_bad_particle_path: int = 0,
    ignore_bad_micrograph_path: int = 1,
) -> pd.DataFrame:
    """cisTEM sqlite .db -> RELION-convention DataFrame (io.py:1561-1711).

    dbFile may be ``<refinement>@<file>.db`` to pick a refinement result.
    """
    import sqlite3

    if "@" in str(dbFile):
        sel, realFile = str(dbFile).split("@", 1)
    else:
        sel, realFile = None, str(dbFile)
    con = sqlite3.connect(realFile)
    try:
        tables = [
            r[0]
            for r in con.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"
            ).fetchall()
        ]
        def _refinement_round(name: str) -> int:
            digits = [int(p) for p in name.split("_") if p.isdigit()]
            return digits[0] if digits else -1

        # NUMERIC sort on the refinement id (io.py:1598: max REFINEMENT_ID
        # wins) — lexicographic order would pick round 9 over round 10
        result_tables = sorted(
            (t for t in tables if t.upper().startswith("REFINEMENT_RESULT_")),
            key=_refinement_round,
        )
        if not result_tables:
            raise HeliconIOError(f"{realFile}: no REFINEMENT_RESULT tables")
        table = (
            f"REFINEMENT_RESULT_{sel}" if sel else result_tables[-1]
        )
        df = pd.read_sql_query(f"SELECT * FROM {table}", con)
    finally:
        con.close()
    colmap = {
        "POSITION_IN_STACK": None,
        "PSI": "rlnAnglePsi",
        "THETA": "rlnAngleTilt",
        "PHI": "rlnAngleRot",
        "XSHIFT": "rlnOriginXAngst",
        "YSHIFT": "rlnOriginYAngst",
        "DEFOCUS1": "rlnDefocusU",
        "DEFOCUS2": "rlnDefocusV",
        "DEFOCUS_ANGLE": "rlnDefocusAngle",
        "PHASE_SHIFT": "rlnPhaseShift",
        "OCCUPANCY": "rlnMaxValueProbDistribution",
        "LOGP": "rlnLogLikeliContribution",
        "SCORE": "rlnParticleScore",
    }
    ret = pd.DataFrame()
    for src, dst in colmap.items():
        if dst and src in df.columns:
            col = df[src]
            if src in ("XSHIFT", "YSHIFT"):
                # cisTEM shifts are the NEGATIVE of RELION origins
                # (io.py:1692-1694); keep Angstroms (rlnOriginXAngst)
                col = -col.astype(float)
            elif src == "PHASE_SHIFT":
                # cisTEM stores radians; RELION expects degrees
                # (io.py:1695-1697)
                col = np.rad2deg(col.astype(float)).round(1)
            ret[dst] = col
    if "POSITION_IN_STACK" in df.columns:
        ret["rlnImageName"] = (
            df["POSITION_IN_STACK"].astype(int).map("{:06d}".format)
            + "@"
            + str(Path(realFile).with_suffix(".mrcs"))
        )
    ret.attrs["source_path"] = str(dbFile)
    ret.attrs["convention"] = "relion"
    return ret


def image2dataframe(
    inputFile,
    csparc_passthrough_files=(),
    alternative_folders=(),
    ignore_bad_particle_path: int = 0,
    ignore_bad_micrograph_path: int = 1,
    warn_missing_ctf: int = 1,
) -> pd.DataFrame:
    """Dispatch one metadata/image file by extension (io.py:463-547)."""
    inputFile = str(inputFile)
    realInputFile = inputFile.split("@")[-1] if inputFile.endswith(".db") else inputFile
    if not Path(realInputFile).exists():
        raise HeliconIOError(f"cannot find file {realInputFile}")
    if inputFile.endswith(".star"):
        p = star2dataframe(
            inputFile, alternative_folders, ignore_bad_particle_path,
            ignore_bad_micrograph_path,
        )
    elif inputFile.endswith(".csv"):
        p = csv2dataframe(
            inputFile, alternative_folders, ignore_bad_particle_path,
            ignore_bad_micrograph_path,
        )
    elif inputFile.endswith(".cs"):
        p = cs2dataframe(
            inputFile, csparc_passthrough_files, alternative_folders,
            ignore_bad_particle_path, ignore_bad_micrograph_path, warn_missing_ctf,
        )
    elif inputFile.endswith(".db"):
        p = cistem2dataframe(
            inputFile, alternative_folders, ignore_bad_particle_path,
            ignore_bad_micrograph_path,
        )
    else:  # raw image stack
        n = get_image_number(inputFile)
        p = pd.DataFrame(
            {"rlnImageName": [f"{i + 1}@{inputFile}" for i in range(n)]}
        )
        p.attrs["convention"] = "relion"
    p.attrs["source_path"] = inputFile
    return p


def images2dataframe(
    inputFiles,
    csparc_passthrough_files=(),
    alternative_folders=(),
    ignore_bad_particle_path: int = 0,
    ignore_bad_micrograph_path: int = 1,
    warn_missing_ctf: int = 1,
    target_convention=None,
) -> pd.DataFrame:
    """Multi-file ingest with optional convention conversion
    (io.py:365-462)."""
    if isinstance(inputFiles, (str, Path)):
        data = image2dataframe(
            inputFiles, csparc_passthrough_files, alternative_folders,
            ignore_bad_particle_path, ignore_bad_micrograph_path, warn_missing_ctf,
        )
        if target_convention:
            data = dataframe_convert(data, target=target_convention)
        return data
    datalist, opticslist = [], []
    group_offset = 0
    for f in inputFiles:
        p = image2dataframe(
            f, csparc_passthrough_files, alternative_folders,
            ignore_bad_particle_path, ignore_bad_micrograph_path, warn_missing_ctf,
        )
        optics = p.attrs.get("optics")
        if optics is not None and "rlnOpticsGroup" in optics:
            # renumber per-file optics groups so concatenated files
            # cannot collide (two files both using group 1 would apply
            # the FIRST file's optics to the second file's particles)
            if group_offset:
                optics = optics.copy()
                optics["rlnOpticsGroup"] = (
                    optics["rlnOpticsGroup"].astype(int) + group_offset
                )
                if "rlnOpticsGroup" in p:
                    p["rlnOpticsGroup"] = (
                        p["rlnOpticsGroup"].astype(int) + group_offset
                    )
                p.attrs["optics"] = optics
            if len(optics):
                group_offset = int(optics["rlnOpticsGroup"].astype(int).max())
        datalist.append(p)
        if optics is not None:
            opticslist.append(optics)
    convention = target_convention
    if convention is None:
        types = {
            "relion" if str(f).endswith(".star") else "cryosparc"
            for f in inputFiles
            if str(f).endswith((".star", ".cs"))
        }
        if len(types) > 1:
            convention = "relion" if "relion" in types else "cryosparc"
    if convention:
        datalist = [dataframe_convert(p, target=convention) for p in datalist]
    for p in datalist:
        # concat's __finalize__ compares attrs dicts across frames;
        # DataFrame-valued attrs (optics) make that comparison raise.
        # The merged attrs are rebuilt below anyway.
        p.attrs = {}
    data = pd.concat(datalist, sort=False)
    data.attrs["optics"] = pd.concat(opticslist, sort=False) if opticslist else None
    data.attrs["convention"] = convention
    data.attrs["source_path"] = list(map(str, inputFiles))
    data.reset_index(drop=True, inplace=True)
    return data


# ---------------------------------------------------------------------------
# writers (io.py:550-580, 1099-1186, 1538-1560)
# ---------------------------------------------------------------------------


def _star_column_lines(frame: pd.DataFrame, keys) -> pd.Series:
    """Tab-joined row strings with float columns rounded to 6 — ALL of
    them, including the first (it used to get raw str(), writing
    0.30000000000000004-style reprs)."""

    def fmt(col):
        return (
            col.round(6).astype(str)
            if col.dtype == np.float64
            else col.astype(str)
        )

    lines = fmt(frame[keys[0]])
    for k in keys[1:]:
        lines = lines + "\t" + fmt(frame[k])
    return lines


def dataframe2star(data: pd.DataFrame, starFile, format: str = "v3") -> None:
    """DataFrame -> RELION star (v3 builds optics; else dissolves)
    (io.py:1099-1186)."""
    data2 = dataframe_convert(data, target="relion").copy()
    data2.attrs = dict(data.attrs)
    data2.attrs["convention"] = "relion"
    if "rlnImageName" in data2:
        data2 = mrc2mrcs(data2)
    if format in ("v3", "relion3"):
        star_build_opticsgroup(data2)
        remove_invalid_opticsgroup_parameters(data2)
        # classify on the CONVERTED frame: a cryoSPARC micrograph input
        # only gains its rln columns in data2
        data_block_tag = (
            "data_micrographs"
            if "rlnImageName" not in data2 and "rlnMicrographName" in data2
            else "data_particles"
        )
    else:
        star_dissolve_opticsgroup(data2)
        data_block_tag = "data_"
    data2 = dataframe_guess_data_type(data2)

    fp = starFile if hasattr(starFile, "write") else open(starFile, "wt")
    close = not hasattr(starFile, "write")
    try:
        optics = data2.attrs.get("optics")
        if optics is not None and len(optics) > 0:
            fp.write("\n# version 30001\n\ndata_optics\n\nloop_ \n")
            keys = [k for k in optics.columns if k.startswith("rln")]
            for ki, k in enumerate(keys):
                fp.write(f"_{k} #{ki + 1} \n")
            fp.write("\n".join(_star_column_lines(optics, keys)) + "\n\n")
        fp.write(f"\n{data_block_tag}\n\nloop_ \n")
        keys = [k for k in data2.columns if k.startswith("rln")]
        for ki, k in enumerate(keys):
            fp.write(f"_{k} #{ki + 1} \n")
        fp.write("\n".join(_star_column_lines(data2, keys)) + "\n")
    finally:
        if close:
            fp.close()


def dataframe2cs(data: pd.DataFrame, csFile) -> None:
    """DataFrame -> .cs file (io.py:1538-1560)."""
    write_cs(csFile, dataframe_to_cs_array(data))


def dataframe_to_cs_array(data: pd.DataFrame) -> np.ndarray:
    """DataFrame -> CryoSPARC structured array (io.py:1538-1560).

    Object columns holding fixed-length arrays (e.g. alignments3D/pose)
    become subarray fields; other object columns become byte strings.
    Used by the .cs writer and by the server write-back path.
    """
    dtypes = []
    columns = list(data.columns)
    for name in columns:
        col = data[name]
        if col.dtype.kind == "O" and len(col):
            first = col.iloc[0]
            if isinstance(first, (np.ndarray, list, tuple)):
                arr0 = np.asarray(first)
                dtypes.append((name, arr0.dtype if arr0.dtype.kind != "O" else np.float32, arr0.shape))
                continue
            max_len = max((len(str(v)) for v in col), default=1)
            dtypes.append((name, f"S{max_len}"))
        elif col.dtype.kind == "O":
            dtypes.append((name, "S1"))
        else:
            dtypes.append((name, col.dtype))
    out = np.zeros(len(data), dtype=dtypes)
    for name in columns:
        col = data[name]
        if col.dtype.kind == "O" and len(col) and isinstance(
            col.iloc[0], (np.ndarray, list, tuple)
        ):
            out[name] = np.stack([np.asarray(v) for v in col.values])
        elif col.dtype.kind == "O":
            out[name] = [str(v).encode() for v in col.values]
        else:
            out[name] = col.values
    return out


def dataframe2file(data: pd.DataFrame, outputFile: str) -> None:
    """Dispatch writer by extension (io.py:550-580)."""
    if len(data) < 1:
        raise HeliconValueError(f"dataframe2file({outputFile}): data is empty")
    if outputFile.endswith(".oldformat.star"):
        dataframe2star(data, outputFile, format="old")
    elif outputFile.endswith(".star"):
        dataframe2star(data, outputFile, format="v3")
    elif outputFile.endswith(".csv"):
        data.to_csv(outputFile)
    elif outputFile.endswith(".cs"):
        dataframe2cs(data, outputFile)
    else:
        raise HeliconValueError(
            f"dataframe2file({outputFile}): only .star/.csv/.cs supported"
        )


# ---------------------------------------------------------------------------
# path normalization (io.py:1712-1917, simplified)
# ---------------------------------------------------------------------------


def dataframe_normalize_filename(
    data: pd.DataFrame,
    alternative_folders=(),
    ignore_bad_particle_path: int = 0,
    ignore_bad_micrograph_path: int = 1,
) -> pd.DataFrame:
    """Resolve particle/micrograph paths to absolute paths, in place
    (io.py:1712-1917): candidates are the filename itself, its basename,
    the .mrcs twin of a .mrc name, each tried against the alternative
    folders, the source file's folder(s) (including ../ and ../../), and
    the RELION project folder. ignore_bad_particle_path >= 2 skips
    normalization entirely; an unresolvable path raises HeliconIOError
    unless the column's ignore flag is set (then the original is kept).
    """
    from ..utils.exceptions import HeliconIOError

    if ignore_bad_particle_path >= 2 or not len(data):
        return data
    src = data.attrs.get("source_path")
    src_list = src if isinstance(src, (list, tuple, set)) else [src or "."]
    resolved_cache: dict = {}

    def resolve(filename: str, ignore_bad_path: int) -> str:
        if filename in resolved_cache:
            return resolved_cache[filename]
        basenames = []
        if not Path(filename).is_absolute():
            basenames.append(filename)
        basenames.append(Path(filename).name)
        basenames += [f[:-4] + ".mrcs" for f in basenames if f.endswith(".mrc")]

        folders = [str(f) for f in alternative_folders]
        folders += [str(Path(sp).resolve().parent) for sp in src_list]
        relion_folder = get_relion_project_folder(filename)
        if relion_folder is not None:
            folders.append(str(relion_folder))

        choices = [filename]
        for basename in basenames:
            for folder in folders:
                choices += [
                    str(Path(folder) / basename),
                    str(Path(folder) / ".." / basename),
                    str(Path(folder) / "../.." / basename),
                ]
        match = None
        for fc in choices:
            if Path(fc).is_file():
                match = fc
                break
        if match:
            ret = str(Path(match).resolve())
            # pre-map same-type files of the matched folder (io.py:1812-1823)
            import glob

            suffix = Path(filename).suffix
            filename_dir = Path(filename).parent
            for f in glob.glob(str(Path(match).parent / ("*" + Path(match).suffix))):
                resolved_cache.setdefault(
                    str(filename_dir / (Path(f).stem + suffix)),
                    str(Path(f).resolve()),
                )
        elif ignore_bad_path:
            ret = filename
        else:
            raise HeliconIOError(
                f"cannot find image {filename} in file {src} after trying "
                f"{len(choices)} locations (first: {choices[:4]})"
            )
        resolved_cache[filename] = ret
        return ret

    plain, with_at = [], []
    for attr in (
        "rlnImageName rlnMicrographName rlnMicrographMovieName "
        "rlnMicrographCoordinates"
    ).split():
        if attr in data:
            ignore = (
                ignore_bad_particle_path
                if attr == "rlnImageName"
                else ignore_bad_micrograph_path
            )
            if "@" in str(data[attr].iloc[0]):
                with_at.append((attr, ignore))
            else:
                plain.append((attr, ignore))
    for attr in "data_input_relpath blob/path filename".split():
        if attr in data:
            plain.append((attr, ignore_bad_particle_path))
    for attr in "micrograph_blob/path location/micrograph_path micrograph".split():
        if attr in data:
            plain.append((attr, ignore_bad_micrograph_path))

    for attr, ignore in plain:
        cache = {f: resolve(str(f), ignore) for f in data[attr].unique()}
        data[attr] = data[attr].map(cache)
    for attr, ignore in with_at:
        tmp = data[attr].str.split("@", expand=True)
        indices, filenames = tmp.iloc[:, 0], tmp.iloc[:, -1]
        cache = {f: resolve(str(f), ignore) for f in filenames.unique()}
        data[attr] = indices + "@" + filenames.map(cache)
    return data


# ---------------------------------------------------------------------------
# astigmatism conventions (io.py:1918-1983)
# ---------------------------------------------------------------------------


def relion_astigmatism_to_eman(defocusU, defocusV, defocusAngleDeg):
    """(defocus_mean_um, dfdiff_um, dfang_deg) from RELION (A, A, deg)
    (io.py:1918-1952: dfdiff = |U - V| / 2, angle rotated by 90 when
    U > V so dfang always points along the SMALLEST defocus)."""
    defocus = (float(defocusU) + float(defocusV)) / 2 / 1e4
    dfdiff = abs(float(defocusU) - float(defocusV)) / 2 / 1e4
    if defocusU > defocusV:
        dfang = math.fmod(float(defocusAngleDeg) + 360.0 + 90.0, 360.0)
    else:
        dfang = float(defocusAngleDeg)
    return defocus, dfdiff, dfang


def eman_astigmatism_to_relion(defocus_um, dfdiff_um, dfang_deg):
    """Inverse of relion_astigmatism_to_eman (io.py:1955-1983: U/V swap
    by the angle quadrant, angle reduced mod 90)."""
    if math.fmod(float(dfang_deg) + 360.0, 180.0) < 90.0:
        defocusU = float(defocus_um) - float(dfdiff_um)
        defocusV = float(defocus_um) + float(dfdiff_um)
    else:
        defocusU = float(defocus_um) + float(dfdiff_um)
        defocusV = float(defocus_um) - float(dfdiff_um)
    return defocusU * 1e4, defocusV * 1e4, math.fmod(float(dfang_deg) + 360.0, 90.0)


# ---------------------------------------------------------------------------
# conventions (io.py:1984-2370)
# ---------------------------------------------------------------------------


def get_dataframe_convention(data: pd.DataFrame) -> str:
    c = data.attrs.get("convention")
    if c:
        return c
    if any(
        k in data
        for k in "rlnImageName rlnMicrographName rlnMicrographMovieName rlnVoltage".split()
    ):
        return "relion"
    if any(
        k in data
        for k in "blob/path micrograph_blob/path movie_blob/path location/micrograph_path".split()
    ):
        return "cryosparc"
    raise AttributeError(
        "get_dataframe_convention(): unrecognized dataframe convention"
    )


def dataframe_convert(data: pd.DataFrame, target: str = "relion") -> pd.DataFrame:
    data.attrs["convention"] = get_dataframe_convention(data)
    if data.attrs["convention"] == target:
        return data
    if data.attrs["convention"] == "relion" and target == "cryosparc":
        return dataframe_relion_to_cryosparc(data)
    if data.attrs["convention"] == "cryosparc" and target == "relion":
        return dataframe_cryosparc_to_relion(data)
    raise AttributeError(
        f"dataframe_convert(): cannot convert {data.attrs['convention']} -> {target}"
    )


def _electron_wavelength(voltage_kv):
    """Relativistic electron wavelength in Angstroms (io.py:2068-2089)."""
    h = 6.62607015e-34
    m_e = 9.1093837e-31
    e = 1.602176634e-19
    c = 299792458
    V = np.asarray(voltage_kv, dtype=float) * 1000.0
    lam = h / np.sqrt(2 * m_e * e * V * (1 + e * V / (2 * m_e * c**2)))
    return lam * 1e10


def clean_cs_micrograph_path(path: str) -> str:
    """Strip cryoSPARC uid prefix + doseweighted suffix (io.py:2090-2110)."""
    name = Path(path).name
    parts = name.split("_", 1)
    if len(parts) == 2 and len(parts[0]) > 10 and parts[0].isdigit():
        name = parts[1]
    return name.replace("_patch_aligned_doseweighted", "")


def dataframe_cryosparc_to_relion(data: pd.DataFrame) -> pd.DataFrame:
    """CryoSPARC columns -> RELION columns (io.py:2111-2370)."""
    data.attrs["convention"] = get_dataframe_convention(data)
    if data.attrs["convention"] == "relion":
        return data

    ret = pd.DataFrame()
    if "blob/idx" in data and "blob/path" in data:
        ret["rlnImageName"] = (
            (data["blob/idx"].astype(int) + 1).map("{:06d}".format)
            + "@"
            + data["blob/path"].astype(str)
        )
    if "micrograph_blob/path" in data:
        ret["rlnMicrographName"] = data["micrograph_blob/path"].astype(str)
    if "location/micrograph_path" in data:
        ret["rlnMicrographName"] = data["location/micrograph_path"].astype(str)
    if "movie_blob/path" in data:
        ret["rlnMicrographMovieName"] = data["movie_blob/path"].astype(str)
    if "ctf/accel_kv" in data:
        ret["rlnVoltage"] = data["ctf/accel_kv"]
    if "ctf/cs_mm" in data:
        ret["rlnSphericalAberration"] = data["ctf/cs_mm"]
    if "ctf/amp_contrast" in data:
        ret["rlnAmplitudeContrast"] = data["ctf/amp_contrast"]
    if {"ctf/df1_A", "ctf/df2_A", "ctf/df_angle_rad"} <= set(data.columns):
        ret["rlnDefocusU"] = data["ctf/df1_A"]
        ret["rlnDefocusV"] = data["ctf/df2_A"]
        ret["rlnDefocusAngle"] = np.rad2deg(data["ctf/df_angle_rad"])
    if "ctf/phase_shift_rad" in data:
        ret["rlnPhaseShift"] = np.rad2deg(data["ctf/phase_shift_rad"])
    if "ctf/ctf_fit_to_A" in data:
        ret["rlnCtfMaxResolution"] = data["ctf/ctf_fit_to_A"]
    if "blob/psize_A" in data:
        ret["rlnImagePixelSize"] = data["blob/psize_A"]
    if "micrograph_blob/psize_A" in data:
        ret["rlnMicrographPixelSize"] = data["micrograph_blob/psize_A"]
    if "alignments3D/split" in data:
        ret["rlnRandomSubset"] = data["alignments3D/split"] + 1
    if "alignments2D/class" in data:
        ret["rlnClassNumber"] = data["alignments2D/class"].astype(int) + 1

    origin_x = origin_y = None
    if "alignments2D/shift" in data:
        shifts = pd.DataFrame(data["alignments2D/shift"].tolist()).round(2)
        origin_x = -shifts.iloc[:, 0]
        origin_y = -shifts.iloc[:, 1]
    if "alignments2D/pose" in data:
        ret["rlnAnglePsi"] = -np.rad2deg(
            pd.to_numeric(data["alignments2D/pose"], errors="coerce")
        ).round(2)
    if "alignments3D/class" in data:
        ret["rlnClassNumber"] = data["alignments3D/class"].astype(int) + 1
    if "alignments3D/cross_cor" in data:
        ret["rlnLogLikeliContribution"] = data["alignments3D/cross_cor"]
    if "alignments3D/pose" in data:
        from scipy.spatial.transform import Rotation as R

        rotvecs = list(data["alignments3D/pose"].values)
        e = R.from_rotvec(rotvecs).as_euler("ZYZ", degrees=True)
        ret["rlnAngleRot"] = e[:, 0]
        ret["rlnAngleTilt"] = e[:, 1]
        ret["rlnAnglePsi"] = e[:, 2]
    if "alignments3D/shift" in data:
        shifts = pd.DataFrame(data["alignments3D/shift"].tolist()).round(2)
        origin_x = shifts.iloc[:, 0]
        origin_y = shifts.iloc[:, 1]
    if origin_x is not None and "blob/psize_A" in data:
        apix = data["blob/psize_A"].values
        ret["rlnOriginXAngst"] = (origin_x.values * apix).round(6)
        ret["rlnOriginYAngst"] = (origin_y.values * apix).round(6)

    if {"location/center_x_frac", "location/center_y_frac"} <= set(data.columns):
        if "location/micrograph_shape" in data:
            loc_shape = data["location/micrograph_shape"]
        elif "micrograph_blob/shape" in data:
            loc_shape = data["micrograph_blob/shape"]
        else:
            loc_shape = None
        if loc_shape is not None:
            shape_df = pd.DataFrame(loc_shape.tolist())
            my, mx = shape_df.iloc[:, 0], shape_df.iloc[:, 1]
            ret["rlnCoordinateX"] = (
                (data["location/center_x_frac"].values * mx.values).astype(float).round(2)
            )
            ret["rlnCoordinateY"] = (
                (data["location/center_y_frac"].values * my.values).astype(float).round(2)
            )

    if "filament/filament_uid" in data:
        if "blob/path" in data:
            if data["filament/filament_uid"].min() > 1000:
                for _, m in data.groupby("blob/path"):
                    mapping = {
                        v: i + 1
                        for i, v in enumerate(sorted(m["filament/filament_uid"].unique()))
                    }
                    ret.loc[m.index, "rlnHelicalTubeID"] = m[
                        "filament/filament_uid"
                    ].map(mapping)
            else:
                ret["rlnHelicalTubeID"] = data["filament/filament_uid"].astype(int)
            if "filament/position_A" in data:
                for _, f in data.groupby(["blob/path", "filament/filament_uid"]):
                    val = f["filament/position_A"].astype(np.float32).values.copy()
                    val -= np.min(val)
                    ret.loc[f.index, "rlnHelicalTrackLengthAngst"] = val.round(2)
        else:
            mapping = {
                v: i + 1
                for i, v in enumerate(sorted(data["filament/filament_uid"].unique()))
            }
            ret["rlnHelicalTubeID"] = data["filament/filament_uid"].map(mapping)
    if "filament/filament_pose" in data:
        ret["rlnAngleRotPrior"] = 0.0
        ret["rlnAngleTiltPrior"] = 90.0
        ret["rlnAnglePsiPrior"] = np.round(
            -np.rad2deg(pd.to_numeric(data["filament/filament_pose"], errors="coerce")), 1
        )
        ret["rlnAnglePsiFlipRatio"] = 0.5
    if "ctf/bfactor" in data:
        ret["rlnCtfBfactor"] = data["ctf/bfactor"]
    if "ctf/scale" in data:
        ret["rlnCtfScalefactor"] = data["ctf/scale"]
    if {"ctf/tilt_A", "ctf/cs_mm"} <= set(data.columns):
        cs_mm = data["ctf/cs_mm"].values
        tilt_vals = np.stack(data["ctf/tilt_A"].values)
        ret["rlnBeamTiltX"] = (np.arcsin(tilt_vals[:, 0] / cs_mm * 1e-7) * 1e3).round(8)
        ret["rlnBeamTiltY"] = (np.arcsin(tilt_vals[:, 1] / cs_mm * 1e-7) * 1e3).round(8)
    if "ctf/anisomag" in data:
        vals = np.stack(data["ctf/anisomag"].values)
        ret["rlnMagMat00"] = vals[:, 0]
        ret["rlnMagMat01"] = vals[:, 1]
        ret["rlnMagMat10"] = vals[:, 2]
        ret["rlnMagMat11"] = vals[:, 3]
    for exp_col in (
        "ctf/exp_group_id",
        "location/exp_group_id",
        "mscope_params/exp_group_id",
    ):
        if exp_col in data:
            ret["rlnOpticsGroup"] = data[exp_col].astype(int)
            break
    import fnmatch

    for col in data.columns:
        if fnmatch.fnmatch(col, "components_mode_*/value"):
            ci = col.split("/")[0].split("_")[-1]
            ret[f"v3d{ci}"] = data[col]

    if len(ret.columns) == 0:
        raise HeliconValueError(
            f"dataframe_cryosparc_to_relion(): no supported parameters in "
            f"{list(data.columns)}"
        )
    ret = reorder_dataframe_columns(ret)
    ret.attrs["source_path"] = data.attrs.get("source_path")
    ret.attrs["convention"] = "relion"
    return ret


def dataframe_relion_to_cryosparc(data: pd.DataFrame) -> pd.DataFrame:
    """RELION columns -> CryoSPARC columns.

    The reference *calls* this (io.py:2056) but never defines it; this is
    the evident inverse of dataframe_cryosparc_to_relion.
    """
    data.attrs["convention"] = get_dataframe_convention(data)
    if data.attrs["convention"] == "cryosparc":
        return data
    work = data.copy()
    work.attrs = dict(data.attrs)
    optics = work.attrs.get("optics")
    if optics is not None:
        star_dissolve_opticsgroup(work)
    # ret["uid"] below pins a fresh RangeIndex on ret; a non-default
    # input index (e.g. after star2dataframe drops corrupted rows) would
    # otherwise misalign every subsequent Series assignment to NaN
    work = work.reset_index(drop=True)
    work.attrs = dict(data.attrs)

    ret = pd.DataFrame()
    ret["uid"] = np.arange(1, len(work) + 1, dtype=np.uint64)
    if "rlnImageName" in work:
        parts = work["rlnImageName"].str.split("@", expand=True)
        ret["blob/idx"] = parts.iloc[:, 0].astype(int) - 1
        ret["blob/path"] = parts.iloc[:, -1]
    if "rlnMicrographName" in work:
        ret["location/micrograph_path"] = work["rlnMicrographName"]
    if "rlnMicrographMovieName" in work:
        ret["movie_blob/path"] = work["rlnMicrographMovieName"]
    if "rlnVoltage" in work:
        ret["ctf/accel_kv"] = work["rlnVoltage"]
    if "rlnSphericalAberration" in work:
        ret["ctf/cs_mm"] = work["rlnSphericalAberration"]
    if "rlnAmplitudeContrast" in work:
        ret["ctf/amp_contrast"] = work["rlnAmplitudeContrast"]
    if {"rlnDefocusU", "rlnDefocusV", "rlnDefocusAngle"} <= set(work.columns):
        ret["ctf/df1_A"] = work["rlnDefocusU"]
        ret["ctf/df2_A"] = work["rlnDefocusV"]
        ret["ctf/df_angle_rad"] = np.deg2rad(work["rlnDefocusAngle"])
    if "rlnPhaseShift" in work:
        ret["ctf/phase_shift_rad"] = np.deg2rad(work["rlnPhaseShift"])
    if "rlnImagePixelSize" in work:
        ret["blob/psize_A"] = work["rlnImagePixelSize"]
    if "rlnClassNumber" in work:
        ret["alignments2D/class"] = work["rlnClassNumber"].astype(int) - 1
    if {"rlnAngleRot", "rlnAngleTilt", "rlnAnglePsi"} <= set(work.columns):
        from scipy.spatial.transform import Rotation as R

        e = work[["rlnAngleRot", "rlnAngleTilt", "rlnAnglePsi"]].values
        ret["alignments3D/pose"] = list(
            R.from_euler("ZYZ", e, degrees=True).as_rotvec()
        )
    if {"rlnOriginXAngst", "rlnOriginYAngst"} <= set(work.columns) and (
        "rlnImagePixelSize" in work
    ):
        apix = work["rlnImagePixelSize"].values
        ret["alignments3D/shift"] = list(
            np.stack(
                [
                    work["rlnOriginXAngst"].values / apix,
                    work["rlnOriginYAngst"].values / apix,
                ],
                axis=1,
            )
        )
    if "rlnHelicalTubeID" in work:
        ret["filament/filament_uid"] = work["rlnHelicalTubeID"].astype(int)
    if "rlnOpticsGroup" in work:
        ret["ctf/exp_group_id"] = work["rlnOpticsGroup"].astype(int)
    ret.attrs["source_path"] = data.attrs.get("source_path")
    ret.attrs["convention"] = "cryosparc"
    return ret


# ---------------------------------------------------------------------------
# beam-shift clustering (io.py:244-350)
# ---------------------------------------------------------------------------


def assign_beamshifts_to_cluster(
    beamshifts,
    n_clusters: int | None = None,
    plot: bool = False,
    range_n_clusters=None,
    min_cluster_size: int = 1,
    cpu: int = -1,
    verbose: int = 0,
    *,
    device="cuda",
):
    """Cluster (x, y) beam shifts into exposure groups (io.py:279-350).

    Uses KMeans with auto cluster count by silhouette elbow when
    n_clusters is None. Returns integer labels starting at 1.

    range_n_clusters / min_cluster_size / cpu / verbose mirror the
    reference signature (io.py:279): candidate cluster counts for the
    silhouette search, the smallest acceptable cluster (counts whose
    best split produces a smaller cluster are rejected), and
    accepted-and-ignored parallelism/verbosity knobs.

    The reference's scikit-learn ``KMeans(n_init=3 | 10, random_state=0)``
    and ``silhouette_score`` are ``clustering.kmeans`` and
    ``clustering.silhouette_score``: the same labels, Lloyd's iterations
    and the pair distances in float64 on ``device``.
    """
    from ..clustering import kmeans, silhouette_score

    X = np.asarray(beamshifts, float)
    assert X.ndim == 2 and X.shape[1] == 2
    if n_clusters is None:
        if range_n_clusters is None:
            range_n_clusters = range(2, min(50, len(X)))
        best_k, best_s = 1, -1.0
        for k in range_n_clusters:
            if k >= len(X):
                break
            labels = kmeans(X, k, n_init=3, device=device)[0]
            try:
                s = silhouette_score(X, labels, device=device)
            except ValueError:
                continue
            if min_cluster_size > 1:
                sizes = np.bincount(labels)
                if sizes[sizes > 0].min() < min_cluster_size:
                    continue
            if s > best_s:
                best_k, best_s = k, s
            elif s < best_s - 0.1:
                break
        n_clusters = best_k
    return kmeans(X, n_clusters, n_init=10, device=device)[0] + 1


def mrc2mrcs(data: pd.DataFrame) -> pd.DataFrame:
    """Symlink .mrc particle stacks as .mrcs for RELION (io.py:2371-2433)."""
    attrs = dict(data.attrs)
    if "rlnImageName" in data:
        tmp = data["rlnImageName"].str.split("@", expand=True)
        pid = tmp.iloc[:, 0]
        data = data.copy()
        data.loc[:, "filename"] = tmp.iloc[:, -1]
    if "filename" not in data:
        return data
    names = set(data["filename"])
    mapping = {f: f for f in names}
    for name in [f for f in names if f.endswith(".mrc")]:
        mrc_path = Path(name)
        if not mrc_path.exists():
            continue
        mrc_resolved = mrc_path.resolve()
        mrcs_path = mrc_path.with_suffix(".mrcs")
        if mrcs_path.is_symlink() and mrcs_path.resolve() == mrc_resolved:
            mapping[name] = str(mrcs_path)
            continue
        if mrcs_path.exists():
            st1, st2 = mrcs_path.stat(), mrc_resolved.stat()
            if st1.st_ino == st2.st_ino and st1.st_dev == st2.st_dev:
                mapping[name] = str(mrcs_path)
                continue
        folder = mrc_path.parent
        if mrcs_path.exists() or not os.access(str(folder), os.W_OK):
            # an UNRELATED <stem>.mrcs already occupies the name (it was
            # neither a symlink nor a hard link to our .mrc — checked
            # above), or the folder is read-only: fall back to a local
            # mrc2mrcs/ dir. Uniquify by the resolved path so two
            # same-basename stacks from different folders cannot silently
            # share one symlink.
            import hashlib

            folder = Path("./mrc2mrcs")
            folder.mkdir(parents=True, exist_ok=True)
            mrcs_path = folder / (mrc_path.name + "s")
            if mrcs_path.is_symlink() or mrcs_path.exists():
                if (
                    mrcs_path.is_symlink()
                    and mrcs_path.resolve() == mrc_resolved
                ):
                    pass  # already ours
                else:
                    tag = hashlib.sha1(
                        str(mrc_resolved).encode()
                    ).hexdigest()[:8]
                    mrcs_path = folder / f"{mrc_path.stem}-{tag}.mrcs"
        mapping[name] = str(mrcs_path)
        if not mrcs_path.exists():
            if mrcs_path.is_symlink():
                mrcs_path.unlink()
            os.symlink(str(mrc_resolved), str(mrcs_path))
    data.loc[:, "filename"] = data["filename"].map(mapping)
    if "rlnImageName" in data:
        data.loc[:, "rlnImageName"] = pid.astype(str) + "@" + data["filename"]
        data = data.drop(columns=["filename"])
    data.attrs.update(attrs)
    return data


def connect_cryosparc(
    cryosparc_server_info_file: str = "$HOME/.cryosparc/cryosparc.toml",
):
    """CryoSPARC server login (io.py:2434-2497) — requires cryosparc-tools.

    Reads credentials from a 600-permission TOML file (license, host,
    base_port, email, password), builds a cryosparc.tools.CryoSPARC
    client, and verifies the connection.
    """
    try:
        from cryosparc.tools import CryoSPARC
    except ImportError as e:
        from ..utils.exceptions import HeliconDependencyError

        raise HeliconDependencyError(
            "connect_cryosparc requires the cryosparc-tools package"
        ) from e
    from ..utils.exceptions import HeliconConfigError

    p = Path(os.path.expandvars(cryosparc_server_info_file))
    if not p.exists():
        raise HeliconConfigError(
            f"CryoSPARC server info file not found: {cryosparc_server_info_file}. "
            "Create it with license/host/base_port/email/password entries and "
            f"run 'chmod 600 {cryosparc_server_info_file}'"
        )
    if oct(p.stat().st_mode)[-3:] != "600":
        raise HeliconConfigError(
            f"Please run 'chmod 600 {cryosparc_server_info_file}' to keep "
            "your server info secure"
        )
    import tomllib

    with open(p, "rb") as fp:
        info = tomllib.load(fp)
    cs = CryoSPARC(
        license=info["license"],
        host=info["host"],
        base_port=info["base_port"],
        email=info["email"],
        password=info["password"],
    )
    if not cs.test_connection():
        from ..utils.exceptions import HeliconError

        raise HeliconError("CryoSPARC server connection test failed")
    return cs


def star_to_dataframe(starFile, logger=None):
    """star2dataframe plus split pid/filename columns (reference
    io.py:1059-1096): identifies rlnImageName or rlnReferenceImage and
    adds 0-based ``pid`` and ``filename`` columns."""
    df = star2dataframe(starFile=starFile)
    fileNameCol = next(
        (c for c in ("rlnImageName", "rlnReferenceImage") if c in df), ""
    )
    if not fileNameCol:
        msg = (
            "cannot find 'rlnImageName' or 'rlnReferenceImage' in the "
            f"input {starFile}"
        )
        if logger:
            logger.error(msg)
        raise KeyError(msg)
    tmp = df[fileNameCol].str.split("@", expand=True)
    df["pid"] = tmp.iloc[:, 0].astype(int) - 1
    df["filename"] = tmp.iloc[:, -1]
    return df
