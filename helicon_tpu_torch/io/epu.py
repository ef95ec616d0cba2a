"""EPU / SerialEM movie metadata: filename patterns, timestamps, beamshift.

A copy of ``helicon_tpu/io/epu.py`` (host code:
numpy and pandas); tests/test_torch_metadata.py pins the copy to the original.

Reference: lib/epu.py (335 LoC). xmltodict is replaced by stdlib
xml.etree (namespace-agnostic tag matching).
"""

from __future__ import annotations

import re
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

from ..utils.exceptions import HeliconIOError

__all__ = [
    "EPU_micrograph_path_2_movie_xml_path",
    "EPU_xml_2_beamshift",
    "assign_beamshift_groups",
    "check_foilhole_xml_files",
    "extract_beamshift",
    "extract_data_collection_time",
    "guess_data_collection_software",
    "movie_filename_patterns",
    "verify_data_collection_software",
]


def movie_filename_patterns() -> dict:
    """Movie filename regexes per collection software (epu.py:23-44)."""
    return dict(
        EPU_old=r"FoilHole_\d{7,8}_Data_\d{6,8}_\d{6,8}_(?P<timestamp>\d{8}_\d{6})_",
        EPU=r"FoilHole_\d{7,8}_Data_\d{7,8}_(?P<beamshift>\d{1,3})_(?P<timestamp>\d{8}_\d{6})_",
        serialEM_pncc=r"_(?P<serial_number>\d{3})_(?P<beamshift>[XY][\+-]\d[XY][\+-]\d-\d)",
        serialEM_embl_heidelberg=r"\d{6}_.{6}_(?P<serial_number>\d{5})_\d-(?P<beamshift>\d{1,2})[_\.]",
        serialEM_cuhksz=r"_(?P<serial_number>\d{5})[_\.]",
    )


def guess_data_collection_software(filename: str):
    """First pattern that matches the filename (epu.py:46-69)."""
    for name, pattern in movie_filename_patterns().items():
        if re.search(pattern, filename) is not None:
            return name
    return None


def verify_data_collection_software(filename: str, software: str):
    """Match object if the filename matches the software's pattern
    (epu.py:70-90)."""
    pattern = movie_filename_patterns().get(software)
    if pattern is None:
        return None
    return re.search(pattern, filename)


def extract_data_collection_time(
    filename: str, software=None, pattern_names=("timestamp",)
):
    """Unix timestamp from the filename (epu.py:91-141)."""
    if software is None:
        software = guess_data_collection_software(filename)
    if software is None:
        return None
    pattern = movie_filename_patterns().get(software)
    if pattern is None:
        return None
    match = re.search(pattern, filename)
    if not match:
        return None
    for name in pattern_names:
        try:
            s = match.group(name)
        except IndexError:
            continue
        dt = datetime.strptime(s, "%Y%m%d_%H%M%S")
        if software == "EPU_old":
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()
    return None


def extract_beamshift(
    filename: str, software=None, pattern_names=("beamshift", "serial_number")
):
    """Beamshift label / serial number from the filename (epu.py:144-188)."""
    if software is None:
        software = guess_data_collection_software(filename)
    if software is None:
        return None
    pattern = movie_filename_patterns().get(software)
    if pattern is None:
        return None
    match = re.search(pattern, filename)
    if not match:
        return None
    for name in pattern_names:
        try:
            return match.group(name)
        except IndexError:
            continue
    return None


def assign_beamshift_groups(micrographs, software: str, start_id: int = 1, **kwargs):
    """Micrograph filename -> 1-indexed beamshift group id (epu.py:190-237)."""
    if software in ("EPU", "serialEM_pncc", "serialEM_embl_heidelberg"):
        mapping = {m: extract_beamshift(m, software=software) for m in micrographs}
        bad = [m for m, v in mapping.items() if v is None]
        if bad:
            from ..utils.exceptions import HeliconValueError

            raise HeliconValueError(
                f"{len(bad)} micrograph name(s) do not match the "
                f"{software} beamshift filename pattern, e.g. {bad[0]!r}"
            )
        unique_vals = sorted(set(mapping.values()))
        id_map = {v: i + start_id for i, v in enumerate(unique_vals)}
        return {m: id_map[mapping[m]] for m in micrographs}
    if software == "serialEM_cuhksz":
        n_per_stage_shift = int(kwargs.get("n_per_stage_shift", 1))
        result = {}
        for m in micrographs:
            i = int(extract_beamshift(m, software=software))
            if i > 0:
                i = i % n_per_stage_shift
                if i == 0:
                    i = n_per_stage_shift
            else:
                i = 0
            result[m] = i
        return result
    raise ValueError(f"Software {software!r} not supported for beam shift grouping")


def check_foilhole_xml_files(micrograph_paths, xml_folder: str = "") -> None:
    """Raise unless FoilHole XMLs are locatable (epu.py:238-267)."""
    sample = micrograph_paths[0]
    if xml_folder:
        xfp = Path(xml_folder)
        if xfp.exists() and xfp.is_dir() and list(xfp.glob("FoilHole_*.xml")):
            return
    if Path(sample).exists() and list(Path(sample).parent.glob("FoilHole_*.xml")):
        return
    raise HeliconIOError(
        f"Cannot find FoilHole XML files for {sample}. "
        "Specify xml_folder=<path> in the parameter string."
    )


def EPU_micrograph_path_2_movie_xml_path(micrograph_path, xml_folder: str = "") -> Path:
    """Matching EPU XML for a micrograph, with a per-folder cache
    (epu.py:268-315)."""
    if not hasattr(EPU_micrograph_path_2_movie_xml_path, "xml_files"):
        EPU_micrograph_path_2_movie_xml_path.xml_files = {}
    xml_files = EPU_micrograph_path_2_movie_xml_path.xml_files
    folder = Path(xml_folder) if xml_folder else Path(micrograph_path).resolve().parent
    if folder not in xml_files:
        xml_files[folder] = list(folder.rglob("*.xml"))
    pattern = r"\d{21}_(FoilHole_\d{7,8}_Data_\d{6,8}_\d{6,8}_\d{8}_\d{6})"
    match = re.search(pattern, str(micrograph_path))
    if not match:
        raise HeliconIOError(
            f"{micrograph_path}: filename inconsistent with EPU pattern {pattern!r}"
        )
    mid = match.group(1)
    matched = [f for f in xml_files[folder] if mid in str(f)]
    if len(matched) != 1:
        raise HeliconIOError(
            f"found {len(matched)} xml files (expected 1) in {folder} for "
            f"{micrograph_path}"
        )
    return matched[0]


def EPU_xml_2_beamshift(xml_file) -> tuple:
    """(beamshift_x, beamshift_y) from an EPU XML file (epu.py:316-335).

    Parsed with xml.etree; tags are matched on local names so the EPU
    namespace prefixes (a:_x etc.) are handled without xmltodict.
    """
    import xml.etree.ElementTree as ET

    root = ET.parse(xml_file).getroot()

    def local(tag):
        return tag.rsplit("}", 1)[-1]

    def find_path(node, names):
        if not names:
            return node
        for child in node:
            if local(child.tag) == names[0]:
                found = find_path(child, names[1:])
                if found is not None:
                    return found
        return None

    bs = find_path(root, ["microscopeData", "optics", "BeamShift"])
    if bs is None:
        raise HeliconIOError(f"{xml_file}: no BeamShift element")
    x = y = None
    for child in bs:
        if local(child.tag) == "_x":
            x = float(child.text)
        elif local(child.tag) == "_y":
            y = float(child.text)
    if x is None or y is None:
        raise HeliconIOError(f"{xml_file}: incomplete BeamShift element")
    return (x, y)
