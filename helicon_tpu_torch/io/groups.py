"""Optics/exposure group assignment utilities.

A copy of ``helicon_tpu/io/groups.py`` (host code:
numpy and pandas); tests/test_torch_metadata.py pins the copy to the original.

Reference: lib/groups.py (279 LoC).
"""

from __future__ import annotations

import logging
import re
from datetime import datetime
from pathlib import Path

import numpy as np

from ..utils.collections import all_matched_attrs, assign_to_groups
from .epu import (
    extract_data_collection_time,
    guess_data_collection_software,
    movie_filename_patterns,
)

logger = logging.getLogger(__name__)

__all__ = [
    "assign_time_groups",
    "combine_groups",
    "extract_timestamps",
    "per_micrograph_ids",
    "per_micrograph_mapping",
    "propagate_ctf_median",
    "sync_group_columns",
]


def combine_groups(existing, new) -> np.ndarray:
    """Unique sequential id per (existing, new) pair (groups.py:31-53)."""
    pairs = np.column_stack([existing, new])
    _, combined = np.unique(pairs, axis=0, return_inverse=True)
    return combined + 1


def extract_timestamps(
    micrographs, software: str, use_mtime_fallback: bool = False
) -> dict:
    """Filename -> timestamp; serial-number then mtime fallbacks
    (groups.py:54-95)."""
    pattern = movie_filename_patterns().get(software)
    result = {}
    for m in micrographs:
        ts = extract_data_collection_time(m, software=software)
        if ts is None and pattern:
            match = re.search(pattern, Path(m).name)
            if match and "serial_number" in match.groupdict():
                ts = float(match.group("serial_number"))
        if ts is None and use_mtime_fallback:
            try:
                ts = Path(m).resolve().stat().st_mtime
            except OSError:
                ts = None
        result[m] = ts if ts is not None else float("inf")
    return result


def per_micrograph_mapping(micrographs, start_id: int = 1) -> dict:
    """Micrograph -> sequential group id (groups.py:96-113)."""
    return {m: i + start_id for i, m in enumerate(micrographs)}


def per_micrograph_ids(names, start_id: int = 1) -> np.ndarray:
    """Per-particle id from unique micrograph names (groups.py:114-135)."""
    _, inverse = np.unique(np.asarray(names), return_inverse=True)
    return inverse + start_id


def propagate_ctf_median(data, group_id_name: str) -> None:
    """Median CTF per exposure group, written back (groups.py:136-157)."""
    group_ids = np.sort(np.unique(data[group_id_name]))
    ctf_cols = (
        "ctf/cs_mm ctf/phase_shift_rad ctf/shift_A ctf/tilt_A "
        "ctf/trefoil_A ctf/tetra_A ctf/anisomag"
    ).split()
    for gi in group_ids:
        mask = np.where(np.asarray(data[group_id_name]) == gi)
        for col in ctf_cols:
            if col in data:
                vals = np.array(data[col], copy=True)
                if vals.dtype == object:
                    # vector-valued CTF fields (ctf/shift_A, tilt_A,
                    # trefoil_A, tetra_A, anisomag) arrive as per-cell
                    # lists from cs2dataframe: median per component,
                    # written back cell by cell
                    med = np.median(
                        np.stack([np.asarray(v) for v in vals[mask]]),
                        axis=0,
                    )
                    for i in mask[0]:
                        vals[i] = med.tolist()
                else:
                    vals[mask] = np.median(vals[mask], axis=0)
                data[col] = vals


def sync_group_columns(data, group_id_name: str, query_str: str = "exp_group_id"):
    """Copy the primary group column into all sibling group columns
    (groups.py:158-182)."""
    names = all_matched_attrs(data, query_str=query_str)
    if len(names) > 1:
        for attr in names:
            if attr != group_id_name:
                data[attr] = data[group_id_name]


def assign_time_groups(
    micrographs,
    source_group_ids,
    group_id_lookup,
    time_group_size: int,
    verbose: int = 0,
    use_mtime_fallback=None,
):
    """Split groups into time-ordered subgroups of a target size
    (groups.py:183-279). Returns (new_group_ids, micrograph_to_time,
    micrograph_to_time_str)."""
    from ..utils.exceptions import HeliconError

    micrographs = np.asarray(micrographs)
    sample = str(micrographs[0])
    software = guess_data_collection_software(sample)
    if software is None:
        known = ", ".join(sorted(movie_filename_patterns().keys()))
        logger.warning(
            "cannot detect the data collection software: %s (known: %s)",
            sample,
            known,
        )
        raise HeliconError("cannot detect data collection software")
    use_mtime = (
        software not in ("EPU", "EPU_old")
        if use_mtime_fallback is None
        else use_mtime_fallback
    )
    unique_micrographs = list(dict.fromkeys(micrographs))
    micrograph_to_time = extract_timestamps(
        unique_micrographs, software, use_mtime_fallback=use_mtime
    )
    micrograph_to_time_str = {
        m: (
            datetime.fromtimestamp(t).strftime("%Y-%m-%d_%H-%M-%S")
            if t != float("inf")
            else "unknown"
        )
        for m, t in micrograph_to_time.items()
    }

    last_group_id = 0
    new_group_ids = np.zeros(len(group_id_lookup), dtype=int)
    for gi in source_group_ids:
        mask = np.where(np.asarray(group_id_lookup) == gi)[0]
        group_micrographs = np.unique(micrographs[mask])
        group_times = [micrograph_to_time[m] for m in group_micrographs]
        time_2_subgroup = assign_to_groups(group_times, time_group_size)
        particle_subgroups = np.array(
            [time_2_subgroup[micrograph_to_time[m]] for m in micrographs[mask]]
        )
        new_group_ids[mask] = particle_subgroups + last_group_id
        last_group_id = int(np.max(new_group_ids))
    if verbose > 1:
        logger.info(
            "%d -> %d groups", len(source_group_ids), len(np.unique(new_group_ids))
        )
    return new_group_ids, micrograph_to_time, micrograph_to_time_str
