"""CryoSPARC .cs dataset files (no cryosparc-tools dependency).

A copy of ``helicon_tpu/io/cs.py`` (host code:
numpy and pandas); tests/test_torch_metadata.py pins the copy to the original.

A .cs file is a numpy structured array; cryoSPARC v2/v3 wrote plain .npy
(magic \\x93NUMPY), which is also what the reference test fixtures use
(reference repo test.cs.npy; lib/io.py cs2dataframe loads via
cryosparc-tools Dataset). The newer CSDAT streaming container is parsed
natively by io/csdat.py (framing + LZ4 block codec) — no cryosparc-tools
needed for either format, unlike the reference (lib/io.py:518-547).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["read_cs", "write_cs", "find_passthrough_file"]

_NUMPY_MAGIC = b"\x93NUMPY"
_CSDAT_MAGIC = b"\x94CSDAT"


def read_cs(path) -> np.ndarray:
    """Load a .cs structured array.

    ``np.load`` is the load seam (reference compute.py:229 does
    ``np.load(cs_file)`` and its tests patch ``numpy.load``); the magic
    bytes are sniffed only on failure, to turn an opaque numpy error
    into the CSDAT-container diagnosis.
    """
    try:
        out = np.load(path, allow_pickle=False)
    except Exception as exc:
        try:
            with open(path, "rb") as f:
                magic = f.read(6)
        except OSError:
            raise exc
        if magic == _CSDAT_MAGIC:
            # CryoSPARC v4+ streaming container: parse natively (the
            # reference needs cryosparc-tools for this; we do not —
            # io/csdat.py implements the framing + LZ4 block codec)
            from .csdat import read_csdat

            return read_csdat(path)
        if magic != _NUMPY_MAGIC:
            raise ValueError(
                f"{path}: not a recognized .cs file (magic {magic!r})"
            ) from None
        raise
    if not isinstance(out, np.ndarray):
        # np.load also accepts zip archives (.npz) and returns a
        # lazily-opened NpzFile; a .cs must be a single structured
        # array, so reject rather than hand back a wrong-typed object
        # with an open file handle.
        if hasattr(out, "close"):
            out.close()
        raise ValueError(
            f"{path}: not a recognized .cs file (zip/.npz archive, "
            "expected a single structured .npy array)"
        )
    return out


def find_passthrough_file(cs_path, prefer=("particles", "exposures")):
    """Auto-discover the passthrough .cs next to a CryoSPARC output.

    Shared by `helicon cryosparc` and `helicon symmetry_mismatch` (the
    two drivers used to carry divergent near-copies of this logic).
    Preference order: a passthrough sharing the input's job prefix
    (J9_particles.cs -> J9_passthrough_*.cs), trying `prefer` kinds in
    order. A candidate from a DIFFERENT job is returned only with
    warn=True — merging another job's passthrough by uid yields
    NaN/stale metadata, so callers must log it and offer an override.

    Returns (path_or_None, warn: bool).
    """
    p = Path(cs_path)
    job = p.stem.split("_")[0]
    cands: list[Path] = []
    for kind in prefer:
        kind_cands = sorted(p.parent.glob(f"*_passthrough_{kind}.cs"))
        same_job = [c for c in kind_cands if c.name.startswith(job + "_")]
        if same_job:
            # unambiguous: same job, preferred kind (warn only if this
            # kind somehow has several same-job files)
            return same_job[0], len(same_job) > 1
        cands.extend(kind_cands)
    if cands:
        return cands[0], True
    return None, False


def write_cs(path, data: np.ndarray):
    """Save a structured array as a .cs (npy-format) file."""
    data = np.asarray(data)
    if data.dtype.names is None:
        raise ValueError(".cs files must contain structured (record) arrays")
    with open(path, "wb") as f:
        np.save(f, data, allow_pickle=False)
