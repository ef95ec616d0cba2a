"""Filesystem / URL path helpers.

A copy of ``helicon_tpu/utils/path_utils.py`` (host code:
numpy and pandas); tests/test_torch_metadata.py pins the copy to the original.

Parity: reference lib/path_utils.py:27-447.
Network functions degrade gracefully when there is no egress.
"""

from __future__ import annotations

import logging
import os
import re
import time
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = [
    "which",
    "find_relion_project_folders",
    "get_direct_url",
    "get_file_size",
    "download_file_from_url",
    "get_emdb_id",
    "is_file_readable",
    "is_file_writable",
    "file_ready",
    "convert_file_path",
    "convert_dataframe_file_path",
    "check_required_columns",
]


def which(program: str, use_current_dir: int = 0) -> str | None:
    """Locate an executable on PATH (optionally checking ``.`` first)."""
    if os.sep in program:
        p = Path(program).resolve()
        if p.exists() and os.access(p, os.X_OK):
            return str(p)
        return None
    path = os.environ.get("PATH", "")
    if use_current_dir:
        path = f".:{path}"
    for d in path.split(":"):
        p = Path(d) / program
        if p.exists() and os.access(p, os.X_OK):
            return str(p.resolve())
    return None


def find_relion_project_folders(
    start_folder=None, target_filename: str = "default_pipeline.star", verbose: int = 0
) -> list[Path]:
    """Walk *start_folder* looking for RELION projects (pruned at match)."""
    root = Path(start_folder) if start_folder else Path.home()
    if not root.is_dir():
        root = Path.home()
    if verbose:
        logger.info("Searching %s ...", root)
    found = []
    for dirpath, dirnames, filenames in os.walk(root):
        if target_filename in filenames:
            found.append(Path(dirpath))
            dirnames.clear()
            if verbose:
                logger.info("%d: %s", len(found), found[-1])
    return found


def get_direct_url(url: str) -> str:
    """Rewrite a cloud-drive share URL to a direct-download URL."""
    if url.startswith("https://drive.google.com/file/d/"):
        file_id = url.split("/")[5]
        return f"https://drive.google.com/uc?export=download&id={file_id}"
    if url.startswith("https://app.box.com/s/"):
        return f"https://app.box.com/shared/static/{url.rsplit('/', 1)[-1]}"
    if url.startswith("https://www.dropbox.com"):
        if "dl=1" in url:
            return url
        if "dl=0" in url:
            return url.replace("dl=0", "dl=1")
        return url + "?dl=1"
    if "sharepoint.com" in url and "guestaccess.aspx" in url:
        return url.replace("guestaccess.aspx", "download.aspx")
    if url.startswith("https://1drv.ms"):
        import base64

        token = (
            base64.b64encode(url.encode())
            .decode()
            .replace("/", "_")
            .replace("+", "-")
            .rstrip("=")
        )
        return f"https://api.onedrive.com/v1.0/shares/u!{token}/root/content"
    return url


def get_file_size(url: str) -> int | None:
    """Remote file size via HEAD request, or None."""
    try:
        import urllib.request

        req = urllib.request.Request(url, method="HEAD")
        with urllib.request.urlopen(req, timeout=30) as resp:
            size = resp.headers.get("Content-Length")
            return int(size) if size is not None else None
    except Exception:
        return None


def download_file_from_url(
    url: str, target_file_name: str | None = None, return_filename: bool = False
):
    """Download *url* to a file (or open a local path directly)."""
    import tempfile
    import urllib.request

    if Path(url).is_file():
        return open(url, "rb")
    try:
        if target_file_name:
            fileobj = open(target_file_name, "wb")
        else:
            suffix = "." + url.rsplit("/", 1)[-1]
            # delete=False when only the NAME is returned: the reference
            # returns fileobj.name from a delete-on-close tempfile, whose
            # last reference dies at return — the caller's path points at
            # an already-deleted file (latent reference bug, fixed here)
            fileobj = tempfile.NamedTemporaryFile(
                suffix=suffix, delete=not return_filename
            )
        with urllib.request.urlopen(url, timeout=300) as resp:
            fileobj.write(resp.read())
        fileobj.flush()
        return fileobj.name if return_filename else fileobj
    except Exception as e:
        logger.error("Failed to download %s: %s", url, e)
        raise IOError(f"ERROR: failed to download {url}") from e


def get_emdb_id(label: str) -> str | None:
    """Extract an EMDB identifier like ``EMD-14046`` from a string."""
    m = re.search(r"(?i)(EMD[-_]\d{4,5})", str(label))
    return m.group(1) if m else None


def is_file_readable(filename) -> bool:
    p = Path(filename)
    return p.is_file() and os.access(p, os.R_OK)


def is_file_writable(filename) -> bool:
    p = Path(filename)
    if p.exists():
        return p.is_file() and os.access(p, os.W_OK)
    parent = p.parent if str(p.parent) else Path(".")
    return os.access(parent, os.W_OK)


def file_ready(filenames, wait: int = 0, minSize: int = 0) -> int:
    """1 when file(s) exist and have content, polling up to *wait* seconds."""
    if isinstance(filenames, list):
        return int(
            all(Path(f).exists() and Path(f).stat().st_size for f in filenames)
        )
    p = Path(filenames)
    if p.exists() and p.stat().st_size > minSize:
        return 1
    if wait > 0:
        deadline = time.time() + wait
        delay = 1.0
        while time.time() <= deadline:
            time.sleep(delay)
            if file_ready(filenames, wait=0, minSize=minSize):
                return 1
            delay = min(delay * 2, max(0.0, deadline - time.time()))
            if delay <= 0:
                break
        return file_ready(filenames, wait=0, minSize=minSize)
    return 0


def convert_file_path(filenames, to: str = "current", relpath_start: str = "."):
    """Convert a pandas Series of paths to absolute/relative/shortest form."""
    import pandas as pd

    if to == "current":
        return filenames
    assert to in {"current", "absolute", "abs", "real", "relative", "rel", "shortest"}
    assert isinstance(filenames, pd.Series)
    mapping = {}
    for name in filenames.unique():
        p_abs = Path(name).resolve()
        if to in ("real", "absolute", "abs"):
            name2 = p_abs.as_posix()
        else:
            rel = os.path.relpath(p_abs, relpath_start)
            if to in ("relative", "rel"):
                name2 = rel
            else:
                name2 = p_abs.as_posix() if len(p_abs.as_posix()) < len(rel) else rel
        if not (Path(name2).exists() or (Path(relpath_start) / name2).exists()):
            name2 = name
        mapping[name] = name2
    return filenames.map(mapping)


def convert_dataframe_file_path(df, attr: str, to: str = "current", relpath_start="."):
    """Like convert_file_path but preserves ``index@filename`` stack prefixes."""
    if to == "current":
        return df[attr]
    if "@" in str(df[attr].iloc[0]):
        parts = df[attr].str.split("@", expand=True)
        indices, names = parts.iloc[:, 0], parts.iloc[:, 1]
        return indices + "@" + convert_file_path(names, to, relpath_start)
    return convert_file_path(df[attr], to, relpath_start)


def check_required_columns(data, required_cols: list | None = None) -> None:
    """Raise ValueError when required columns are missing."""
    cols = list(data.columns) if hasattr(data, "columns") else list(data.keys())
    missing = [c for c in (required_cols or []) if c not in cols]
    if missing:
        msg = (
            f"required columns {' '.join(missing)} are unavailable. "
            f"Available columns are {' '.join(map(str, cols))}"
        )
        logger.error(msg)
        raise ValueError(msg)
