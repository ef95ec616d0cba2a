"""Content-addressed on-disk result cache with expiry.

Expensive pure functions (EMDB downloads, a class map's projection sheet)
are memoised to disk with a validity window through joblib, which is
optional: without it, or with no writable directory, the decorator passes
the function through.

A copy of ``setup_cache_dir``, ``cache``, ``DummyMemory`` and
``clear_cache`` from ``helicon_tpu/utils/cache.py``; the JAX compilation
cache stays behind. One difference: ``/fast-scratch/<user>`` is a
candidate only where ``/fast-scratch`` already exists, so that the port
never makes a directory at the file system's root.
tests/test_torch_whereismyclass.py pins the copy to the original.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import tempfile
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["setup_cache_dir", "cache", "clear_cache", "DummyMemory"]


def setup_cache_dir() -> Path:
    """Resolve the cache directory.

    Priority: ``$HELICON_CACHE_DIR`` -> /fast-scratch/<user>/helicon (where
    /fast-scratch exists) -> ~/.cache/helicon -> a temp dir. The first
    writable candidate wins.
    """
    candidates = []
    if "HELICON_CACHE_DIR" in os.environ:
        candidates.append(Path(os.environ["HELICON_CACHE_DIR"]))
    user = os.environ.get("USER", "user")
    if Path("/fast-scratch").is_dir():
        candidates.append(Path("/fast-scratch") / user / "helicon")
    candidates.append(Path.home() / ".cache" / "helicon")
    for cand in candidates:
        try:
            cand.mkdir(parents=True, exist_ok=True)
            probe = cand / ".write_probe"
            probe.touch()
            probe.unlink()
            return cand
        except OSError:
            continue
    return Path(tempfile.mkdtemp(prefix="helicon_cache_"))


class _ExpiringMemory:
    """joblib.Memory wrapper that invalidates entries older than N days."""

    def __init__(self, cache_dir, expires_after: float | None, verbose: int = 0):
        import joblib

        self.memory = joblib.Memory(location=str(cache_dir), verbose=verbose)
        self.expires_after = expires_after

    def cache(self, func, ignore=None):
        memorized = self.memory.cache(func, ignore=ignore or [])
        expires_after = self.expires_after

        if expires_after is None or expires_after <= 0:
            return memorized

        cutoff = datetime.timedelta(days=expires_after)

        def validate(metadata) -> bool:
            try:
                import time

                mtime = metadata.get("time", None)
                if mtime is None:
                    return True
                return (time.time() - mtime) < cutoff.total_seconds()
            except Exception:
                return True

        memorized.cache_validation_callback = validate
        return memorized


class DummyMemory:
    """No-op stand-in when the cache dir is unwritable."""

    def cache(self, func, ignore=None):
        return func


def cache(cache_dir=None, ignore=None, expires_after: float | None = None, verbose=0):
    """Decorator: disk-memoise a pure function with optional expiry (days).

    ``ignore`` lists argument names excluded from the cache key (e.g.
    ``verbose``, ``device``).
    """

    def decorator(func):
        try:
            d = Path(cache_dir) if cache_dir is not None else setup_cache_dir()
            d.mkdir(parents=True, exist_ok=True)
            mem = _ExpiringMemory(d, expires_after, verbose=verbose)
        except (OSError, ImportError):
            # unwritable cache dir or no joblib: pass the function through
            mem = DummyMemory()
        cached_func = mem.cache(func, ignore=ignore)
        if cached_func is not func:  # update_wrapper(func, func) would
            # set a self-referential __wrapped__ that breaks inspect
            functools.update_wrapper(cached_func, func)
        return cached_func

    return decorator


def clear_cache(cache_dir=None) -> None:
    """Delete everything under the cache directory."""
    import shutil

    d = Path(cache_dir) if cache_dir is not None else setup_cache_dir()
    if d.exists():
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True, exist_ok=True)
