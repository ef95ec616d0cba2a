"""System and configuration utilities: the option ordering and the colon
parameter mini-language of the option pipelines (proc3d, images2star), the
resource probes, the image encoders, OpenMP thread control and small
helpers.

A copy of ``helicon_tpu/utils/system.py`` (host code); the JAX probes
have torch counterparts (``available_devices`` counts the CUDA cards,
``has_curvelet_udct_gpu`` asks whether there is one). The reference's
monkeypatch seams ``compat_namespace`` / ``compat_hook`` answer to the
JAX package's ``helicon`` drop-in package, which the port has no
counterpart of, so they stay behind. tests/test_torch_proc3d.py,
tests/test_torch_metadata.py and tests/test_torch_namespace.py pin the
copy to the original.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "get_context_function_name",
    "import_with_auto_install",
    "omp_get_max_threads",
    "omp_set_num_threads",
    "get_option_list",
    "parse_param_str",
    "validate_param_dict",
    "available_cpu",
    "available_devices",
    "has_shiny",
    "has_streamlit",
    "has_curvelet_fdct",
    "has_curvelet_udct",
    "has_curvelet_udct_gpu",
    "get_terminal_size",
    "bytes2units",
    "ceil_power_of_10",
    "encode_numpy",
    "encode_PIL_Image",
]


def get_option_list(argv: list[str]) -> list[str]:
    """Return ``--option`` names in the order they appear on the command line.

    The CLI option order IS the execution plan of the proc3d pipeline, so
    ordering must be preserved exactly.
    """
    names = []
    for token in argv:
        if token.startswith("--"):
            names.append(token.split("=", 1)[0].lstrip("-"))
    return names


def resolve_option_abbreviations(options, known):
    """Map argparse-abbreviated option names back to their full names.

    argparse (allow_abbrev=True) accepts e.g. ``--fft`` for
    ``--fft_resample`` and stores the value under the full dest, but
    get_option_list() reads the literal argv token: dispatching the
    abbreviation mid-pipeline would fail with 'Unknown option' after the
    input data has been loaded. Unique prefixes resolve up front;
    ambiguous or unknown names are returned unchanged for the caller's
    own validation to reject early.
    """
    known = list(known)
    resolved = []
    for name in options:
        if name in known:
            resolved.append(name)
            continue
        matches = [k for k in known if k.startswith(name)]
        resolved.append(matches[0] if len(matches) == 1 else name)
    return resolved


def _coerce_value(v: str) -> Any:
    if v.lower() == "true":
        return 1
    if v.lower() == "false":
        return 0
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if len(v) > 2 and v[0] == '"' and v[-1] == '"':
        return v[1:-1]
    return v


def parse_param_str(param_str: str) -> tuple[str | None, dict[str, Any]]:
    """Parse ``[name:]k1=v1:k2=v2`` into ``(name, {k1: v1, k2: v2})``.

    Values are coerced: true/false -> 1/0, then int, then float, then a
    quoted string has its quotes stripped; otherwise kept verbatim. A
    segment without ``=`` is the name if it comes first, otherwise it is
    ignored with an error log.
    """
    name = None
    d: dict[str, Any] = {}
    for pi, seg in enumerate(param_str.split(":")):
        if "=" in seg:
            k, _, v = seg.partition("=")
            d[k] = _coerce_value(v)
        elif pi == 0:
            name = seg
        else:
            logger.error("failed to parse parameter %s. Ignored", seg)
    return name, d


def validate_param_dict(
    param: dict[str, Any], param_ref: dict[str, Any]
) -> tuple[dict[str, Any], dict[str, Any], dict[str, Any]]:
    """Coerce *param* against the typed defaults in *param_ref*.

    Returns ``(final, changed, unsupported)`` where *final* has every key of
    *param_ref* (user value coerced to the default's type, else the default),
    *changed* holds the keys whose final value differs from the default, and
    *unsupported* holds user keys absent from *param_ref*.
    """
    unsupported = {k: v for k, v in param.items() if k not in param_ref}
    final = {
        k: (type(ref)(param[k]) if k in param else ref)
        for k, ref in param_ref.items()
    }
    changed = {k: v for k, v in final.items() if v != param_ref[k]}
    return final, changed, unsupported


def optional_loader(module_name: str, attr: str):
    """Import an optional IO package (``mrcfile`` / ``starfile``) only if
    it provides the needed callable: the module, or None to select the
    native codec (the module is absent, or a bare placeholder without the
    entry point)."""
    import importlib

    try:
        mod = importlib.import_module(module_name)
    except ImportError:
        return None
    return mod if callable(getattr(mod, attr, None)) else None


def ceil_power_of_10(n: float | int) -> int:
    """Smallest power of 10 that is >= n (with 10 as the floor)."""
    import math

    if n < 0:
        raise ValueError(f"n={n} while n>0 is required")
    if n <= 1:
        return 10
    return 10 ** math.ceil(math.log10(n))


def available_cpu(mem_gb_per_cpu: float | None = None) -> int:
    """Number of usable host CPUs (SLURM-aware, load-aware, memory-capped)."""
    if "SLURM_CPUS_ON_NODE" in os.environ:
        cpu = int(os.environ["SLURM_CPUS_ON_NODE"])
    else:
        try:
            import psutil

            cpu = max(1, int(psutil.cpu_count() * (1 - psutil.cpu_percent() / 100)))
        except ImportError:
            cpu = os.cpu_count() or 1
    if mem_gb_per_cpu is not None:
        try:
            import psutil

            mem = psutil.virtual_memory()
            cpu = max(1, min(cpu, int(mem.available / 1024**3 / mem_gb_per_cpu)))
        except ImportError:
            pass
    return cpu


def available_devices() -> int:
    """Number of CUDA cards visible to this process."""
    import torch

    return torch.cuda.device_count()


def has_shiny() -> bool:
    try:
        import shiny  # noqa: F401

        return True
    except ImportError:
        return False


def has_streamlit() -> bool:
    try:
        import streamlit  # noqa: F401

        return True
    except ImportError:
        return False


def has_curvelet_fdct() -> bool:
    """True: the fdct entry points are served by the port's own transform
    (curvelet_denoise_fdct aliases the tight-frame UDCT path)."""
    return True


def has_curvelet_udct() -> bool:
    """The port's UDCT curvelets are always available."""
    return True


def has_curvelet_udct_gpu() -> bool:
    """The curvelets run on a CUDA card when there is one."""
    import torch

    return torch.cuda.is_available()


def get_terminal_size() -> tuple[int, int]:
    size = shutil.get_terminal_size()
    return (size.lines, size.columns)


def bytes2units(
    nbytes: float | int, to: str | None = None, bsize: int = 1024
) -> tuple[float, str]:
    """Convert a byte count to ``(value, unit)`` like ``(1.5, "GB")``."""
    order = ["k", "m", "g", "t", "p", "e"]
    labels = {"k": "kB", "m": "MB", "g": "GB", "t": "TB", "p": "PB", "e": "EB"}
    if to is not None:
        u = to
        x = nbytes / (bsize ** (order.index(to) + 1))
    else:
        u = order[-1]
        x = nbytes
        for cand in order:
            x = nbytes / (bsize ** (order.index(cand) + 1))
            if x < bsize:
                u = cand
                break
    return (x, labels[u])


def encode_numpy(img: np.ndarray, hflip: bool = False, vflip: bool = False) -> str:
    """Encode an array as a base64 JPEG data URL (normalized to uint8)."""
    if img.dtype != np.uint8:
        vmin, vmax = float(img.min()), float(img.max())
        if vmax > vmin:
            img = (255 * (img - vmin) / (vmax - vmin)).astype(np.uint8)
        else:
            img = np.zeros_like(img, dtype=np.uint8)
    if hflip:
        img = img[:, ::-1]
    if vflip:
        img = img[::-1, :]
    from PIL import Image

    return encode_PIL_Image(Image.fromarray(img))


def encode_PIL_Image(img, hflip: bool = False, vflip: bool = False) -> str:
    import base64
    import io

    from PIL import ImageOps

    if hflip:
        img = ImageOps.mirror(img)
    if vflip:
        img = ImageOps.flip(img)
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return f"data:image/jpeg;base64, {base64.b64encode(buf.getvalue()).decode()}"


# ---------------------------------------------------------------------------
# OpenMP thread control (reference system.py:248-321) + misc helpers
# ---------------------------------------------------------------------------

_omp_lib = None


def _load_omp_library():
    """ctypes handle to a loaded OpenMP runtime, if any."""
    import ctypes.util

    for name in ("gomp", "omp", "iomp5"):
        path = ctypes.util.find_library(name)
        if path:
            try:
                import ctypes

                return ctypes.CDLL(path)
            except OSError:
                continue
    return None


def omp_get_max_threads() -> int:
    """OpenMP max threads (reference system.py:284-298); 1 if no runtime."""
    global _omp_lib
    if _omp_lib is None:
        _omp_lib = _load_omp_library()
    if _omp_lib is None:
        return 1
    return int(_omp_lib.omp_get_max_threads())


def omp_set_num_threads(n: int) -> None:
    """Set OpenMP threads (reference system.py:300-321); no-op without a
    runtime."""
    global _omp_lib
    if _omp_lib is None:
        _omp_lib = _load_omp_library()
    if _omp_lib is not None:
        _omp_lib.omp_set_num_threads(int(n))


def get_context_function_name(level: int = 1) -> str:
    """Name of the calling function (reference system.py helper)."""
    import inspect

    # currentframe() is this helper's frame: level=1 means one f_back
    # hop, the function that called us (reference: inspect.stack()[1])
    frame = inspect.currentframe()
    for _ in range(level):
        if frame is None:
            return ""
        frame = frame.f_back
    return frame.f_code.co_name if frame else ""


def import_with_auto_install(package: str, pip_name: str | None = None):
    """Import a package; the reference pip-installs on failure, here a clear
    ImportError is raised instead."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f"package {package!r} is not available in this environment "
            f"(install {pip_name or package!r})"
        ) from e
