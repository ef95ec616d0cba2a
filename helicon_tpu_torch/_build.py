"""Build and load the port's CUDA kernels.

The sources under ``denovo3d/csrc/`` are compiled at first use with
``nvcc`` into a shared library with a plain C interface, which is loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
library lands in ``build/helicon_tpu_torch_kernels/`` beside the package,
named by a hash of its sources and flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_kernels", "BUILD_DIR", "SOURCES"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "helicon_tpu_torch_kernels"
SOURCES = (_PKG / "denovo3d" / "csrc" / "group_solve.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every C entry of group_solve.cu (all return int)
_SIGNATURES = {
    "hts_gemm_xat": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "hts_glue_data": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "hts_glue_sym": [_P] * 7 + [_I] * 8 + [_P],
    "hts_gemm_ga": [_P, _P, _P] + [_I] * 7 + [_P],
    "hts_reduce_mask": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "hts_cg_init": [_P] * 5 + [_I, _I, _P],
    "hts_cg_step": [_P] * 5 + [_I, _I, _P],
    "hts_normalize": [_P, _P, _I, _I, _P],
    "hts_rayleigh": [_P, _P, _P, _F, _I, _I, _P],
    "hts_fista_init": [_P] * 4 + [_I, _I, _P],
    "hts_fista_step": [_P] * 7 + [_F, _I, _I, _P],
    "hts_apply_mask": [_P, _P, _I, _I, _P],
    "hts_score": [_P] * 6 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return path


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built from SOURCES on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES:
            h.update(src.read_bytes())
        out = BUILD_DIR / f"libhelicon_tpu_torch_{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
