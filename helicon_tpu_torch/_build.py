"""Build and load the port's CUDA kernels.

The sources under ``denovo3d/csrc/`` are compiled at first use, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, which is loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The library lands in
``build/helicon_tpu_torch_kernels/`` beside the package, named by a hash
of its sources and flags, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["load_kernels", "Launcher", "BUILD_DIR", "SOURCES"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "helicon_tpu_torch_kernels"
SOURCES = (
    _PKG / "denovo3d" / "csrc" / "group_solve.cu",
    _PKG / "denovo3d" / "csrc" / "candidate_solve.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every C entry (all return int): group_solve.cu's
# hts_*, then candidate_solve.cu's hcs_*
_SIGNATURES = {
    "hts_gemm_xat": [_P] * 4 + [_I] * 10 + [_P],
    "hts_glue_data": [_P] * 3 + [_I] * 9 + [_P],
    "hts_glue_sym": [_P] * 7 + [_I] * 9 + [_P],
    "hts_gemm_ga": [_P] * 3 + [_I] * 9 + [_P],
    "hts_reduce_mask": [_P] * 5 + [_I] * 5 + [_P],
    "hts_cg_init": [_P] * 5 + [_I, _I, _P],
    "hts_cg_step": [_P] * 5 + [_I, _I, _P],
    "hts_normalize": [_P, _P, _I, _I, _P],
    "hts_rayleigh": [_P, _P, _P, _F, _I, _I, _P],
    "hts_fista_init": [_P] * 4 + [_I, _I, _P],
    "hts_fista_step": [_P] * 8 + [_F, _I, _I, _P],
    "hts_apply_mask": [_P, _P, _I, _I, _P],
    "hts_score": [_P] * 6 + [_I] * 8 + [_P],
    "hcs_sym_fold": [_P] * 4 + [_I] * 8 + [_P],
    "hcs_reduce_l2_mask": [_P] * 5 + [_I] * 3 + [_P],
    "hcs_seed_ones": [_P, _I, _I, _P],
    "hcs_fista_init": [_P] * 3 + [_I, _I, _P],
    "hcs_fista_step": [_P] * 6 + [_F, _I, _I, _P],
    "hcs_pack_cols": [_P, _P] + [_I] * 5 + [_P],
    "hcs_build_w2": [_P] * 5 + [_I] * 4 + [_F] * 3 + [_I] * 3 + [_P],
    "hcs_build_mxy": [_P] * 4 + [_I] * 6 + [_P],
    "hcs_score": [_P] * 5 + [_I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return path


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed:\n{proc.stdout}\n{proc.stderr}")


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
            tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
            objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
            procs = [
                subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
                for src, obj in zip(SOURCES, objs)
            ]
            outs = [proc.communicate() for proc in procs]  # wait for every build
            for src, proc, (so, se) in zip(SOURCES, procs, outs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src.name}:\n{so}\n{se}")
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            _run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)])
            for obj in objs:
                obj.unlink()
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


class Launcher:
    """Calls the library's C entries by name on the current stream of
    ``device``: tensors go as pointers, None as a null pointer. Each C
    entry returns cudaGetLastError; ``count`` is given the number of
    kernels each call launched, and a refused launch raises."""

    def __init__(self, device: torch.device, count):
        self.lib = load_kernels()
        self.stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        self.count = count

    def __call__(self, name: str, *args, kernels: int = 1) -> None:
        conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
                else ctypes.c_void_p(None) if a is None else a for a in args]
        err = getattr(self.lib, name)(*conv, self.stream)
        self.count(kernels)
        if err != 0:
            raise RuntimeError(f"{name} failed to launch: CUDA error {err}")
