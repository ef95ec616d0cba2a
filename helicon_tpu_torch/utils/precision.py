"""Float32 precision of the port's products."""

from __future__ import annotations

import functools

import torch

__all__ = ["tf32_off"]


def tf32_off(fn):
    """Run fn with every float32 product in full float32 (the reference's
    "highest" precision, ROADMAP C3), then restore the caller's TF32 flags."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        flags = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = [f.allow_tf32 for f in flags]
        for f in flags:
            f.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            for f, on in zip(flags, saved):
                f.allow_tf32 = on

    return wrapped
