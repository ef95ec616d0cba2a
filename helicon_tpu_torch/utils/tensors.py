"""Placing an entry point's inputs: a tensor keeps its device, anything
else goes to the device the caller names (the card by default)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["on_device"]


def on_device(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor (its own dtype where ``dtype`` is None):
    on its own device if it is a tensor, else on ``device`` (which raises
    where that device does not exist)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
