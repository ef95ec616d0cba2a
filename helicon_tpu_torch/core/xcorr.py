"""Batched FFT cross-correlation of class averages against segments.

Counterpart of ``helicon_tpu/core/xcorr.py``: ``cross_correlation_map``
:22 and ``batched_cross_correlation`` :66 / :92, the peak normalized
cross-correlation of every (class, segment) pair and its integer shift,
on ``torch.fft`` (the real transforms: the reference's matmul DFT is
TPU-only). The segment axis runs in chunks whose largest tensor stays
within a budget taken from the device's free memory.
"""

from __future__ import annotations

import torch

from ..utils.tensors import on_device

__all__ = ["batched_cross_correlation", "cross_correlation_map"]

CPU_BUDGET_BYTES = 2**29  # the reference's 2^27 float32 elements a live tensor
# on a card, a live tensor takes at most free memory / 16: a chunk holds
# ~5 such (the products, cuFFT's copy of them, the maps, their max)
FREE_FRACTION = 16


def cross_correlation_map(image_a, image_b, *, device="cuda") -> torch.Tensor:
    """Normalized circular cross-correlation map of two same-size images
    (float32, on image_a's device)."""
    a = on_device(image_a, device)
    b = torch.as_tensor(image_b, dtype=torch.float32, device=a.device)
    a = a - a.mean()
    b = b - b.mean()
    cc = torch.fft.ifftn(torch.fft.fft2(a) * torch.conj(torch.fft.fft2(b)), dim=(-2, -1)).real
    return cc / torch.clamp_min(torch.linalg.norm(a) * torch.linalg.norm(b), 1e-12)


def segment_chunk(C: int, S: int, ny: int, nx: int, device) -> int:
    """Segments a chunk: the (C, chunk, ny, nx) float32 correlation maps,
    the size of a chunk's largest tensors, within free memory /
    FREE_FRACTION on a card (CPU_BUDGET_BYTES on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // FREE_FRACTION
    else:
        budget = CPU_BUDGET_BYTES
    return max(1, min(S, budget // max(1, C * ny * nx * 4)))


def batched_cross_correlation(classes, segments, chunk: int | None = None, device="cuda"):
    """Peak normalized cross-correlation of every (class, segment) pair.

    classes (C, ny, nx), segments (S, ny, nx) -> (C, S) float32 peak CCC
    and (C, S, 2) int64 peak shifts (dy, dx): the shift to apply to the
    segment to align it with the class, wrapped into (-n/2, n/2]. On the
    classes' device (``device`` for arrays). A tie takes the first peak in
    row-major order. ``chunk`` segments a pass (default: segment_chunk).
    """
    cl = on_device(classes, device)
    sg = on_device(segments, cl.device)
    C, ny, nx = cl.shape
    S = sg.shape[0]
    Fc, norm_c = _spectra(cl)
    Fs, norm_s = _spectra(sg)
    Fs = torch.conj(Fs)
    del cl, sg
    if chunk is None:
        chunk = segment_chunk(C, S, ny, nx, Fc.device)
    peak = torch.empty((C, S), dtype=torch.float32, device=Fc.device)
    idx = torch.empty((C, S), dtype=torch.int64, device=Fc.device)
    for s0 in range(0, S, chunk):
        cc = _correlate(Fc, Fs[s0 : s0 + chunk], (ny, nx))
        peak[:, s0 : s0 + chunk], idx[:, s0 : s0 + chunk] = _peaks(cc)
        del cc
    peak = peak / torch.clamp_min(norm_c[:, None] * norm_s[None, :], 1e-12)
    return peak, _wrapped_shifts(idx, ny, nx)


def _spectra(images):
    """The rfft2 of each mean-subtracted image and its norm."""
    images = images - images.mean(dim=(-2, -1), keepdim=True)
    return torch.fft.rfft2(images), torch.linalg.norm(images.flatten(1), dim=1)


def _correlate(Fc, Fs_conj, shape) -> torch.Tensor:
    """The (C, chunk, ny, nx) circular correlation maps of the classes'
    spectra against a chunk of conjugated segment spectra."""
    return torch.fft.irfft2(Fc[:, None] * Fs_conj[None], s=shape)


def _peaks(cc):
    """Each map's maximum and its first flat index."""
    return cc.flatten(-2).max(dim=-1)


def _wrapped_shifts(idx, ny: int, nx: int) -> torch.Tensor:
    sy = torch.div(idx, nx, rounding_mode="floor")
    sx = idx % nx
    sy = torch.where(sy > ny // 2, sy - ny, sy)
    sx = torch.where(sx > nx // 2, sx - nx, sx)
    return torch.stack([sy, sx], dim=-1)
