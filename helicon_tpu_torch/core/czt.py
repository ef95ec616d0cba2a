"""Chirp-Z transform (Bluestein) on ``torch.fft``.

Counterpart of ``helicon_tpu/core/czt.py`` (its FFT path; the TPU's
matmul-DFT fallback is not ported). ``czt(x, m, f0, df, axis)`` computes,
along ``axis``::

    X[k] = sum_n x[n] * exp(-2*pi*i * (f0 + k*df) * n),   k = 0..m-1

with ``f0``/``df`` in cycles/sample, as three FFTs of length
``next_fast_len(n + m - 1)``. The chirps are computed in float64 numpy,
as the reference computes them, and applied in complex64 (complex128 in
``zoom_fft_2d``) on the device of the tensor given (numpy input on the
keyword ``device``, the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensors import on_device

__all__ = ["czt", "zoom_fft_2d", "zoom_fft_3d"]


def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth number >= n (good FFT length)."""
    if n <= 2:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            need = -(-n // p35)
            p2 = 1 << max(0, (need - 1).bit_length())
            best = min(best, p35 * p2)
            p35 *= 3
        p5 *= 5
    return best


def _along(vec: np.ndarray, ndim: int, axis: int, device, dtype) -> torch.Tensor:
    """A 1D factor of ``dtype`` shaped to broadcast along ``axis``."""
    shape = [1] * ndim
    shape[axis] = -1
    return torch.as_tensor(vec, device=device).to(dtype).reshape(shape)


def czt(x: torch.Tensor, m: int, f0: float, df: float, axis: int = -1,
        dtype=torch.complex64, *, device="cuda") -> torch.Tensor:
    """Chirp-Z transform along one axis at frequencies ``f0 + k*df``,
    computed in ``dtype`` (complex64: the chirps rounded to it first, as
    the reference's)."""
    x = on_device(x, device, None)
    axis = axis % x.ndim
    n = x.shape[axis]
    L = _next_fast_len(n + m - 1)
    k_all = np.arange(max(n, m), dtype=np.float64)
    # W^(k^2/2) with W = exp(-2*pi*i*df), the exponent reduced mod 1
    w_exp = 0.5 * df * k_all * k_all
    a_exp = f0 * k_all[:n]
    chirp = np.exp(-2j * np.pi * np.mod(w_exp, 1.0))
    a_fac = np.exp(-2j * np.pi * np.mod(a_exp, 1.0))
    npdt = np.complex64 if dtype == torch.complex64 else np.complex128
    pre = (a_fac * chirp[:n]).astype(npdt)
    post = chirp[:m].astype(npdt)
    # the convolution kernel: conj chirp at offsets -(n-1)..(m-1), wrapped
    idx = np.arange(L, dtype=np.float64)
    offs = np.where(idx < m, idx, idx - L)
    v = np.exp(2j * np.pi * np.mod(0.5 * df * offs * offs, 1.0)).astype(npdt)
    valid = (idx < m) | (idx >= L - (n - 1)) if n > 1 else (idx < m)
    v = np.where(valid, v, 0).astype(npdt)

    xw = x.to(dtype) * _along(pre, x.ndim, axis, x.device, dtype)
    Xf = torch.fft.fft(xw, n=L, dim=axis)
    del xw
    y = torch.fft.ifft(Xf * _along(np.fft.fft(v), x.ndim, axis, x.device, dtype), dim=axis)
    del Xf
    y = y.narrow(axis, 0, m)
    return y * _along(post, x.ndim, axis, x.device, dtype)


def zoom_fft_2d(data, out_shape, zoom, *, device="cuda") -> torch.Tensor:
    """The 2D DFT on zoomed fftfreq-ordered frequency grids: along each axis
    ``fftfreq(m) * zoom`` cycles per input sample. Leading axes are a
    batch. Each chirp-Z runs along the contiguous last axis (the image
    transposed for the first), so an image of a batch gets the bits of
    its own call: a batched FFT along a strided axis may not. Both run in
    complex128, the result complex64: in complex64 the chirp-Z's rounding
    is up to 4.6e-5 of the largest coefficient with cuFFT at 384^2 and
    1.1e-5 on the CPU, and a power spectrum's log scale shows it."""
    my, mx = out_shape
    zy, zx = zoom
    dfy, dfx = zy / my, zx / mx
    c128 = torch.complex128
    y = czt(on_device(data, device, None).transpose(-2, -1).contiguous(), my, -(my // 2) * dfy, dfy,
            axis=-1, dtype=c128)
    y = czt(y.transpose(-2, -1).contiguous(), mx, -(mx // 2) * dfx, dfx, axis=-1, dtype=c128)
    return torch.fft.ifftshift(y, dim=(-2, -1)).to(torch.complex64)


def zoom_fft_3d(data, out_shape, zoom, *, device="cuda") -> torch.Tensor:
    """3D analog of :func:`zoom_fft_2d`."""
    data = on_device(data, device, None)
    mz, my, mx = out_shape
    zz, zy, zx = zoom
    y = czt(data, mz, -(mz // 2) * (zz / mz), zz / mz, axis=-3)
    y = czt(y, my, -(my // 2) * (zy / my), zy / my, axis=-2)
    y = czt(y, mx, -(mx // 2) * (zx / mx), zx / mx, axis=-1)
    return torch.fft.ifftshift(y, dim=(-3, -2, -1))
