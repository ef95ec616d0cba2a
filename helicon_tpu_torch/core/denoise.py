"""Image denoisers on tensors: TV-Chambolle, the Haar wavelet soft
threshold and non-local means.

Counterpart of ``helicon_tpu/core/denoise.py``: ``denoise_tv_chambolle``
:27, ``denoise_wavelet`` :79 / :90, ``denoise_nl_means`` :131 and
``denoise_image`` :180. Each runs on the device of the image it is given
and returns a float32 tensor there.
"""

from __future__ import annotations

import logging
import math

import torch

__all__ = ["denoise_image", "denoise_nl_means", "denoise_tv_chambolle", "denoise_wavelet"]

logger = logging.getLogger(__name__)


def denoise_tv_chambolle(image, weight: float = 0.1, n_iter: int = 50) -> torch.Tensor:
    """Chambolle 2004 dual projection algorithm (as skimage's default)."""
    img = torch.as_tensor(image, dtype=torch.float32)
    tau = 0.25

    def grad(u):
        gx = torch.diff(u, dim=0, append=u[-1:, :])
        gy = torch.diff(u, dim=1, append=u[:, -1:])
        return gx, gy

    def div(px, py):
        fx = px - torch.roll(px, 1, dims=0)
        fx[0] = px[0]
        fx[-1] = -px[-2]
        fy = py - torch.roll(py, 1, dims=1)
        fy[:, 0] = py[:, 0]
        fy[:, -1] = -py[:, -2]
        return fx + fy

    px, py = torch.zeros_like(img), torch.zeros_like(img)
    for _ in range(n_iter):
        u = img - weight * div(px, py)
        gx, gy = grad(u)
        denom = 1.0 + (tau / weight) * torch.sqrt(gx * gx + gy * gy)
        # the dual ascent p <- (p - (tau/lambda) grad u) / (1 + (tau/lambda)|grad u|)
        px = (px - (tau / weight) * gx) / denom
        py = (py - (tau / weight) * gy) / denom
    return img - weight * div(px, py)


_SQRT2 = math.sqrt(2.0)


def _haar_fwd(x):
    return (x[0::2] + x[1::2]) / _SQRT2, (x[0::2] - x[1::2]) / _SQRT2


def _haar_inv(a, d):
    e, o = (a + d) / _SQRT2, (a - d) / _SQRT2
    return torch.stack([e, o], dim=1).reshape(-1, *a.shape[1:])


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the mean of the two middle values of an
    even count (numpy's; torch.median returns the lower one)."""
    s = torch.sort(v.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def denoise_wavelet(image, sigma: float | None = None, levels: int = 3) -> torch.Tensor:
    """Haar-wavelet VisuShrink soft threshold (the universal threshold,
    noise sigma from the finest diagonal detail's MAD unless given). The
    depth is capped so both dimensions keep at least one block; rows and
    columns beyond a multiple of 2^levels pass through unchanged."""
    img = torch.as_tensor(image, dtype=torch.float32)
    ny, nx = img.shape
    levels = min(levels, max(1, int(math.floor(math.log2(max(2, min(ny, nx))))) - 1))
    py, px = ny - ny % 2**levels, nx - nx % 2**levels
    work = img[:py, :px]

    d = (work[0::2, 0::2] - work[1::2, 0::2] - work[0::2, 1::2] + work[1::2, 1::2]) / 2
    s = _median(torch.abs(d - _median(d))) / 0.6745 if sigma is None else float(sigma)
    thresh = s * math.sqrt(2.0 * math.log(max(py * px, 2)))

    def soft(v):
        return torch.sign(v) * torch.clamp_min(torch.abs(v) - thresh, 0.0)

    def fwd2(u):
        a, dv = _haar_fwd(u)
        aa, ad = _haar_fwd(a.T)
        da, dd = _haar_fwd(dv.T)
        return aa.T, ad.T, da.T, dd.T

    def inv2(aa, ad, da, dd):
        return _haar_inv(_haar_inv(aa.T, ad.T).T, _haar_inv(da.T, dd.T).T)

    stack, u = [], work
    for _ in range(levels):
        aa, ad, da, dd = fwd2(u)
        stack.append((soft(ad), soft(da), soft(dd)))
        u = aa
    for ad, da, dd in reversed(stack):
        u = inv2(u, ad, da, dd)
    if (py, px) == (ny, nx):
        return u
    out = img.clone()
    out[:py, :px] = u
    return out


def _reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's "reflect" padding of a 2D tensor by pad on every side (no
    repeated edge sample; pads wider than the image reflect again)."""
    from .interp import _mirror_index

    rows = _mirror_index(torch.arange(-pad, img.shape[0] + pad, device=img.device), img.shape[0])
    cols = _mirror_index(torch.arange(-pad, img.shape[1] + pad, device=img.device), img.shape[1])
    return img[rows][:, cols]


def denoise_nl_means(image, h: float = 0.1, patch_size: int = 7,
                     search_radius: int = 11) -> torch.Tensor:
    """Non-local means with a square search window, skimage's defaults as
    the reference pipeline calls it (patch 7, distance 11, absolute h 0.1).
    One pass per shift of the window: the patch distance is a box sum
    (cumulative sums) of the squared difference of shifted images."""
    img = torch.as_tensor(image, dtype=torch.float32)
    p, k = patch_size // 2, patch_size

    def boxsum(x):
        c = torch.cumsum(torch.nn.functional.pad(x, (0, 0, 1, 0)), dim=0)
        x = c[k:] - c[:-k]
        c = torch.cumsum(torch.nn.functional.pad(x, (1, 0)), dim=1)
        return c[:, k:] - c[:, :-k]

    pad = p + search_radius
    padded = _reflect_pad(img, pad)
    ny, nx = img.shape
    centre = padded[pad - p : pad + ny + p, pad - p : pad + nx + p]
    num, den = torch.zeros_like(img), torch.zeros_like(img)
    h2 = max(h * h, 1e-12)
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            shifted = padded[pad + dy : pad + dy + ny, pad + dx : pad + dx + nx]
            diff2 = (padded[pad + dy - p : pad + dy + ny + p, pad + dx - p : pad + dx + nx + p]
                     - centre) ** 2
            w = torch.exp(-(boxsum(diff2) / (k * k)) / h2)
            num = num + w * shifted
            den = den + w
    return num / torch.clamp_min(den, 1e-12)


def denoise_image(image, method: str = "tv", **kwargs) -> torch.Tensor:
    """Dispatch by method name: nl_mean (or nl_means), tv, wavelet; an
    unknown name warns and returns the image unchanged."""
    if method in ("nl_mean", "nl_means"):
        return denoise_nl_means(image, **kwargs)
    if method == "tv":
        return denoise_tv_chambolle(image, **kwargs)
    if method == "wavelet":
        return denoise_wavelet(image, **kwargs)
    logger.warning("unknown denoise method %r; returning the image unchanged", method)
    return torch.as_tensor(image, dtype=torch.float32)
