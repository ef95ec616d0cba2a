"""Geometry analysis the denovo3d prep chain needs (the cylindrical
volume mask and the grayscale-moment helix rotation/diameter estimator)
and the 2D image scores of the denovo3d score metrics.

Counterpart of ``helicon_tpu/core/analysis.py:438`` (``_binary_closing``),
``:447`` (``estimate_helix_rotation_center_diameter``), ``:504``
(``get_cylindrical_mask``), and of the traced scores ``:241-419``
(``_uniform_filter``, ``_ssim_map``, ``_rescale_half``,
``ssim_score_traced``, ``ms_ssim_score_traced``,
``mutual_information_score_traced``). The moments and morphology are host
numpy and scipy, as in the reference; the one rotation runs through the
port's ``transform_image`` on the CPU. The scores take images (..., h, w)
whose leading axes are a batch, and return one score per image.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "estimate_helix_rotation_center_diameter",
    "get_cylindrical_mask",
    "ssim_score_traced",
    "ms_ssim_score_traced",
    "mutual_information_score_traced",
]


def _binary_closing(mask: np.ndarray) -> np.ndarray:
    """Binary closing with a 3x3 cross (edge values kept, skimage-like)."""
    from scipy import ndimage as ndi

    structure = ndi.generate_binary_structure(2, 1)
    dil = ndi.binary_dilation(mask, structure=structure)
    return ndi.binary_erosion(dil, structure=structure, border_value=1)


def estimate_helix_rotation_center_diameter(
    data, estimate_rotation: bool = True, estimate_center: bool = True, threshold: float = 0
):
    """Grayscale-moment estimate of helix rotation, y-shift, and diameter.

    Threshold + closing mask, then intensity-weighted second moments give
    the principal axis angle; the image is rotated level and the
    centroid/extent measured again. Returns (rotation_deg, shift_y,
    diameter_px).
    """
    from ..angular import set_to_periodic_range
    from .transforms import transform_image

    data = np.asarray(data, np.float32)
    ny, nx = data.shape

    def weighted_params(mask, intensity):
        ys, xs = np.where(mask)
        if len(ys) < 2:
            return 0.0, 0.0, ny
        w = intensity[ys, xs].astype(np.float64)
        w = w - w.min() + 1e-8
        cw = w.sum()
        cy = (ys * w).sum() / cw
        cx = (xs * w).sum() / cw
        uy = ys - cy
        ux = xs - cx
        i_yy = (uy * uy * w).sum() / cw
        i_xx = (ux * ux * w).sum() / cw
        i_xy = (uy * ux * w).sum() / cw
        theta = 0.5 * math.atan2(2.0 * i_xy, i_yy - i_xx)
        angle = math.degrees(theta) + 90.0
        if abs(angle) > 90.0:
            angle -= 180.0
        diameter = int(ys.max() - ys.min() + 1)
        shift = ny // 2 - cy if estimate_center else 0.0
        return angle, shift, diameter

    mask = _binary_closing(data > threshold)
    if not mask.any():
        return 0.0, 0.0, ny

    if estimate_rotation:
        rotation, _, _ = weighted_params(mask, data)
        rotation = set_to_periodic_range(rotation, min=-180, max=180)
        data_rot = transform_image(data, rotation=rotation).numpy()
    else:
        rotation = 0.0
        data_rot = data

    mask_rot = _binary_closing(data_rot > threshold)
    if not mask_rot.any():
        return rotation, 0.0, ny
    _, shift_y, diameter = weighted_params(mask_rot, data_rot)
    return rotation, shift_y, diameter


def get_cylindrical_mask(nz, ny, nx, rmin=0, rmax=-1, return_xyz: bool = False):
    """Boolean cylinder mask (axis = Z); optionally the (Z, Y, X) grids."""
    k = np.arange(nz, dtype=np.int32) - nz // 2
    j = np.arange(ny, dtype=np.int32) - ny // 2
    i = np.arange(nx, dtype=np.int32) - nx // 2
    Z, Y, X = np.meshgrid(k, j, i, indexing="ij")
    if rmax < 0:
        rmax = ny // 2 - 1
    mask = X * X + Y * Y < rmax * rmax
    if 0 < rmin < rmax:
        mask &= X * X + Y * Y >= rmin * rmin
    if return_xyz:
        return mask, (Z, Y, X)
    return mask


# ---------------------------------------------------------------------------
# image similarity scores, batched over leading axes
# ---------------------------------------------------------------------------


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of numpy's "reflect" padding (no repeated edge sample)."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _uniform_filter(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Separable box filter over the last two axes with reflect padding
    (scipy uniform_filter), as a running sum like the reference."""
    pad = size // 2
    for ax in (-2, -1):
        n = x.shape[ax]
        padded = x.index_select(ax, _reflect_index(n, pad, x.device))
        zero = torch.zeros_like(padded.narrow(ax, 0, 1))
        csum = torch.cat([zero, padded], dim=ax).cumsum(dim=ax)
        x = (csum.narrow(ax, size, n) - csum.narrow(ax, 0, n)) / size
    return x


def _ssim_map(img1, img2, data_range, win_size: int = 7):
    """SSIM map matching skimage structural_similarity defaults;
    data_range broadcasts against the images."""
    K1, K2 = 0.01, 0.03
    NP = win_size**2
    cov_norm = NP / (NP - 1)
    ux = _uniform_filter(img1, win_size)
    uy = _uniform_filter(img2, win_size)
    uxx = _uniform_filter(img1 * img1, win_size)
    uyy = _uniform_filter(img2 * img2, win_size)
    uxy = _uniform_filter(img1 * img2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    num = (2 * ux * uy + C1) * (2 * vxy + C2)
    den = (ux**2 + uy**2 + C1) * (vx + vy + C2)
    return num / den


def _ptp(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(-2, -1)) - x.amin(dim=(-2, -1))


def ssim_score_traced(img1, img2) -> torch.Tensor:
    """Mean SSIM of each image pair (win 7, uniform windows, an edge crop
    of 3); a pair whose data range is 0 scores 0, as does an image
    smaller than the window."""
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32, device=a.device)
    win = 7
    if min(a.shape[-2:]) < win:
        return torch.zeros(a.shape[:-2], device=a.device)
    dr = torch.maximum(_ptp(a), _ptp(b))
    smap = _ssim_map(a, b, dr.clamp_min(1e-30)[..., None, None], win)
    pad = (win - 1) // 2
    core = smap[..., pad:-pad, pad:-pad] if pad else smap
    return torch.where(dr > 0, core.mean(dim=(-2, -1)), 0.0)


def _rescale_half(img: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 0.5x rescale of the last two axes (gaussian sigma 0.5,
    then bilinear with mirror edges)."""
    from .filters import _gaussian_blur
    from .interp import map_coordinates

    blurred = _gaussian_blur(img, (0.5, 0.5))
    lead, (ny, nx) = blurred.shape[:-2], blurred.shape[-2:]
    flat = blurred.reshape(-1, ny, nx)
    my, mx = int(round(ny * 0.5)), int(round(nx * 0.5))
    dev = img.device
    rr = (torch.arange(my, dtype=torch.float32, device=dev) + 0.5) * 2.0 - 0.5
    cc = (torch.arange(mx, dtype=torch.float32, device=dev) + 0.5) * 2.0 - 0.5
    bi = torch.arange(flat.shape[0], dtype=torch.float32, device=dev)
    # an integral batch coordinate: its second tap has weight 0, so each
    # image is the reference's 2D bilinear resample
    B, R, C = torch.meshgrid(bi, rr, cc, indexing="ij")
    out = map_coordinates(flat, (B, R, C), order=1, mode="mirror")
    return out.reshape(*lead, my, mx)


_MS_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])


def ms_ssim_score_traced(img1, img2) -> torch.Tensor:
    """Multi-scale SSIM of each pair. The scale count is set by the image
    shape; a constant image at any scale scores that scale 0, which zeroes
    the product (the reference's traced rule)."""
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32, device=a.device)
    min_size = 8
    values = []
    for i in range(len(_MS_WEIGHTS)):
        h, w = a.shape[-2:]
        if h < min_size or w < min_size:
            break
        values.append(ssim_score_traced(a, b).clamp_min(0.0))
        if i < len(_MS_WEIGHTS) - 1:
            a = _rescale_half(a)
            b = _rescale_half(b)
    if not values:
        return torch.zeros(a.shape[:-2], device=a.device)
    weights = _MS_WEIGHTS[: len(values)]
    weights = weights / weights.sum()
    result = torch.ones_like(values[0])
    for s, wgt in zip(values, weights):
        result = result * s ** float(np.float32(wgt))
    return result


def _histogram_bins(v: torch.Tensor, bins: int) -> torch.Tensor:
    """1-based bin of each sample of each row of v (B, n), as
    jnp.histogramdd finds it: edges a float32 linspace(min, max, bins + 1)
    (min - 0.5, max + 0.5 for a constant row), searchsorted right, a
    sample on the last edge in the last bin. 0 and bins + 1 are outside."""
    lo, hi = v.amin(dim=1), v.amax(dim=1)
    flat = hi - lo == 0
    lo = torch.where(flat, lo - 0.5, lo)
    hi = torch.where(flat, hi + 0.5, hi)
    step = torch.arange(bins, dtype=torch.float32, device=v.device) / np.float32(bins)
    inner = lo[:, None] * (1 - step) + hi[:, None] * step
    edges = torch.cat([inner, hi[:, None]], dim=1).contiguous()
    idx = torch.searchsorted(edges, v.contiguous(), right=True)
    return torch.where(v == edges[:, -1:], idx - 1, idx)


def mutual_information_score_traced(img1, img2, bins: int = 64) -> torch.Tensor:
    """Normalized mutual information minus 1 of each pair, from a float32
    joint histogram of bins x bins (the reference's traced version)."""
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32, device=a.device)
    lead = a.shape[:-2]
    a = a.reshape(-1, a.shape[-2] * a.shape[-1])
    b = b.expand(*lead, *b.shape[-2:]).reshape(a.shape)
    bx, by = _histogram_bins(a, bins), _histogram_bins(b, bins)
    ok = (bx >= 1) & (bx <= bins) & (by >= 1) & (by <= bins)
    cell = ((bx - 1).clamp(0, bins - 1) * bins + (by - 1).clamp(0, bins - 1))
    hist = torch.zeros((a.shape[0], bins * bins), dtype=torch.float32, device=a.device)
    hist.scatter_add_(1, cell, ok.to(torch.float32))
    pxy = hist / hist.sum(dim=1, keepdim=True).clamp_min(1e-30)
    pxy = pxy.reshape(-1, bins, bins)
    px, py = pxy.sum(dim=2), pxy.sum(dim=1)

    def H(p):
        return -torch.where(p > 0, p * torch.log(p.clamp_min(1e-30)), 0.0).sum(dim=-1)

    hxy = H(pxy.reshape(-1, bins * bins))
    nmi = (H(px) + H(py)) / hxy.clamp_min(1e-30)
    return torch.where(hxy > 0, nmi - 1.0, 0.0).reshape(lead)
