"""Geometry analysis the denovo3d prep chain needs (the cylindrical
volume mask and the grayscale-moment helix rotation/diameter estimator),
the 2D image scores (batched, and the float ones), the Fourier shell and
ring correlations, and the small helpers: ``is_3d``, ``twist2pitch``,
the correlations, the elbow and the line fit.

Counterpart of ``helicon_tpu/core/analysis.py:438`` (``_binary_closing``),
``:447`` (``estimate_helix_rotation_center_diameter``), ``:504``
(``get_cylindrical_mask``), of the traced scores ``:241-419``
(``_uniform_filter``, ``_ssim_map``, ``_rescale_half``,
``ssim_score_traced``, ``ms_ssim_score_traced``,
``mutual_information_score_traced``), and of the FSC / FRC family
``:97-240`` (the shells binned on the spectra's device in float64), and
of ``is_3d`` :56, ``twist2pitch`` :73, ``ssim_score`` :275,
``ms_ssim_score`` :309, ``mutual_information_score`` :339,
``r_factor_score`` :422, ``cross_correlation_coefficient`` :520,
``cosine_similarity`` :530, ``find_elbow_point`` :538,
``line_fit_projection`` :551, and copies of the host (pandas) tube
metadata functions ``estimate_inter_segment_distance`` :586,
``reset_inter_segment_distance`` :614 and ``estimate_helicalTube_length``
:692. The
moments and morphology are host numpy and scipy, as in the reference; the
one rotation runs through the port's ``transform_image`` on the CPU. The
scores take images (..., h, w) whose leading axes are a batch, and return
one score per image.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

__all__ = [
    "calc_fsc",
    "calc_fsc_from_fft",
    "calc_fsc_per_shell",
    "calc_frc_2d",
    "frc_score",
    "estimate_helix_rotation_center_diameter",
    "estimate_helicalTube_length",
    "estimate_inter_segment_distance",
    "get_cylindrical_mask",
    "ssim_score_traced",
    "ms_ssim_score_traced",
    "mutual_information_score_traced",
    "cosine_similarity",
    "cross_correlation_coefficient",
    "find_elbow_point",
    "is_3d",
    "line_fit_projection",
    "ms_ssim_score",
    "mutual_information_score",
    "r_factor_score",
    "reset_inter_segment_distance",
    "ssim_score",
    "twist2pitch",
]

logger = logging.getLogger(__name__)


def is_3d(data) -> bool:
    """True for cubic or z-elongated rectangular 3D volumes."""
    if data.ndim != 3:
        return False
    nz, ny, nx = data.shape
    return (nz == ny == nx) or (nz > ny and ny == nx)


def twist2pitch(twist: float, rise: float,
                return_pitch_for_4p75Angstrom_rise: bool = True) -> float:
    """Helical pitch from twist / rise, by default re-expressed at the
    multiple of the rise between 4.5 and 5 A (the amyloid rise) whose
    accumulated twist stays under 90 degrees."""
    from ..angular import set_angle_range

    if not return_pitch_for_4p75Angstrom_rise:
        return rise * 360 / abs(twist)
    rise_star = abs(rise)
    twist_star = abs(twist)
    for n in range(10, 1, -1):
        cond = (rise * n < 5) and (4.5 < rise * n)
        tmp_twist = abs(set_angle_range(twist_star * n, range=(-180, 180)))
        cond = cond and (tmp_twist < 90)
        if cond:
            twist_star = tmp_twist
            rise_star = rise_star * n
            break
    return rise_star * 360 / twist_star


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
# FSC / FRC
# ---------------------------------------------------------------------------


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true division on every device (CUDA divides by a host
    scalar as a multiplication by its reciprocal; numpy and XLA do not)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def _fftfreq64(n: int, device, half: bool = False) -> torch.Tensor:
    """numpy's fftfreq(n) (rfftfreq(n) if half) in float64 on device: the
    integer frequencies times 1.0 / n, as numpy forms them."""
    if half:
        k = torch.arange(n // 2 + 1, device=device)
    else:
        k = torch.arange(n, device=device)
        k = torch.where(k < (n - 1) // 2 + 1, k, k - n)
    return k.to(torch.float64) * (1.0 / n)


def _shell_labels(sizes, scale: int, top: int, device, half: bool) -> torch.Tensor:
    """int32 shell index round(|k| * scale), clipped to [0, top], of every
    coefficient of an fftn grid of sizes (rfftn over the last axis if
    half), in float64 as the reference forms it on the host."""
    r2 = None
    for ax, n in enumerate(sizes):
        f = _fftfreq64(n, device, half=half and ax == len(sizes) - 1)
        shape = [1] * len(sizes)
        shape[ax] = -1
        f2 = (f * f).reshape(shape)
        r2 = f2 if r2 is None else r2 + f2
    shell = torch.round(torch.sqrt(r2) * scale).to(torch.int32)
    return shell.clamp_(0, top)


def _shell_labels_3d(n: int, device=None) -> torch.Tensor:
    """The shells of an (n, n, n // 2 + 1) rfftn grid (int32, on device)."""
    return _shell_labels((n, n, n), n, n // 2, device, half=True)


def _binned_fsc(F1, F2, labels, nshells: int) -> np.ndarray:
    """Per-shell correlation of two spectra, binned on their device in
    float64 (the reference's host bincount is float64 too: float32 sums
    over ~1e7 coefficients spanning many orders move FSC values near
    0.143). Only the three nshells-long sums cross to the host."""
    labels = torch.as_tensor(labels, device=F1.device).reshape(-1)
    p, q = F1.reshape(-1), F2.reshape(-1)
    pr, pi = p.real.to(torch.float64), p.imag.to(torch.float64)
    qr, qi = q.real.to(torch.float64), q.imag.to(torch.float64)
    sums = torch.zeros((3, nshells), dtype=torch.float64, device=F1.device)
    sums[0].index_add_(0, labels, pr * qr + pi * qi)
    sums[1].index_add_(0, labels, pr * pr + pi * pi)
    sums[2].index_add_(0, labels, qr * qr + qi * qi)
    num, d1, d2 = sums.cpu().numpy()
    denom = np.sqrt(d1 * d2)
    return np.where(denom > 0, num / np.where(denom > 0, denom, 1.0), 1.0)


def calc_fsc(map1, map2, apix, F1=None, F2=None, shell_flat=None, n=None) -> np.ndarray:
    """FSC between two 3D maps (or their rfftn spectra F1, F2): columns
    (spatial frequency 1/A, fsc), on the maps' device."""
    if n is None:
        n = map1.shape[0] if F1 is None else F1.shape[0]
    df = 1.0 / (apix * n)
    F1 = torch.fft.rfftn(torch.as_tensor(map1).to(torch.float32)) if F1 is None \
        else torch.as_tensor(F1)
    F2 = torch.fft.rfftn(torch.as_tensor(map2).to(torch.float32)) if F2 is None \
        else torch.as_tensor(F2, device=F1.device)
    if shell_flat is None:
        labels = _shell_labels_3d(n, F1.device)
    else:
        labels = torch.as_tensor(shell_flat, device=F1.device).reshape((n, n, n // 2 + 1))
    fsc = _binned_fsc(F1, F2, labels, n // 2 + 1)
    qx_max = np.fft.rfftfreq(n).max()
    saxis = np.arange(n // 2 + 1) * df
    idx = saxis <= qx_max
    return np.vstack((saxis[idx], fsc[idx])).T


def calc_fsc_from_fft(F1, F2, n, apix) -> np.ndarray:
    """FSC from precomputed rfftn spectra."""
    return calc_fsc(None, None, apix, F1=F1, F2=F2, n=n)


def calc_fsc_per_shell(map1, map2, apix) -> np.ndarray:
    """EMAN2-style per-shell FSC over the full (fftn) grid; index = shell."""
    map1 = torch.as_tensor(map1)
    n = map1.shape[0]
    F1 = torch.fft.fftn(map1.to(torch.float32))
    F2 = torch.fft.fftn(torch.as_tensor(map2, device=map1.device).to(torch.float32))
    labels = _shell_labels((n, n, n), n, n // 2, map1.device, half=False)
    return _binned_fsc(F1, F2, labels, n // 2 + 1)


def calc_frc_2d(img1, img2, apix):
    """2D Fourier ring correlation: (spatial frequencies 1/A, frc curve)."""
    if img1.shape != img2.shape:
        raise ValueError(f"Image shapes must match: {img1.shape} vs {img2.shape}")
    img1 = torch.as_tensor(img1)
    h, w = img1.shape
    n_shells = min(h, w) // 2
    F1 = torch.fft.fft2(img1.to(torch.float32))
    F2 = torch.fft.fft2(torch.as_tensor(img2, device=img1.device).to(torch.float32))
    shell = _shell_labels((h, w), n_shells, n_shells, img1.device, half=False)
    fsc = _binned_fsc(F1, F2, shell, n_shells + 1)
    saxis = np.arange(n_shells + 1) / (min(h, w) * apix)
    return saxis, fsc


def _fit_frc_curve(saxis, fsc):
    """Fit a Fermi or Butterworth falloff to an FRC curve (host-side)."""
    from scipy.optimize import minimize

    mask = np.isfinite(fsc) & (fsc >= -0.1) & (fsc <= 1.1)
    s_fit, f_fit = saxis[mask], fsc[mask]
    if len(s_fit) < 3:
        return saxis, fsc

    def fermi(mu, T, x):
        return 1.0 / (np.exp((x - mu) / T) + 1.0)

    def score_fermi(p):
        mu, T = p
        if T <= 0:
            return 1e10
        a = 1.0 / fermi(mu, T, 0.0)
        return np.mean(np.abs(f_fit - a * fermi(mu, T, s_fit)))

    def score_bw(p):
        omega, order = p
        if omega <= 0 or order <= 0:
            return 1e10
        return np.mean(np.abs(f_fit - 1.0 / (1.0 + (s_fit / omega) ** order)))

    x0 = s_fit[len(s_fit) // 2]
    best_err, best = np.inf, (s_fit.copy(), f_fit.copy())
    rf = minimize(score_fermi, x0=[x0, 0.01], method="Nelder-Mead",
                  options={"maxiter": 1000, "xatol": 1e-6})
    if rf.fun < best_err:
        best_err = rf.fun
        mu, T = rf.x
        a = 1.0 / fermi(mu, T, 0.0)
        s_fine = np.linspace(saxis[1], saxis[-1], 500)
        best = (s_fine, np.clip(a * fermi(mu, T, s_fine), -1, 1))
    rb = minimize(score_bw, x0=[x0, 2.0], method="Nelder-Mead",
                  options={"maxiter": 1000, "xatol": 1e-6})
    if rb.fun < best_err:
        omega, order = rb.x
        s_fine = np.linspace(saxis[1], saxis[-1], 500)
        best = (s_fine, np.clip(1.0 / (1.0 + (s_fine / omega) ** order), -1, 1))
    return best


def frc_score(img1, img2, apix, use_fit: bool = False) -> float:
    """Scalar similarity from the FRC curve (mean or fitted-area)."""
    saxis, fsc = calc_frc_2d(img1, img2, apix)
    if use_fit:
        s_fine, f_fine = _fit_frc_curve(saxis, fsc)
        valid = np.isfinite(f_fine) & (f_fine >= -1) & (f_fine <= 1)
        if valid.sum() == 0:
            return 0.0
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        area = trapezoid(f_fine[valid], s_fine[valid])
        span = s_fine[valid][-1] - s_fine[valid][0]
        return float(area / span) if span > 0 else 0.0
    valid = np.isfinite(fsc) & (fsc >= -1) & (fsc <= 1)
    return float(np.mean(fsc[valid])) if valid.sum() else 0.0


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


# ---------------------------------------------------------------------------
# the float scores of one image pair, and the small helpers
# ---------------------------------------------------------------------------


def _pair(img1, img2, what: str = "Image shapes"):
    if tuple(img1.shape) != tuple(img2.shape):
        raise ValueError(f"{what} must match: {tuple(img1.shape)} vs {tuple(img2.shape)}")
    a = torch.as_tensor(img1).to(torch.float32)
    return a, torch.as_tensor(img2, device=a.device).to(torch.float32)


def ssim_score(img1, img2) -> float:
    """Mean SSIM of one pair (win 7, uniform windows, an edge crop of 3);
    0 for a data range of 0 or an image smaller than the window."""
    a, b = _pair(img1, img2)
    data_range = max(float(a.max() - a.min()), float(b.max() - b.min()))
    win = 7
    if data_range == 0 or min(a.shape) < win:
        return 0.0
    smap = _ssim_map(a, b, data_range, win)
    pad = (win - 1) // 2
    return float(smap[pad:-pad, pad:-pad].mean())


def ms_ssim_score(img1, img2) -> float:
    """Multi-scale SSIM of one pair: per-scale SSIM (clipped at 0) combined
    with the standard weights; the scales stop at an image under 8 pixels
    or a data range of 0."""
    a, b = _pair(img1, img2)
    values = []
    for i in range(len(_MS_WEIGHTS)):
        h, w = a.shape
        if h < 8 or w < 8:
            break
        if max(float(a.max() - a.min()), float(b.max() - b.min())) == 0:
            break
        values.append(max(ssim_score(a, b), 0.0))
        if i < len(_MS_WEIGHTS) - 1:
            a, b = _rescale_half(a), _rescale_half(b)
    if not values:
        return 0.0
    weights = _MS_WEIGHTS[: len(values)]
    weights = weights / weights.sum()
    result = 1.0
    for s, w in zip(values, weights):
        result *= s**w
    return float(result)


def mutual_information_score(img1, img2, bins: int = 64) -> float:
    """Normalized mutual information (Studholme 1999) minus 1, from a
    float64 joint histogram of bins x bins on the host (as the
    reference's numpy histogram2d)."""
    a, b = _pair(img1, img2)
    a = a.cpu().numpy().astype(np.float64).ravel()
    b = b.cpu().numpy().astype(np.float64).ravel()
    hist, _, _ = np.histogram2d(a, b, bins=bins)
    pxy = hist / hist.sum()

    def H(p):
        p = p[p > 0]
        return -np.sum(p * np.log(p))

    hxy = H(pxy.ravel())
    if hxy == 0:
        return 0.0
    return float((H(pxy.sum(axis=1)) + H(pxy.sum(axis=0))) / hxy - 1.0)


def r_factor_score(img1, img2) -> float:
    """1 / (1 + R), R = sum |a - b| / sum |b| (crystallographic)."""
    a, b = _pair(img1, img2, "Shapes")
    denom = float(torch.abs(b).sum())
    if denom == 0:
        return 0.0
    return float(1.0 / (1.0 + float(torch.abs(a - b).sum()) / denom))


def cross_correlation_coefficient(a, b) -> float:
    """Pearson correlation of two arrays (0 for a constant one)."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b, device=a.device).to(torch.float32)
    da, db = a - a.mean(), b - b.mean()
    norm = torch.sqrt((da * da).sum() * (db * db).sum())
    return float(torch.where(norm == 0, 0.0, (da * db).sum() / torch.where(norm == 0, 1.0, norm)))


def cosine_similarity(a, b) -> float:
    """Cosine similarity of two vectors (0 when either is zero)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    norm = torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)
    return float(torch.where(norm == 0, 0.0, (a * b).sum() / torch.where(norm == 0, 1.0, norm)))


def find_elbow_point(curve) -> int:
    """Index of the point farthest from the first-to-last chord (the knee),
    in float64 on the curve's device."""
    curve = torch.as_tensor(curve).to(torch.float64)
    n = curve.shape[0]
    pts = torch.stack([torch.arange(n, dtype=torch.float64, device=curve.device), curve], dim=1)
    vec = pts[-1] - pts[0]
    vec = vec / torch.linalg.vector_norm(vec)
    rel = pts - pts[0]
    perp = rel - torch.outer(rel @ vec, vec)
    return int(torch.argmax(torch.linalg.vector_norm(perp, dim=1)))


def line_fit_projection(x, y, w=None, ref_i: int = 0, return_xy_fit: bool = False):
    """Signed positions of points projected onto their total-least-squares
    line (the principal axis of the weighted covariance, the reference's
    orthogonal regression), from point ref_i, in float64 on x's device.
    With return_xy_fit also the (n, 2) projected points."""
    x = torch.as_tensor(x).to(torch.float64)
    y = torch.as_tensor(y, device=x.device).to(torch.float64)
    weights = (torch.ones_like(x) if w is None
               else torch.as_tensor(w, device=x.device).to(torch.float64))
    wsum = weights.sum()
    cx, cy = (x * weights).sum() / wsum, (y * weights).sum() / wsum
    dx, dy = x - cx, y - cy
    sxx = float((weights * dx * dx).sum())
    syy = float((weights * dy * dy).sum())
    sxy = float((weights * dx * dy).sum())
    theta = 0.5 * math.atan2(2 * sxy, sxx - syy)
    c, s = math.cos(theta), math.sin(theta)
    t = dx * c + dy * s
    x2, y2 = cx + t * c, cy + t * s
    v0 = torch.stack([x2[-1] - x2[0], y2[-1] - y2[0]])
    v0 = v0 / torch.linalg.vector_norm(v0)
    pos = (x2 - x2[ref_i]) * v0[0] + (y2 - y2[ref_i]) * v0[1]
    if return_xy_fit:
        return pos, torch.stack([x2, y2], dim=1)
    return pos


def _line_fit_projection_host(x, y, w=None, ref_i: int = 0, return_xy_fit: bool = False):
    """line_fit_projection in numpy float64 on the host: a copy of the
    original's, which the tube metadata functions below call (so their
    coordinates equal the original's bit for bit)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    weights = np.ones_like(x) if w is None else np.asarray(w, np.float64)
    wsum = weights.sum()
    cx = (x * weights).sum() / wsum
    cy = (y * weights).sum() / wsum
    dx, dy = x - cx, y - cy
    sxx = (weights * dx * dx).sum()
    syy = (weights * dy * dy).sum()
    sxy = (weights * dx * dy).sum()
    theta = 0.5 * math.atan2(2 * sxy, sxx - syy)
    v = np.array([math.cos(theta), math.sin(theta)])
    t = dx * v[0] + dy * v[1]
    x2 = cx + t * v[0]
    y2 = cy + t * v[1]
    v0 = np.array([x2[-1] - x2[0], y2[-1] - y2[0]])
    v0 = v0 / np.linalg.norm(v0)
    pos = (x2 - x2[ref_i]) * v0[0] + (y2 - y2[ref_i]) * v0[1]
    if return_xy_fit:
        return pos, np.vstack((x2, y2)).T
    return pos


# ---------------------------------------------------------------------------
# helical-tube metadata ops (pandas host-side)
# ---------------------------------------------------------------------------


def estimate_inter_segment_distance(data):
    """(median, mean, std, n_max) of inter-segment distances per tube."""
    for attr in ("rlnImageName", "rlnHelicalTubeID", "rlnHelicalTrackLengthAngst"):
        if attr not in data:
            return None, None, None, None
    df = data.copy()
    parts = df["rlnImageName"].str.split("@", expand=True)
    df["pid"] = parts.iloc[:, 0].astype(int)
    df["micrograph"] = parts.iloc[:, 1]
    df = df.sort_values(["micrograph", "pid"]).reset_index(drop=True)

    dists_all, lengths = [], []
    for _, particles in df.groupby(["micrograph", "rlnHelicalTubeID"], sort=False):
        track = particles["rlnHelicalTrackLengthAngst"].astype(np.float32).values
        lengths.append(track.max())
        if len(particles) < 2:
            continue
        srt = np.sort(track)
        dists_all.append(srt[1:] - srt[:-1])
    if not dists_all:
        return None, None, None, None
    dists_all = np.hstack(dists_all)
    med = np.median(dists_all)
    n_max = int(np.sum(np.round(np.array(lengths) / med) + 1))
    return med, float(np.mean(dists_all)), float(np.std(dists_all)), n_max


def reset_inter_segment_distance(
    data, new_inter_segment_distance, apix_micrograph,
    current_inter_segment_distance=-1, verbose: int = 0,
):
    """Resample segment picks along each fitted filament line so segments
    are *new_inter_segment_distance* apart (reference analysis.py:969-1075)."""
    import pandas as pd

    if (
        current_inter_segment_distance > 0
        and new_inter_segment_distance == current_inter_segment_distance
    ):
        return data
    for attr in ("rlnHelicalTubeID", "rlnCoordinateX", "rlnCoordinateY"):
        if attr not in data:
            return None
    if "rlnImageName" not in data:
        return None
    parts = data["rlnImageName"].str.split("@", expand=True)
    data = data.copy()
    data["risd_pid"] = parts.iloc[:, 0].astype(int)
    data["risd_filename"] = parts.iloc[:, 1]
    filename = "rlnMicrographName" if "rlnMicrographName" in data else "risd_filename"

    if current_inter_segment_distance <= 0:
        current_inter_segment_distance = estimate_inter_segment_distance(data)[0]
    if new_inter_segment_distance == current_inter_segment_distance:
        return data.drop(columns=["risd_filename", "risd_pid"])

    cdist = current_inter_segment_distance / apix_micrograph
    ndist = new_inter_segment_distance / apix_micrograph

    chunks = []
    for _, particles in data.groupby([filename, "rlnHelicalTubeID"], sort=False):
        if len(particles) < 2:
            chunks.append(particles.reset_index(drop=True))
            continue
        srt = particles.sort_values("risd_pid").reset_index(drop=True)
        x = srt["rlnCoordinateX"].astype(float).values
        y = srt["rlnCoordinateY"].astype(float).values
        pos, xy_fit = _line_fit_projection_host(x, y, ref_i=0, return_xy_fit=True)
        n0 = len(pos)
        unit = (xy_fit[-1] - xy_fit[0]) / (pos[-1] - pos[0])
        right = np.arange(pos[0], pos[-1] + cdist / 2 + 0.1, ndist)
        left = np.arange(pos[0] - ndist, pos[0] - cdist / 2, -ndist)
        pos_new = np.hstack((np.sort(left), right)) if len(left) else right
        n = len(pos_new)
        xy_new = xy_fit[0] + pos_new.reshape((n, 1)) * unit
        if n <= n0:
            chunk = srt.iloc[:n].reset_index(drop=True)
        else:
            chunk = srt.iloc[:n0].reset_index(drop=True)
            repeats = chunk.iloc[[len(chunk) - 1] * (n - n0)]
            chunk = pd.concat([chunk, repeats], ignore_index=True)
        chunk.loc[:, "rlnCoordinateX"] = xy_new[:, 0]
        chunk.loc[:, "rlnCoordinateY"] = xy_new[:, 1]
        if "rlnHelicalTrackLengthAngst" in chunk:
            chunk.loc[:, "rlnHelicalTrackLengthAngst"] = (
                pos_new - pos_new[0]
            ) * apix_micrograph
        chunks.append(chunk)

    # pandas 3 propagates attrs through concat and compares them with
    # `==`, which raises on DataFrame-valued attrs (the optics table);
    # strip before concat and restore after.
    attrs = dict(data.attrs)
    for c in chunks:
        c.attrs = {}
    out = pd.concat(chunks).drop(columns=["risd_filename", "risd_pid"])
    out.attrs.update(attrs)
    return out


def estimate_helicalTube_length(data, inter_segment_distance=-1, verbose: int = 0):
    """Add ``rlnHelicalTubeLength`` (Å) per filament to the dataframe."""
    for attr in ("rlnHelicalTubeID", "rlnCoordinateX", "rlnCoordinateY"):
        if attr not in data:
            return None
    if "rlnImageName" not in data:
        return None
    parts = data["rlnImageName"].str.split("@", expand=True)
    data = data.copy()
    data["ehl_pid"] = parts.iloc[:, 0].astype(int)
    data["ehl_filename"] = parts.iloc[:, 1]
    filename = "rlnMicrographName" if "rlnMicrographName" in data else "ehl_filename"

    if inter_segment_distance is not None and inter_segment_distance <= 0:
        inter_segment_distance = estimate_inter_segment_distance(data)[0]
    # (the reference crashes here when the distance is inestimable —
    # rlnHelicalTrackLengthAngst absent, reference analysis.py:1116-1130;
    # fall back to the coordinate path length instead)
    apix = None
    if inter_segment_distance is None:
        from ..io.metadata import getPixelSize

        apix = getPixelSize(data)
        if apix is None:
            logger.warning(
                "no rlnHelicalTrackLengthAngst and no pixel size: "
                "rlnHelicalTubeLength will be in PIXELS, not Angstrom"
            )
            apix = 1.0

    for _, particles in data.groupby([filename, "rlnHelicalTubeID"], sort=False):
        if "rlnHelicalTrackLengthAngst" in particles:
            length = round(particles["rlnHelicalTrackLengthAngst"].max(), 1)
        elif inter_segment_distance is not None:
            pids = particles["ehl_pid"].astype(int).values
            length = round((pids.max() - pids.min() + 1) * inter_segment_distance, 1)
        else:
            srt = particles.sort_values("ehl_pid")
            dx = np.diff(srt["rlnCoordinateX"].astype(float).values)
            dy = np.diff(srt["rlnCoordinateY"].astype(float).values)
            length = round(float(np.hypot(dx, dy).sum()) * apix, 1)
        data.loc[particles.index, "rlnHelicalTubeLength"] = length

    return data.drop(columns=["ehl_filename", "ehl_pid"])
