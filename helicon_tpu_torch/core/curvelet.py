"""Curvelet transforms and denoising on ``torch.fft``: a tight frame of
frequency windows (Meyer radial annuli times smooth angular wedges in 2D,
times antipodal spherical caps around Fibonacci directions in 3D), hard
thresholded band by band.

Counterpart of ``helicon_tpu/core/curvelet.py``, every name of its
``__all__``: the window stacks ``_windows_2d`` :59, ``_radial_bands_3d``
:225 and ``_directional_bands_3d`` :256, the transforms :109-221, the
denoisers ``denoise_curvelet_2d`` :150, ``denoise_curvelet_3d`` :328 and
the tiled variants :361 / :475, and the reference-compatible aliases
:415-509. Each function runs on the device of the tensor it is given.

Where the two differ in form, not in result:

* the windows are built in float64 torch on the device (the reference
  builds them in numpy on the host), in two passes: the normalising root
  of the sum of squares needs every band's raw window first. The float32
  stack is cached by shape and device (37 x 131 MB at 320^3, n_dirs 6);
* the denoisers stream the bands: ifftn(F U_k), its threshold, then
  fftn and the sum with U_k, one band at a time. The reference holds the
  (K, ...) coefficient stacks whole, which at 400^3 would not fit a card;
* the medians follow ``jnp.median``: the mean of the two middle values,
  found at jnp's float32 index 0.5 * (n - 1) (above 2^24 elements that
  index rounds, as jnp's does). ``torch.median`` returns the lower one and
  ``torch.quantile`` refuses more than 2^24 elements;
* ``denoise_curvelet_2d`` also takes a stack (..., ny, nx), each image
  thresholded on its own noise level: the batch aliases run a stack in
  chunks and give what each image gives alone.

``on_band(k, coeffs, magnitude, threshold)``, where a denoiser takes it,
sees each thresholded band before its threshold: the complex coefficients
it keeps or drops, the magnitudes it compares and its threshold (one per
image in 2D).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .analysis import _div, _fftfreq64

__all__ = [
    "curvelet_bands_2d",
    "curvelet_bands_3d",
    "curvelet_transform_2d",
    "curvelet_inverse_2d",
    "denoise_curvelet_2d",
    "denoise_curvelet_3d",
    "denoise_curvelet_2d_tiled",
    "riesz_transform_2d",
]

# images of a stack denoised together: at most this many pixels a chunk
BATCH_PIXELS = 1 << 24


def _device(device) -> torch.device:
    return torch.device("cpu") if device is None else torch.device(device)


def _meyer_ramp(t: torch.Tensor) -> torch.Tensor:
    """Smooth 0->1 ramp (C^1) on [0, 1]."""
    t = t.clamp(0.0, 1.0)
    return t * t * (3 - 2 * t)


def _edges(n_scales: int) -> list:
    """The annuli's geometric edges between r = 2^-n_scales and r = 1."""
    return [2.0 ** (-(n_scales - j)) for j in range(n_scales + 1)]


def _lowpass(r: torch.Tensor, edges) -> torch.Tensor:
    return 1.0 - _meyer_ramp(_div(r - 0.5 * edges[0], 0.5 * edges[0] + 1e-12))


def _annulus(r: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return _meyer_ramp(_div(r - 0.5 * lo, 0.5 * lo)) * (1.0 - _meyer_ramp(_div(r - hi, hi)))


def _normalised(raws, nbands: int, shape, device) -> torch.Tensor:
    """The float32 stack raw_k / sqrt(sum_k raw_k^2) (1 where that root is
    at most 1e-12), from raws(), an iterator over the raw float64 windows
    in band order, walked twice: once for the norm, once for the bands."""
    norm2 = None
    for raw in raws():
        norm2 = raw * raw if norm2 is None else norm2 + raw * raw
    norm = torch.sqrt(norm2)
    del norm2
    norm = torch.where(norm > 1e-12, norm, 1.0)
    out = torch.empty((nbands, *shape), dtype=torch.float32, device=device)
    for k, raw in enumerate(raws()):
        out[k] = raw / norm
    return out


def _wrapped(x: torch.Tensor) -> torch.Tensor:
    """x wrapped into [-pi, pi], as np.angle(np.exp(1j * x))."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def _wedge(theta: torch.Tensor, center: float, width: float) -> torch.Tensor:
    """cos^2 wedge of support 2 * width around center, plus its antipode."""
    x = theta - center
    out = None
    for d in (x, x - math.pi):
        w = torch.cos(_div(_wrapped(d), 2 * width).clamp(-0.5, 0.5) * math.pi)
        out = w * w if out is None else out + w * w
    return out


def _meta_2d(n_scales: int, n_angles_coarse: int) -> list:
    meta = [(-1, 0)]
    for j in range(n_scales):
        meta += [(j, a) for a in range(max(1, n_angles_coarse * (2 ** (j // 2))))]
    return meta


@functools.lru_cache(maxsize=16)
def _windows_2d(ny: int, nx: int, n_scales: int, n_angles_coarse: int, device=None):
    """Tight-frame window stack (K, ny, nx) float32 on device in unshifted
    fft layout (DC at [0, 0]), and its metadata [(scale, wedge)]: band 0
    the lowpass, then per scale j (coarse to fine) n_angles_coarse *
    2^(j // 2) angular wedges."""
    device = _device(device)
    meta = _meta_2d(n_scales, n_angles_coarse)
    fy = _fftfreq64(ny, device)[:, None]
    fx = _fftfreq64(nx, device)[None, :]
    r = _div(torch.sqrt(fy * fy + fx * fx), 0.5)
    theta = torch.atan2(fy.expand(ny, nx), fx.expand(ny, nx))
    edges = _edges(n_scales)

    def raws():
        yield _lowpass(r, edges)
        for j in range(n_scales):
            rad = _annulus(r, edges[j], edges[j + 1])
            n_ang = max(1, n_angles_coarse * (2 ** (j // 2)))
            if n_ang == 1:
                yield rad
                continue
            width = 2 * np.pi / n_ang
            for a in range(n_ang):
                yield rad * _wedge(theta, -np.pi + (a + 0.5) * width, width)

    return _normalised(raws, len(meta), (ny, nx), device), meta


def curvelet_bands_2d(shape, n_scales: int = 4, n_angles: int = 8, device=None):
    """The (K, ny, nx) tight-frame window stack on device and its band
    metadata."""
    ny, nx = shape
    return _windows_2d(ny, nx, n_scales, n_angles, _device(device))


def _image(image) -> torch.Tensor:
    return torch.as_tensor(image).to(torch.float32)


def _coeffs(F: torch.Tensor, U_k: torch.Tensor, dims) -> torch.Tensor:
    """Band k's complex coefficients ifftn(F U_k) (the forward pass)."""
    return torch.fft.ifftn(F * U_k, dim=dims)


def _accumulate(acc, c: torch.Tensor, U_k: torch.Tensor, dims) -> torch.Tensor:
    """acc + fftn(c) U_k, the inverse pass's sum over the bands."""
    Fk = torch.fft.fftn(c, dim=dims).mul_(U_k)
    return Fk if acc is None else acc.add_(Fk)


def _synthesis(acc: torch.Tensor, dims) -> torch.Tensor:
    return torch.fft.ifftn(acc, dim=dims).real


def curvelet_transform_2d(image, n_scales: int = 4, n_angles: int = 8) -> torch.Tensor:
    """Forward transform: (K, ny, nx) complex band coefficients."""
    img = _image(image)
    U, _ = _windows_2d(img.shape[0], img.shape[1], n_scales, n_angles, img.device)
    F = torch.fft.fftn(img, dim=(-2, -1))
    return torch.fft.ifftn(F[None] * U, dim=(-2, -1))


def curvelet_inverse_2d(coeffs, n_scales: int = 4, n_angles: int = 8) -> torch.Tensor:
    """Inverse of curvelet_transform_2d (tight frame: apply U again, sum)."""
    coeffs = torch.as_tensor(coeffs)
    ny, nx = coeffs.shape[-2:]
    U, _ = _windows_2d(ny, nx, n_scales, n_angles, coeffs.device)
    F = torch.fft.fftn(coeffs, dim=(-2, -1))
    return torch.fft.ifftn((F * U).sum(dim=0), dim=(-2, -1)).real


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median of each row of x (..., n): the sorted values at jnp's
    float32 index q = 0.5 * (n - 1), floor and ceil, averaged."""
    n = x.shape[-1]
    q = np.float32(0.5) * (np.float32(n) - np.float32(1))
    lo = int(min(max(np.floor(q), 0), n - 1))
    hi = int(min(max(np.ceil(q), 0), n - 1))
    s = torch.sort(x, dim=-1).values
    return (s[..., lo] + s[..., hi]) * 0.5


def _mad_sigma(x: torch.Tensor) -> torch.Tensor:
    """1.4826 x the median absolute deviation of each row of x (..., n)."""
    med = _median(x)
    return _median(torch.abs(x - med[..., None])) * 1.4826


def _elbow_threshold(mags: torch.Tensor) -> torch.Tensor:
    """Auto threshold of each row of mags (..., n) at the elbow of its
    sorted-magnitude curve: the value farthest (first of ties) from the
    chord of the normalised curve."""
    v = torch.sort(mags, dim=-1).values
    n = v.shape[-1]
    t = torch.arange(n, dtype=torch.float32, device=v.device) / torch.tensor(
        float(max(1, n - 1)), dtype=torch.float32, device=v.device)
    vn = (v - v[..., :1]) / torch.clamp_min(v[..., -1:] - v[..., :1], 1e-12)
    idx = torch.argmax(torch.abs(vn - t), dim=-1, keepdim=True)
    return torch.gather(v, -1, idx)[..., 0]


def _threshold(mag: torch.Tensor, threshold_sigma: float, sigma, lead: int) -> torch.Tensor:
    """Band threshold, one per leading index: the elbow for
    threshold_sigma <= 0, else threshold_sigma x sigma."""
    if threshold_sigma <= 0:
        return _elbow_threshold(mag.reshape(*mag.shape[:lead], -1))
    return threshold_sigma * sigma


def _keep(c: torch.Tensor, mag: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """c where mag >= thr (thr broadcast over the band's axes), else 0."""
    thr = thr.reshape(*thr.shape, *([1] * (mag.ndim - thr.ndim)))
    return torch.where(mag >= thr, c, torch.zeros((), dtype=c.dtype, device=c.device))


def denoise_curvelet_2d(
    image,
    transform: str = "udct",
    threshold_sigma: float = 3.0,
    n_scales: int = 4,
    n_angles: int = 8,
    *,
    on_band=None,
) -> torch.Tensor:
    """Hard-threshold curvelet denoising of a 2D image or a stack
    (..., ny, nx), each image on its own noise level.

    transform: "udct" (plain) or "mct" (monogenic: the modulus of the
    Riesz triple is thresholded; c0's values are kept). Every band but
    the lowpass is thresholded at threshold_sigma x the MAD noise level
    of the finest band's real part, or, for threshold_sigma <= 0, at the
    elbow of its own sorted magnitudes.
    """
    img = _image(image)
    lead = img.ndim - 2
    ny, nx = img.shape[-2:]
    dims = (-2, -1)
    U, meta = _windows_2d(ny, nx, n_scales, n_angles, img.device)
    F = torch.fft.fftn(img, dim=dims)
    if transform == "mct":
        FR = [torch.fft.fftn(r, dim=dims) for r in riesz_transform_2d(img)]
    K = len(meta)
    finest = _coeffs(F, U[K - 1], dims)
    sigma = _mad_sigma(finest.real.reshape(*img.shape[:lead], -1))
    acc = None
    for k, (scale, _) in enumerate(meta):
        c = finest if k == K - 1 else _coeffs(F, U[k], dims)
        if scale != -1:  # never threshold the lowpass
            mag = torch.abs(c)
            if transform == "mct":
                mag = mag * mag
                for Fr in FR:
                    m = torch.abs(_coeffs(Fr, U[k], dims))
                    mag = mag + m * m
                mag = torch.sqrt(mag)
            thr = _threshold(mag, threshold_sigma, sigma, lead)
            if on_band is not None:
                on_band(k, c, mag, thr)
            c = _keep(c, mag, thr)
        acc = _accumulate(acc, c, U[k], dims)
    return _synthesis(acc, dims)


def riesz_transform_2d(image):
    """Riesz x/y components of an image (..., ny, nx): the monogenic
    signal's odd parts."""
    img = _image(image)
    ny, nx = img.shape[-2:]
    fy = _fftfreq64(ny, img.device).to(torch.float32)[:, None]
    fx = _fftfreq64(nx, img.device).to(torch.float32)[None, :]
    norm = torch.sqrt(fy * fy + fx * fx)
    norm = torch.where(norm > 0, norm, 1.0)
    F = torch.fft.fftn(img, dim=(-2, -1))
    rx = torch.fft.ifftn(F * (-1j) * fx / norm, dim=(-2, -1)).real
    ry = torch.fft.ifftn(F * (-1j) * fy / norm, dim=(-2, -1)).real
    return rx, ry


def _radius_3d(nz: int, ny: int, nx: int, device):
    fz = _fftfreq64(nz, device)[:, None, None]
    fy = _fftfreq64(ny, device)[None, :, None]
    fx = _fftfreq64(nx, device)[None, None, :]
    return fz, fy, fx, _div(torch.sqrt(fz * fz + fy * fy + fx * fx), 0.5)


@functools.lru_cache(maxsize=2)
def _radial_bands_3d(nz: int, ny: int, nx: int, n_scales: int, device=None) -> torch.Tensor:
    """The isotropic 3D stack (n_scales + 1, nz, ny, nx) float32 on device:
    the lowpass and one Meyer annulus a scale."""
    device = _device(device)
    *_, r = _radius_3d(nz, ny, nx, device)
    edges = _edges(n_scales)

    def raws():
        yield _lowpass(r, edges)
        for j in range(n_scales):
            yield _annulus(r, edges[j], edges[j + 1])

    return _normalised(raws, n_scales + 1, (nz, ny, nx), device)


def _fibonacci_hemisphere(n: int) -> np.ndarray:
    """n well-spread unit directions (n, 3) zyx on the upper hemisphere
    (the lower half is implied by the antipodal |u.d| symmetry)."""
    i = np.arange(n, dtype=np.float64)
    z = (i + 0.5) / n
    phi = i * np.pi * (3.0 - np.sqrt(5.0))  # golden angle
    s = np.sqrt(1.0 - z * z)
    return np.stack([z, s * np.sin(phi), s * np.cos(phi)], axis=1)


def _cap(u, d, width: float) -> torch.Tensor:
    """cos^2 cap of angular radius width around +-d (d a zyx unit vector)."""
    cosang = torch.abs(float(d[0]) * u[0] + float(d[1]) * u[1] + float(d[2]) * u[2])
    alpha = torch.arccos(cosang.clamp(0.0, 1.0))
    w = torch.cos(_div(alpha, width).clamp(0.0, 1.0) * (np.pi / 2))
    return w * w


def _cap_width(u, dirs, on_shell: torch.Tensor) -> float:
    """The caps' width: the mean spacing of n_d centres, widened x1.2 (up
    to 7 times) until the caps cover every shell voxel; the width of the
    last try if none covers."""
    width = 1.5 * np.sqrt(2.0 * np.pi / len(dirs))
    for _ in range(8):
        used = width
        total = None
        for d in dirs:
            a = _cap(u, d, width)
            total = a if total is None else total + a
        if bool(((total > 1e-6) | ~on_shell).all()):
            break
        width *= 1.2
    return used


@functools.lru_cache(maxsize=2)
def _directional_bands_3d(nz: int, ny: int, nx: int, n_scales: int, n_dirs: int, device=None):
    """Directional 3D tight-frame windows (K, nz, ny, nx) float32 on
    device: Meyer annuli x antipodal cos^2 spherical caps around
    n_dirs * 2^(j // 2) Fibonacci directions at scale j, and their
    metadata [(scale, wedge)], scale -1 the lowpass."""
    device = _device(device)
    fz, fy, fx, r = _radius_3d(nz, ny, nx, device)
    r_safe = torch.where(r > 1e-12, r, 1.0)
    half = 0.5 * r_safe
    u = (fz / half, fy / half, fx / half)
    del half, r_safe
    edges = _edges(n_scales)
    meta = [(-1, 0)]
    scales = []  # (lo, hi, dirs or None, width)
    for j in range(n_scales):
        lo, hi = edges[j], edges[j + 1]
        n_d = max(1, n_dirs * (2 ** (j // 2)))
        if n_d == 1:
            scales.append((lo, hi, None, None))
            meta.append((j, 0))
            continue
        dirs = _fibonacci_hemisphere(n_d)
        width = _cap_width(u, dirs, _annulus(r, lo, hi) > 1e-3)
        scales.append((lo, hi, dirs, width))
        meta += [(j, a) for a in range(n_d)]

    def raws():
        yield _lowpass(r, edges)
        for lo, hi, dirs, width in scales:
            rad = _annulus(r, lo, hi)
            if dirs is None:
                yield rad
                continue
            for d in dirs:
                yield rad * _cap(u, d, width)

    return _normalised(raws, len(meta), (nz, ny, nx), device), meta


def curvelet_bands_3d(shape, n_scales: int = 4, n_dirs: int = 6, device=None):
    """The (K, nz, ny, nx) directional 3D window stack on device and its
    metadata; n_dirs <= 0 selects the isotropic radial bands."""
    nz, ny, nx = shape
    device = _device(device)
    if n_dirs <= 0:
        U = _radial_bands_3d(nz, ny, nx, n_scales, device)
        return U, [(-1, 0)] + [(j, 0) for j in range(n_scales)]
    return _directional_bands_3d(nz, ny, nx, n_scales, n_dirs, device)


def denoise_curvelet_3d(
    volume,
    threshold_sigma: float = 3.0,
    n_scales: int = 4,
    n_dirs: int = 6,
    *,
    on_band=None,
    **kwargs,
) -> torch.Tensor:
    """Directional-band threshold denoising of a 3D map, band by band.

    The lowpass is kept; every other band is thresholded at
    threshold_sigma x the MAD noise level of its own real part (with
    directional wedges the noise level depends on the orientation), or,
    for threshold_sigma <= 0, at the elbow of its sorted magnitudes.
    n_dirs=0 selects the isotropic radial bands.
    """
    vol = _image(volume)
    dims = (-3, -2, -1)
    U, _ = curvelet_bands_3d(vol.shape, n_scales=n_scales, n_dirs=n_dirs, device=vol.device)
    F = torch.fft.fftn(vol, dim=dims)
    acc = None
    for k in range(U.shape[0]):
        c = _coeffs(F, U[k], dims)
        if k > 0:
            mag = torch.abs(c)
            sigma = None if threshold_sigma <= 0 else _mad_sigma(c.real.reshape(-1))
            thr = _threshold(mag, threshold_sigma, sigma, 0)
            if on_band is not None:
                on_band(k, c, mag, thr)
            c = _keep(c, mag, thr)
            del mag
        acc = _accumulate(acc, c, U[k], dims)
        del c
    return _synthesis(acc, dims)


def _ramp(overlap: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(np.pi * np.arange(overlap) / overlap)


def _taper(n: int, overlap: int, at_lo_edge: bool, at_hi_edge: bool) -> np.ndarray:
    """A tile's 1D float64 cosine taper; none on the image's own boundary
    (no neighbour covers it there)."""
    ramp = _ramp(overlap)
    t = np.ones(n)
    if not at_lo_edge:
        t[:overlap] = ramp[:n]
    if not at_hi_edge:
        t[-overlap:] = ramp[::-1][-n:]
    return t


def denoise_curvelet_2d_tiled(
    image,
    tile_size: int = 512,
    overlap: int = 64,
    threshold_sigma: float = 3.0,
    **kwargs,
) -> torch.Tensor:
    """Overlap-add tiled denoising of a large image with cosine tapers:
    each tile denoised alone, weighted by its taper, and the sum divided
    by the summed weights (float64 weights added into float32 sums, as
    the reference's numpy adds them)."""
    img = _image(image)
    ny, nx = img.shape
    if max(ny, nx) <= tile_size:
        return denoise_curvelet_2d(img, threshold_sigma=threshold_sigma, **kwargs)
    step = tile_size - overlap
    out = torch.zeros_like(img)
    wsum = torch.zeros_like(img)
    for y0 in range(0, max(1, ny - overlap), step):
        for x0 in range(0, max(1, nx - overlap), step):
            y1, x1 = min(y0 + tile_size, ny), min(x0 + tile_size, nx)
            y0a, x0a = max(0, y1 - tile_size), max(0, x1 - tile_size)
            den = denoise_curvelet_2d(img[y0a:y1, x0a:x1], threshold_sigma=threshold_sigma,
                                      **kwargs)
            ty = torch.as_tensor(
                _taper(y1 - y0a, overlap, y0a == 0, y1 == ny)[:, None]
                * _taper(x1 - x0a, overlap, x0a == 0, x1 == nx)[None, :], device=img.device)
            sl = (slice(y0a, y1), slice(x0a, x1))
            out[sl] = (out[sl].double() + den.double() * ty).float()
            wsum[sl] = (wsum[sl].double() + ty).float()
    return out / torch.clamp_min(wsum, 1e-8)


# ---------------------------------------------------------------------------
# reference-compatible aliases (curvelet_denoise_{fdct,udct,mct}[_tiled],
# the _batch_ and 3D variants); fdct and udct are the same tight frame
# ---------------------------------------------------------------------------


def curvelet_denoise_udct(data, threshold_sigma: float = 3.0, **kwargs):
    return denoise_curvelet_2d(data, transform="udct", threshold_sigma=threshold_sigma, **kwargs)


def curvelet_denoise_fdct(data, threshold_sigma: float = 3.0, **kwargs):
    return denoise_curvelet_2d(data, transform="udct", threshold_sigma=threshold_sigma, **kwargs)


def curvelet_denoise_mct(data, threshold_sigma: float = 3.0, **kwargs):
    return denoise_curvelet_2d(data, transform="mct", threshold_sigma=threshold_sigma, **kwargs)


def _tiled(transform):
    def wrapper(data, tile_size: int = 512, overlap: int = 64, **kwargs):
        kwargs.setdefault("transform", transform)
        return denoise_curvelet_2d_tiled(data, tile_size=tile_size, overlap=overlap, **kwargs)

    return wrapper


curvelet_denoise_udct_tiled = _tiled("udct")
curvelet_denoise_fdct_tiled = _tiled("udct")
curvelet_denoise_mct_tiled = _tiled("mct")


def _batch(fn):
    def wrapper(stack, device=None, **kwargs):
        """Denoise each image of a stack (n, ny, nx) on ``device`` (by
        default the stack's own), in chunks of at most BATCH_PIXELS pixels.
        A list or tuple of images is denoised one image at a time: an image
        that is not a tensor goes to ``device`` alone and its result comes
        back to the host before the next one goes, so the device holds one
        image's work at a time. The results are stacked only when their
        shapes and devices agree."""
        if isinstance(stack, (list, tuple)):
            outs = []
            for img in stack:
                out = fn(_image(img).to(device), **kwargs)
                outs.append(out if isinstance(img, torch.Tensor) else out.cpu())
            if len({(o.device, tuple(o.shape)) for o in outs}) == 1:
                return torch.stack(outs)
            return outs
        stack = _image(stack)
        per = max(1, BATCH_PIXELS // (stack.shape[-2] * stack.shape[-1]))
        return torch.cat([fn(stack[i : i + per].to(device), **kwargs)
                          for i in range(0, stack.shape[0], per)])

    return wrapper


curvelet_denoise_batch_udct = _batch(curvelet_denoise_udct)
curvelet_denoise_batch_fdct = _batch(curvelet_denoise_fdct)
curvelet_denoise_batch_mct = _batch(curvelet_denoise_mct)


def curvelet_denoise_3d_udct(data, threshold_sigma: float = 3.0, **kwargs):
    return denoise_curvelet_3d(data, threshold_sigma=threshold_sigma, **kwargs)


def curvelet_denoise_3d_mct(data, threshold_sigma: float = 3.0, **kwargs):
    return denoise_curvelet_3d(data, threshold_sigma=threshold_sigma, **kwargs)


def curvelet_denoise_3d_udct_tiled(data, tile_size: int = 128, overlap: int = 16,
                                   threshold_sigma: float = 3.0, **kwargs) -> torch.Tensor:
    """Overlap-add z-chunked 3D denoising with cosine tapers along z."""
    vol = _image(data)
    nz = vol.shape[0]
    if nz <= tile_size:
        return denoise_curvelet_3d(vol, threshold_sigma=threshold_sigma, **kwargs)
    step = tile_size - overlap
    out = torch.zeros_like(vol)
    wsum = torch.zeros(nz, dtype=torch.float32, device=vol.device)
    ramp = _ramp(overlap)
    for z0 in range(0, max(1, nz - overlap), step):
        z1 = min(z0 + tile_size, nz)
        z0a = max(0, z1 - tile_size)
        den = denoise_curvelet_3d(vol[z0a:z1], threshold_sigma=threshold_sigma, **kwargs)
        n = z1 - z0a
        t = np.ones(n, np.float32)
        if z0a > 0:  # taper only where a neighbouring chunk overlaps
            t[:overlap] = ramp[:n]
        if z1 < nz:
            t[-overlap:] = ramp[::-1][-n:]
        t = torch.as_tensor(t, device=vol.device)
        out[z0a:z1] += den * t[:, None, None]
        wsum[z0a:z1] += t
    return out / torch.clamp_min(wsum, 1e-8)[:, None, None]


curvelet_denoise_3d_mct_tiled = curvelet_denoise_3d_udct_tiled

__all__ += [
    "curvelet_denoise_3d_mct",
    "curvelet_denoise_3d_mct_tiled",
    "curvelet_denoise_3d_udct",
    "curvelet_denoise_3d_udct_tiled",
    "curvelet_denoise_batch_fdct",
    "curvelet_denoise_batch_mct",
    "curvelet_denoise_batch_udct",
    "curvelet_denoise_fdct",
    "curvelet_denoise_fdct_tiled",
    "curvelet_denoise_mct",
    "curvelet_denoise_mct_tiled",
    "curvelet_denoise_udct",
    "curvelet_denoise_udct_tiled",
]
