"""Image and volume transforms: ``transform_image`` (the centre-referenced
affine warp), ``rotate_shift_image`` (rotation about a centre with
pre/post shifts), ``pad_to_size``, the centre crops, the helical
symmetrization ``apply_helical_symmetry``, the cubic volume transform
``transform_map``, the zero-padded clips, the straightened strip
``get_rotated_clip``, the Fourier crop and rescale, the hand flip, the
power spectra and the Friedel phase difference across the meridian.

Counterpart of ``helicon_tpu/core/transforms.py:261``, ``:326``, ``:401``,
``:370`` / ``:378`` (the crops), ``:143`` with ``_helical_sym_accumulate``
:65, ``:219``, ``:421`` / ``:433`` (the clips), ``:448``
(``get_rotated_clip``), ``:467`` (``fft_crop``), ``:507``
(``fft_rescale``), ``:561`` (``flip_hand``), ``:572``
(``compute_power_spectra``, with a batched form for stacks of images) and
``:601`` (``compute_phase_difference_across_meridian``). Each runs on the
device of the tensor it is given.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import rotation
from .czt import zoom_fft_2d, zoom_fft_3d
from .filters import low_high_pass_filter, normalize_percentile
from .interp import map_coordinates

__all__ = ["transform_image", "rotate_shift_image", "pad_to_size", "crop_center",
           "crop_center_z", "apply_helical_symmetry", "transform_map", "get_clip",
           "get_clip3d", "get_rotated_clip", "fft_crop", "fft_rescale", "flip_hand",
           "compute_power_spectra", "compute_power_spectra_batch",
           "compute_phase_difference_across_meridian"]


_WARP_MODES = {"constant": "constant", "edge": "nearest", "symmetric": "reflect",
               "reflect": "mirror", "wrap": "wrap"}


def transform_image(image, scale=1.0, rotation: float = 0.0, rotation_center=None,
                    pre_translation=(0.0, 0.0), post_translation=(0.0, 0.0),
                    mode: str = "constant", order: int = 1):
    """Centre-referenced affine warp of a 2D image: pre_translation, to the
    centre (ny/2, nx/2 unless given), rotate by ``rotation`` degrees and
    scale (one factor or (sy, sx)), back from the centre, post_translation,
    sampled through the inverse map (the skimage chain of the reference;
    translations and centres are (y, x)). mode: skimage's names
    (constant, edge, symmetric, reflect, wrap)."""
    image = torch.as_tensor(image, dtype=torch.float32)
    ny, nx = image.shape
    if rotation_center is None:
        center = np.array([ny, nx], dtype=np.float64) / 2.0
    else:
        center = np.asarray(rotation_center, dtype=np.float64)
    if np.isscalar(scale) or isinstance(scale, (int, float)):
        scale = (float(scale), float(scale))
    sy, sx = float(scale[0]), float(scale[1])

    def T(tx, ty):
        m = np.eye(3)
        m[0, 2], m[1, 2] = tx, ty
        return m

    theta = math.radians(rotation)
    RS = np.array([[sx * math.cos(theta), -sy * math.sin(theta), 0.0],
                   [sx * math.sin(theta), sy * math.cos(theta), 0.0],
                   [0.0, 0.0, 1.0]])
    M = (T(post_translation[1], post_translation[0]) @ T(center[1], center[0]) @ RS
         @ T(-center[1], -center[0]) @ T(pre_translation[1], pre_translation[0]))
    Minv = np.linalg.inv(M)
    rr, cc = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=image.device),
        torch.arange(nx, dtype=torch.float32, device=image.device),
        indexing="ij",
    )
    x_src = float(Minv[0, 0]) * cc + float(Minv[0, 1]) * rr + float(Minv[0, 2])
    y_src = float(Minv[1, 0]) * cc + float(Minv[1, 1]) * rr + float(Minv[1, 2])
    return map_coordinates(image, (y_src, x_src), order=order,
                           mode=_WARP_MODES.get(mode, "constant"))


def rotate_shift_image(data, angle: float = 0, pre_shift=(0, 0), post_shift=(0, 0),
                       rotation_center=None, order: int = 1):
    """Rotate a 2D image by ``angle`` degrees about rotation_center
    (default (ny // 2, nx // 2)) with (y, x) pre/post shifts: the output
    samples the input at m @ out + offset, zeros outside."""
    data = torch.as_tensor(data, dtype=torch.float32)
    if angle == 0 and tuple(pre_shift) == (0, 0) and tuple(post_shift) == (0, 0):
        return data * 1.0
    ny, nx = data.shape
    if rotation_center is None:
        rotation_center = np.array([ny // 2, nx // 2], dtype=np.float64)
    else:
        rotation_center = np.asarray(rotation_center, dtype=np.float64)
    ang = math.radians(angle)
    m = np.array([[math.cos(ang), math.sin(ang)], [-math.sin(ang), math.cos(ang)]])
    offset = -m @ np.asarray(post_shift, dtype=np.float64)
    offset += rotation_center - m @ rotation_center
    offset += -np.asarray(pre_shift, dtype=np.float64)
    rr, cc = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=data.device),
        torch.arange(nx, dtype=torch.float32, device=data.device),
        indexing="ij",
    )
    y_src = float(m[0, 0]) * rr + float(m[0, 1]) * cc + float(offset[0])
    x_src = float(m[1, 0]) * rr + float(m[1, 1]) * cc + float(offset[1])
    return map_coordinates(data, (y_src, x_src), order=order, mode="constant")


def pad_to_size(data, shape):
    """Zero-pad a 2D/3D array or tensor to the target shape, centred."""
    if data.ndim not in (2, 3):
        raise ValueError("pad_to_size takes a 2D or 3D array")
    if tuple(data.shape) == tuple(shape):
        return data
    ny, nx = data.shape[-2:]
    my, mx = shape[-2:]
    yb = max(0, (my - ny) // 2)
    ya = max(0, my - yb - ny)
    xb = max(0, (mx - nx) // 2)
    xa = max(0, mx - xb - nx)
    pads = [(yb, ya), (xb, xa)]
    if data.ndim == 3:
        nz, mz = data.shape[0], shape[0]
        zb = max(0, (mz - nz) // 2)
        pads.insert(0, (zb, max(0, mz - zb - nz)))
    if isinstance(data, torch.Tensor):
        return F.pad(data, [p for pair in reversed(pads) for p in pair])
    return np.pad(data, pads)


def crop_center_z(data, n: int):
    """Keep n central z slices; the end is nz // 2 + n // 2 + n, as the
    reference's (so up to n // 2 more than n)."""
    if data.ndim != 3:
        raise ValueError("crop_center_z takes a 3D array")
    nz = data.shape[0]
    return data[nz // 2 - n // 2 : nz // 2 + n // 2 + n]


def crop_center(data, shape, center_offset=None):
    """The central region of shape ``shape`` of a 2D or 3D array or tensor,
    optionally offset from the centre (clipped at the edges)."""
    if data.ndim not in (2, 3) or data.ndim != len(shape):
        raise ValueError("crop_center takes a 2D or 3D array and a shape of its rank")
    if tuple(data.shape) == tuple(shape):
        return data
    offset = center_offset if center_offset is not None else (0,) * data.ndim
    sl = []
    for n, m, d in zip(data.shape, shape, offset):
        lo = max(0, n // 2 + d - m // 2)
        sl.append(slice(lo, min(n, lo + m)))
    return data[tuple(sl)]


# elements of one symmetry-copy chunk's work tensors (each temporary of
# apply_helical_symmetry holds chunk x work-volume values)
SYM_CHUNK_ELEMS = 1 << 24


def _sym_z_range(data, fraction: float) -> tuple[int, int]:
    """[z0, z1) of the source's slices above 1 % of its peak z-profile,
    shrunk about their middle to ``fraction`` of nz."""
    nz0 = data.shape[0]
    profile = data.sum(dim=(1, 2))
    nonzero = (profile > 0.01 * profile.max()).cpu().numpy()
    idx = np.flatnonzero(nonzero)
    z0 = int(idx.min()) if idx.size else nz0
    z1 = int(idx.max()) if idx.size else -1
    zmid = (z0 + z1) // 2 + (z0 + z1) % 2
    half = int(nz0 * fraction + 0.5) // 2
    return max(z0, zmid - half), min(z1, zmid + half)


def _sym_accumulate(data, twist_degree, rise_pixel_src, scale, z0, z1, csym, n_hsym,
                    work_shape):
    """Average the symmetry copies onto the work grid: for each output voxel
    and each (hsym, csym) copy, hsym major, the trilinear sample of the
    source, counted where the copy lands inside the z-range and the in-plane
    bounds (the test on the unclamped floors; the +1 neighbours clamped).
    Returns acc / max(wsum, 1) where wsum > 0, else acc.

    A copy's z coordinate depends on the output slice only and its (y, x)
    on the output column only, so each copy first samples every source
    plane bilinearly at its (y, x), then interpolates between two of those
    planes per output slice: the reference's eight-tap sum, grouped
    (1 - wk) * (the floor plane's four taps) + wk * (the ceiling plane's).
    The copies run a chunk at a time and are added to the accumulator one
    by one in the reference's order."""
    dev = data.device
    nz, ny, nx = work_shape
    nz0, ny0, nx0 = data.shape
    f32 = dict(dtype=torch.float32, device=dev)
    K = torch.arange(nz, **f32)[:, None] - nz // 2
    J = torch.arange(ny, **f32)[:, None] - ny // 2
    I = torch.arange(nx, **f32)[None, :] - nx / 2
    hs = np.repeat(np.arange(-n_hsym, n_hsym + 1, dtype=np.float32), csym)
    cs = np.tile(np.arange(csym, dtype=np.float32), 2 * n_hsym + 1)
    planes = data.reshape(nz0, ny0 * nx0)
    acc = torch.zeros(work_shape, **f32)
    wsum = torch.zeros(work_shape, **f32)
    chunk = max(1, SYM_CHUNK_ELEMS // (nz * ny * nx))
    for s in range(0, len(hs), chunk):
        hi = torch.as_tensor(hs[s : s + chunk], device=dev)[:, None, None]
        ci = torch.as_tensor(cs[s : s + chunk], device=dev)[:, None, None]
        n = len(hi)
        k2 = (K * scale + hi * rise_pixel_src) + nz0 // 2  # (n, nz, 1)
        rot = (twist_degree * hi + 360.0 * ci / csym) * float(np.float32(np.pi / 180))
        c, sn = rotation.cos_sin(rot)
        j2 = (c * J + sn * I) * scale + ny0 // 2  # (n, ny, nx)
        i2 = (-sn * J + c * I) * scale + nx0 // 2
        kf, jf, if_ = torch.floor(k2), torch.floor(j2), torch.floor(i2)
        wk, wj, wi = k2 - kf, j2 - jf, i2 - if_
        valid = (((k2 >= z0) & (k2 < z1))[:, :, :, None]
                 & ((jf >= 0) & (jf < ny0 - 1) & (if_ >= 0) & (if_ < nx0 - 1))[:, None])
        jf_i = jf.to(torch.int64).clamp(0, ny0 - 1)
        if_i = if_.to(torch.int64).clamp(0, nx0 - 1)
        j_b = (jf_i * nx0, (jf_i + 1).clamp(0, ny0 - 1) * nx0)
        i_b = (if_i, (if_i + 1).clamp(0, nx0 - 1))

        def taps(b, d):
            idx = (j_b[b] + i_b[d]).reshape(n, 1, ny * nx).expand(n, nz0, ny * nx)
            return torch.gather(planes.expand(n, nz0, ny0 * nx0), 2, idx)

        wjs, wis = ((1 - wj).reshape(n, 1, -1), wj.reshape(n, 1, -1)), \
            ((1 - wi).reshape(n, 1, -1), wi.reshape(n, 1, -1))
        plane_val = None  # (n, nz0, ny * nx): every source plane at the copy's (y, x)
        for b in (0, 1):
            for d in (0, 1):
                term = wjs[b] * wis[d] * taps(b, d)
                plane_val = term if plane_val is None else plane_val + term
        kf_i = kf.to(torch.int64).clamp(0, nz0 - 1)  # (n, nz, 1)
        kc_i = (kf_i + 1).clamp(0, nz0 - 1)
        lo = torch.gather(plane_val, 1, kf_i.expand(n, nz, ny * nx))
        hi_ = torch.gather(plane_val, 1, kc_i.expand(n, nz, ny * nx))
        val = ((1 - wk) * lo + wk * hi_).reshape(n, nz, ny, nx)
        val = torch.where(valid, val, 0.0)
        for v in val:
            acc += v
        wsum += valid.to(torch.float32).sum(dim=0)
    return torch.where(wsum > 0, acc / torch.clamp_min(wsum, 1.0), acc)


def apply_helical_symmetry(data, apix: float, twist_degree: float, rise_angstrom: float,
                           csym: int = 1, fraction: float = 1.0, new_size=None,
                           new_apix: float | None = None, cpu: int = 1) -> torch.Tensor:
    """Symmetrize a 3D map by averaging its helical and cyclic symmetry
    copies, optionally resampled to new_apix and new_size (a work grid of
    the larger of the two sizes per axis, centre-cropped to new_size). The
    copies span hsym in [-n, n], n = max(1, int(nz * new_apix / rise)),
    and csym; the source's z-range is its slices above 1 % of the peak
    profile, shrunk to ``fraction``. ``cpu`` is accepted and ignored."""
    data = torch.as_tensor(data, dtype=torch.float32)
    nz0, ny0, nx0 = data.shape
    new_apix = apix if new_apix is None else new_apix
    new_size = tuple(int(v) for v in (data.shape if new_size is None else new_size))
    if new_size != tuple(data.shape):
        work_shape = tuple(max(a, b) for a, b in zip(data.shape, new_size))
    else:
        work_shape = (nz0, ny0, nx0)
    n_hsym = max(1, int(work_shape[0] * new_apix / rise_angstrom))
    z0, z1 = _sym_z_range(data, fraction)
    out = _sym_accumulate(
        data, float(np.float32(twist_degree)), float(np.float32(rise_angstrom / apix)),
        float(np.float32(new_apix / apix)), float(z0), float(z1), int(csym), n_hsym,
        work_shape)
    if work_shape != new_size:
        out = out[tuple(slice(n // 2 - m // 2, n // 2 + m // 2)
                        for n, m in zip(work_shape, new_size))]
    return out


def transform_map(data, scale: float = 1.0, rot: float = 0, tilt: float = 0, psi: float = 0,
                  dx: float = 0, dy: float = 0, dz: float = 0):
    """Scale, rotate (intrinsic ZYZ: rot, tilt, psi in degrees) and shift a
    3D volume: each output voxel's centred coordinates, scaled and rotated
    forward, sampled from the input by cubic B-spline with zeros outside.
    The identity returns the data as given."""
    if scale == 1 and rot == 0 and tilt == 0 and psi == 0 and dx == 0 and dy == 0 and dz == 0:
        return torch.as_tensor(data)
    data = torch.as_tensor(data, dtype=torch.float32)
    nz, ny, nx = data.shape
    f32 = dict(dtype=torch.float32, device=data.device)
    Z, Y, X = torch.meshgrid(torch.arange(nz, **f32) - nz // 2, torch.arange(ny, **f32) - ny // 2,
                             torch.arange(nx, **f32) - nx // 2, indexing="ij")
    if scale != 1.0:
        Z, Y, X = Z * scale, Y * scale, X * scale
    R = rotation.euler_matrix("ZYZ", [rot, tilt, psi]).tolist()
    x = (X * R[0][0] + Y * R[0][1] + Z * R[0][2]) + nx // 2 - dx
    y = (X * R[1][0] + Y * R[1][1] + Z * R[1][2]) + ny // 2 - dy
    z = (X * R[2][0] + Y * R[2][1] + Z * R[2][2]) + nz // 2 - dz
    return map_coordinates(data, (z, y, x), order=3, mode="constant")


def get_clip(image, y0: int, x0: int, height: int, width: int) -> torch.Tensor:
    """Rectangular clip with zero padding outside the image."""
    image = torch.as_tensor(image)
    clip = torch.zeros((height, width), dtype=image.dtype, device=image.device)
    yc, xc = max(0, y0), max(0, x0)
    y1 = min(y0 + height, image.shape[0])
    x1 = min(x0 + width, image.shape[1])
    if y1 > yc and x1 > xc:
        clip[yc - y0 : y1 - y0, xc - x0 : x1 - x0] = image[yc:y1, xc:x1]
    return clip


def get_clip3d(data, z0: int, y0: int, x0: int, nz: int, ny: int, nx: int) -> torch.Tensor:
    """3D clip with zero padding outside the volume."""
    data = torch.as_tensor(data)
    clip = torch.zeros((nz, ny, nx), dtype=data.dtype, device=data.device)
    zc, yc, xc = max(0, z0), max(0, y0), max(0, x0)
    z1 = min(z0 + nz, data.shape[0])
    y1 = min(y0 + ny, data.shape[1])
    x1 = min(x0 + nx, data.shape[2])
    if z1 > zc and y1 > yc and x1 > xc:
        clip[zc - z0 : z1 - z0, yc - y0 : y1 - y0, xc - x0 : x1 - x0] = data[
            zc:z1, yc:y1, xc:x1
        ]
    return clip


def _linspace32(start: float, stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in float32, as jnp forms it:
    start (1 - i/(num-1)) + stop i/(num-1), the last point stop."""
    if num <= 1:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / torch.tensor(
        float(div), dtype=torch.float32, device=device)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32, device=device)])


def get_rotated_clip(image, y0, x0, y1, x1, width: int, order: int = 1) -> torch.Tensor:
    """A straightened strip (width, int(length)) along the segment
    (y0, x0) -> (y1, x1), sampled with zeros outside the image."""
    image = torch.as_tensor(image, dtype=torch.float32)
    dy, dx = y1 - y0, x1 - x0
    angle = math.atan2(dy, dx)
    length = math.hypot(dy, dx)
    xs = _linspace32(0.0, length, int(length), image.device)
    ys = _linspace32(-width / 2.0, width / 2.0, width, image.device)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    xr = X * math.cos(angle) - Y * math.sin(angle) + x0
    yr = X * math.sin(angle) + Y * math.cos(angle) + y0
    return map_coordinates(image, (yr, xr), order=order, mode="constant")


def fft_crop(data, output_size=None) -> torch.Tensor:
    """Downscale by truncating the Fourier transform (even sizes): the
    rfft's centred block of output_size, inverted over every axis of
    output_size (the reference inverts all axes in 3D too). Axes before
    the last len(output_size) are a batch, each entry cropped alone."""
    if output_size is None or tuple(data.shape) == tuple(output_size):
        return torch.as_tensor(data)
    data = torch.as_tensor(data, dtype=torch.float32)
    k = len(output_size)
    sizes = tuple(data.shape[data.ndim - k:])
    assert k in (2, 3) and data.ndim >= k
    assert all(s % 2 == 0 for s in output_size) and all(
        s % 2 == 0 for s in sizes
    ), f"fft_crop requires even sizes, got {sizes} -> {tuple(output_size)}"
    for n, m in zip(sizes, output_size):
        assert m <= n
    dims = tuple(range(-k, 0))
    lead = dims[:-1]
    fft = torch.fft.fftshift(torch.fft.rfftn(data, dim=dims), dim=lead)
    block = tuple(slice(n // 2 - m // 2, n // 2 + m // 2)
                  for n, m in zip(sizes[:-1], output_size[:-1]))
    fft = fft[(Ellipsis,) + block + (slice(0, output_size[-1] // 2 + 1),)]
    fft = torch.fft.fftshift(fft, dim=lead)
    # the block is no Hermitian spectrum (its last column is not the
    # input's Nyquist column), and c2r transforms differ on such input:
    # cuFFT's batched 2D c2r lay 0.5 of a unit-noise image from its single
    # one. So the leading axes invert as complex transforms, and the last
    # as a 1D c2r of lines whose first and last coefficients are real
    # (pocketfft's irfftn drops their imaginary parts so)
    z = torch.fft.ifftn(fft, dim=lead)
    z[..., 0].imag.zero_()
    z[..., -1].imag.zero_()
    return torch.fft.irfft(z, n=output_size[-1], dim=-1)


def _center_phase(out_sizes, zooms, in_sizes, device) -> torch.Tensor:
    """The re-centring phase exp(2 pi i f n_in / 2) of each output
    frequency times (-1)^(sum of output indices), complex128 on device:
    the reference's finufft type-2 treats the data origin at the array
    centre, the chirp-Z at the corner. Each axis's factor carries its own
    (-1)^index, and the outer product is taken in the reference's order."""
    ph = None
    for om, zoom, n_in in zip(out_sizes, zooms, in_sizes):
        f = np.fft.fftfreq(om) * zoom
        p = np.exp(2j * np.pi * f * (n_in / 2.0)) * np.where(np.arange(om) % 2, -1.0, 1.0)
        p = torch.as_tensor(p, device=device)
        ph = p if ph is None else ph[..., None] * p
    return ph


def fft_rescale(data, apix: float = 1.0, cutoff_res=None, output_size=None) -> torch.Tensor:
    """The Fourier transform evaluated on a rescaled uniform grid, by
    chirp-Z: frequencies ``fftfreq(m) * 2*apix/cutoff`` per axis, with the
    phase that centres the implied real-space origin. Returns complex64
    coefficients in fftfreq layout; ``ifftn`` gives the rescaled image."""
    data = torch.as_tensor(data)
    if data.ndim not in (2, 3):
        raise ValueError("only 2D images and 3D maps are supported")
    return _fft_rescale(data, data.ndim, apix, cutoff_res, output_size)


def _fft_rescale(data, ndim: int, apix, cutoff_res, output_size) -> torch.Tensor:
    """fft_rescale over the last ``ndim`` axes; leading axes are a batch."""
    shape = tuple(data.shape[-ndim:])
    cut = cutoff_res if cutoff_res else (2 * apix,) * ndim
    out = tuple(output_size) if output_size else shape
    zooms = tuple(2 * apix / c for c in cut)
    zoom_fft = zoom_fft_2d if ndim == 2 else zoom_fft_3d
    fft = zoom_fft(data, out, zooms)
    ph = _center_phase(out, zooms, shape, data.device)
    # the reference's decomposed complex product, in float32
    pr, pi = ph.real.to(torch.float32), ph.imag.to(torch.float32)
    del ph
    fr, fi = fft.real, fft.imag
    return torch.complex(fr * pr - fi * pi, fr * pi + fi * pr)


def flip_hand(data, axis: str = "x") -> torch.Tensor:
    """Mirror a 3D volume along one axis (handedness flip)."""
    dims = {"x": 2, "y": 1, "z": 0}
    if axis not in dims:
        raise ValueError("axis must be 'x', 'y', or 'z'")
    return torch.flip(torch.as_tensor(data), (dims[axis],))


def compute_power_spectra(data, apix: float, cutoff_res=None, output_size=None,
                          log: bool = True, low_pass_fraction: float = 0,
                          high_pass_fraction: float = 0):
    """Power spectrum and phase of a 2D image (or 3D map) on a rescaled
    Fourier grid (fft_rescale), fftshifted: log1p(|F|) (|F| when log is
    False), Gaussian low / high-passed when a fraction lies in (0, 1),
    then scaled to [0, 1]; the phase is angle(F). Returns (pwr, phase).
    An image takes the batched form's path, as a stack of one."""
    data = torch.as_tensor(data)
    if data.ndim == 2:
        pwr, phase = compute_power_spectra_batch(
            data[None], apix, cutoff_res=cutoff_res, output_size=output_size, log=log,
            low_pass_fraction=low_pass_fraction, high_pass_fraction=high_pass_fraction)
        return pwr[0], phase[0]
    fft = torch.fft.fftshift(fft_rescale(data, apix=apix, cutoff_res=cutoff_res,
                                         output_size=output_size))
    pwr = torch.log1p(torch.abs(fft)) if log else torch.abs(fft)
    if 0 < low_pass_fraction < 1 or 0 < high_pass_fraction < 1:
        pwr = low_high_pass_filter(pwr, low_pass_fraction=low_pass_fraction,
                                   high_pass_fraction=high_pass_fraction)
    return normalize_percentile(pwr, percentile=(0, 100)), torch.angle(fft)


def compute_power_spectra_batch(images, apix: float, cutoff_res=None, output_size=None,
                                log: bool = True, low_pass_fraction: float = 0,
                                high_pass_fraction: float = 0):
    """compute_power_spectra of each image of a (B, ny, nx) stack in one
    batched chirp-Z; every image's spectra equal its own call's bit for
    bit (the (0, 100) percentiles are each image's exact min and max).
    Returns (pwr, phase), each (B, ony, onx)."""
    images = torch.as_tensor(images)
    if images.ndim != 3:
        raise ValueError("compute_power_spectra_batch takes a (B, ny, nx) stack")
    fft = torch.fft.fftshift(_fft_rescale(images, 2, apix, cutoff_res, output_size),
                             dim=(-2, -1))
    # the elementwise functions image by image: a CPU kernel rounds the
    # vector tail of its flat loop apart from its body (atan2, log1p), and
    # the tail of a stack falls elsewhere in an image than its own call's
    pwr = torch.stack([torch.log1p(torch.abs(f)) if log else torch.abs(f) for f in fft])
    phase = torch.stack([torch.angle(f) for f in fft])
    del fft
    if 0 < low_pass_fraction < 1 or 0 < high_pass_fraction < 1:
        pwr = torch.stack([low_high_pass_filter(p, low_pass_fraction=low_pass_fraction,
                                                high_pass_fraction=high_pass_fraction)
                           for p in pwr])
    vmin = pwr.amin(dim=(-2, -1), keepdim=True)
    vmax = pwr.amax(dim=(-2, -1), keepdim=True)
    same = vmax == vmin
    pwr = torch.where(same, pwr, (pwr - vmin) / torch.where(same, 1.0, vmax - vmin))
    return pwr, phase


def compute_phase_difference_across_meridian(phase) -> torch.Tensor:
    """The Friedel phase difference across the meridian in degrees, in
    [0, 180] (0: an even Bessel order, 180: an odd one); column 0 is 0."""
    phase = torch.as_tensor(phase)
    diff = torch.zeros_like(phase)
    diff[..., 1:] = phase[..., 1:] - torch.flip(phase[..., 1:], dims=(-1,))
    return torch.rad2deg(torch.arccos(torch.cos(diff)))
