"""The image's preparation before a search, frozen: the transpose of a
vertical filament, the horizontalisation (a moment estimate, refined by a
Nelder-Mead search for the most mirror-symmetric row profile, then a cubic
rotation) and the anti-aliased down-scale to the target pixel size.

A copy of the port's plain steps (``denovo3d/pipeline.prepare_data``,
``helix/orient.auto_horizontalize``, ``core/analysis``'s moment estimate,
``core/interp.map_coordinates``, ``core/filters.down_scale``), in torch on
whatever device the image is on, and SciPy for the closing and the
simplex search.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import set_to_periodic_range

_POLE = math.sqrt(3.0) - 2.0


def _mirror(idx, n: int):
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.abs(idx) % period
    return torch.where(idx >= n, period - idx, idx)


def _spline_filter1d(x, axis: int):
    """Cubic B-spline prefilter along one axis, mirror boundary."""
    z = _POLE
    n = x.shape[axis]
    if n == 1:
        return x
    x = torch.movedim(x, axis, 0)
    y = x * ((1.0 - z) * (1.0 - 1.0 / z))
    horizon = min(n, int(np.ceil(np.log(1e-8) / np.log(abs(z)))) + 1)
    powers = torch.as_tensor((z ** np.arange(horizon)).astype(np.float32),
                             device=x.device).to(x.dtype)
    c = torch.tensordot(powers, y[:horizon], dims=([0], [0]))
    cp = [c]
    for i in range(1, n):
        c = y[i] + z * c
        cp.append(c)
    c = (z / (z * z - 1.0)) * (cp[n - 1] + z * cp[n - 2])
    out = [c]
    for i in range(n - 2, -1, -1):
        c = z * (c - cp[i])
        out.append(c)
    return torch.movedim(torch.stack(out[::-1]), 0, axis)


def _cubic_weights(t):
    t2 = t * t
    t3 = t2 * t
    return ((1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0, (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0,
            (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0, t3 / 6.0)


def map_coordinates(x: torch.Tensor, coords, order: int, mode: str) -> torch.Tensor:
    """A 2D float32 image sampled at (rows, cols): order 1 or 3, mode
    "constant" (0 outside [0, n-1]) or "mirror", as SciPy's."""
    coords = [torch.as_tensor(c, dtype=torch.float32, device=x.device) for c in coords]
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    coords = [c.expand(shape) for c in coords]
    in_domain = torch.ones(shape, dtype=torch.bool, device=x.device)
    if mode == "constant":
        for d, c in enumerate(coords):
            in_domain &= (c >= 0) & (c <= x.shape[d] - 1)
    floors = [torch.floor(c) for c in coords]
    lo = [f.to(torch.int64) for f in floors]
    frac = [c - f for c, f in zip(coords, floors)]
    out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    if order == 1:
        for corner in range(4):
            w = torch.ones(shape, dtype=torch.float32, device=x.device)
            idxs, valid = [], torch.ones(shape, dtype=torch.bool, device=x.device)
            for d in range(2):
                hi = (corner >> d) & 1
                w = w * (frac[d] if hi else (1.0 - frac[d]))
                i = lo[d] + hi
                n = x.shape[d]
                if mode == "mirror":
                    idxs.append(_mirror(i, n))
                else:
                    idxs.append(i.clamp(0, n - 1))
                    valid &= (i >= 0) & (i <= n - 1)
            vals = x[tuple(idxs)]
            if mode == "constant":
                vals = torch.where(valid, vals, 0.0)
            out = out + vals * w
    else:
        cx = _spline_filter1d(_spline_filter1d(x, 0), 1)
        wts = [_cubic_weights(f) for f in frac]
        for corner in range(16):
            w = torch.ones(shape, dtype=torch.float32, device=x.device)
            idxs, rem = [], corner
            for d in range(2):
                o = rem % 4
                rem //= 4
                w = w * wts[d][o]
                idxs.append(_mirror(lo[d] + (o - 1), x.shape[d]))
            out = out + cx[tuple(idxs)] * w
    if mode == "constant":
        out = torch.where(in_domain, out, 0.0)
    return out


def _grid(ny, nx, device):
    return torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device),
                          torch.arange(nx, dtype=torch.float32, device=device), indexing="ij")


def rotate_shift(data, angle, shift_y, order):
    """Rotate by angle degrees about (ny // 2, nx // 2), then shift by
    shift_y rows; zeros outside."""
    if angle == 0 and shift_y == 0:
        return data * 1.0
    ny, nx = data.shape
    centre = np.array([ny // 2, nx // 2], dtype=np.float64)
    a = math.radians(angle)
    m = np.array([[math.cos(a), math.sin(a)], [-math.sin(a), math.cos(a)]])
    # summed in the program's order: a sample on a pixel's edge flips with
    # the last bit of its coordinate
    offset = -m @ np.asarray((shift_y, 0), dtype=np.float64)
    offset += centre - m @ centre
    offset += -np.zeros(2, dtype=np.float64)
    rr, cc = _grid(ny, nx, data.device)
    y = float(m[0, 0]) * rr + float(m[0, 1]) * cc + float(offset[0])
    x = float(m[1, 0]) * rr + float(m[1, 1]) * cc + float(offset[1])
    return map_coordinates(data, (y, x), order, "constant")


def _rotate_about_centre(image: torch.Tensor, rotation: float) -> torch.Tensor:
    """Linear rotation about (ny / 2, nx / 2) by the inverse map."""
    ny, nx = image.shape
    cy, cx = ny / 2.0, nx / 2.0
    t = math.radians(rotation)

    def T(tx, ty):
        m = np.eye(3)
        m[0, 2], m[1, 2] = tx, ty
        return m

    RS = np.array([[math.cos(t), -math.sin(t), 0.0], [math.sin(t), math.cos(t), 0.0],
                   [0.0, 0.0, 1.0]])
    Minv = np.linalg.inv(T(cx, cy) @ RS @ T(-cx, -cy))
    rr, cc = _grid(ny, nx, image.device)
    xs = float(Minv[0, 0]) * cc + float(Minv[0, 1]) * rr + float(Minv[0, 2])
    ys = float(Minv[1, 0]) * cc + float(Minv[1, 1]) * rr + float(Minv[1, 2])
    return map_coordinates(image, (ys, xs), 1, "constant")


def _closing(mask: np.ndarray) -> np.ndarray:
    from scipy import ndimage as ndi

    s = ndi.generate_binary_structure(2, 1)
    return ndi.binary_erosion(ndi.binary_dilation(mask, structure=s), structure=s,
                              border_value=1)


def moment_estimate(data: np.ndarray):
    """(rotation degrees, y shift pixels) of the helix from the
    intensity-weighted second moments of its thresholded, closed mask."""
    data = np.asarray(data, np.float32)
    ny = data.shape[0]

    def params(mask, intensity):
        ys, xs = np.where(mask)
        if len(ys) < 2:
            return 0.0, 0.0
        w = intensity[ys, xs].astype(np.float64)
        w = w - w.min() + 1e-8
        cw = w.sum()
        cy, cx = (ys * w).sum() / cw, (xs * w).sum() / cw
        uy, ux = ys - cy, xs - cx
        i_yy, i_xx, i_xy = ((uy * uy * w).sum() / cw, (ux * ux * w).sum() / cw,
                            (uy * ux * w).sum() / cw)
        angle = math.degrees(0.5 * math.atan2(2.0 * i_xy, i_yy - i_xx)) + 90.0
        if abs(angle) > 90.0:
            angle -= 180.0
        return angle, ny // 2 - cy

    mask = _closing(data > 0)
    if not mask.any():
        return 0.0, 0.0
    rotation = set_to_periodic_range(params(mask, data)[0])
    rot = _rotate_about_centre(torch.as_tensor(data), rotation).numpy()
    mask_rot = _closing(rot > 0)
    if not mask_rot.any():
        return rotation, 0.0
    return rotation, params(mask_rot, rot)[1]


def horizontalize(data: torch.Tensor) -> torch.Tensor:
    """The helix rotated and shifted to lie horizontally through the
    centre (the moment estimate, refined by Nelder-Mead, xtol 1e-2)."""
    from scipy.optimize import fmin

    work = torch.clamp_min(data, 0)
    theta, shift_y = moment_estimate(data.cpu().numpy())

    def cost(v):
        y = rotate_shift(work, float(v[0]), float(v[1]), 1).sum(dim=1)[1:].cpu().numpy()
        return -np.std(y + y[::-1])

    theta, shift_y = fmin(cost, x0=(theta, shift_y), xtol=1e-2, disp=0)
    return rotate_shift(data, float(theta), float(shift_y), 3)


def _gaussian_blur(data: torch.Tensor, sigma: float) -> torch.Tensor:
    fft = torch.fft.fftn(data, dim=(0, 1))
    if sigma > 0:
        for ax in (0, 1):
            f = np.fft.fftfreq(data.shape[ax]).astype(np.float32)
            g = np.exp(-2 * (np.pi * f * sigma) ** 2)
            shape = [1, 1]
            shape[ax] = -1
            fft = fft * torch.as_tensor(g, device=data.device).reshape(shape)
    return torch.fft.ifftn(fft, dim=(0, 1)).real


def down_scale(data: torch.Tensor, target_apix: float, apix: float) -> torch.Tensor:
    """Gaussian prefilter, cubic resample to the larger pixel size, then
    zero-padding to even sizes."""
    if target_apix <= apix:
        return data
    scale = apix / target_apix
    ny0, nx0 = data.shape
    ny1, nx1 = int(round(ny0 * scale)), int(round(nx0 * scale))
    blurred = _gaussian_blur(data, (1.0 / scale - 1.0) / 2.0)
    rr = (torch.arange(ny1, dtype=torch.float32, device=data.device) + 0.5) / scale - 0.5
    cc = (torch.arange(nx1, dtype=torch.float32, device=data.device) + 0.5) / scale - 0.5
    R, C = torch.meshgrid(rr, cc, indexing="ij")
    out = map_coordinates(blurred, (R, C), 3, "mirror")
    my, mx = ny1 + ny1 % 2, nx1 + nx1 % 2
    yb, xb = (my - ny1) // 2, (mx - nx1) // 2
    return torch.nn.functional.pad(out, [xb, mx - xb - nx1, yb, my - yb - ny1])


def prepare(image, transpose: int, horizontal: int, device) -> torch.Tensor:
    """The image as float32 on device, transposed where asked (or where
    vertical, for transpose < 0), then horizontalised where asked."""
    data = torch.as_tensor(np.array(image, np.float32), device=device)
    if transpose > 0 or (transpose < 0
                         and bool(data.sum(dim=0).max() > data.sum(dim=1).max())):
        data = data.T.contiguous()
    if horizontal:
        data = horizontalize(data)
    return data
