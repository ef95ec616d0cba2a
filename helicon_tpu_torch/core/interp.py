"""N-d interpolation on tensors: ``map_coordinates`` of order 1 and 3.

Counterpart of ``helicon_tpu/core/interp.py`` for the orders and modes the
denovo3d prep chain uses: order 1 (bilinear rotation in the helix
estimator) and order 3 (cubic B-spline down-scaling, with the recursive
prefilter of pole sqrt(3) - 2). The scipy conventions are the same.
The prefilter's recursion is a Python loop over the filtered axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["spline_filter1d", "spline_filter", "map_coordinates"]

_CUBIC_POLE = math.sqrt(3.0) - 2.0
_MODES = ("constant", "mirror")


def _mirror_index(idx, n: int):
    """Reflect indices into [0, n-1] about the end samples (scipy
    'mirror': no repeated edge sample)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.abs(idx) % period
    return torch.where(idx >= n, period - idx, idx)


def _fix_index(mode: str, idx, n: int):
    """(index inside [0, n-1], in-bounds flag) for one axis."""
    if mode == "mirror":
        return _mirror_index(idx, n), torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx <= n - 1)


def spline_filter1d(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Cubic B-spline prefilter along one axis (mirror boundary), as
    scipy.ndimage.spline_filter1d(order=3, mode='mirror')."""
    z = _CUBIC_POLE
    axis = axis % x.ndim
    n = x.shape[axis]
    if n == 1:
        return x
    x = torch.movedim(x, axis, 0)
    gain = (1.0 - z) * (1.0 - 1.0 / z)
    y = x * gain

    # causal init (mirror): c0 = y0 + sum_{k>=1} y_k z^k over a horizon
    horizon = min(n, int(np.ceil(np.log(1e-8) / np.log(abs(z)))) + 1)
    powers = torch.as_tensor(
        (z ** np.arange(horizon)).astype(np.float32), device=x.device
    ).to(x.dtype)
    c = torch.tensordot(powers, y[:horizon], dims=([0], [0]))
    cp = [c]
    for i in range(1, n):
        c = y[i] + z * c
        cp.append(c)

    # anticausal init (mirror): c_minus[n-1] = z/(z^2-1) * (cp[n-1] + z cp[n-2])
    c = (z / (z * z - 1.0)) * (cp[n - 1] + z * cp[n - 2])
    out = [c]
    for i in range(n - 2, -1, -1):
        c = z * (c - cp[i])
        out.append(c)
    return torch.movedim(torch.stack(out[::-1]), 0, axis)


def spline_filter(x: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline prefilter along every axis."""
    for ax in range(x.ndim):
        x = spline_filter1d(x, axis=ax)
    return x


def _cubic_weights(t):
    """B-spline basis values at offsets (-1, 0, 1, 2) for fraction t in [0,1)."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return (w0, w1, w2, w3)


def map_coordinates(
    input: torch.Tensor,
    coordinates,
    order: int = 1,
    mode: str = "constant",
    cval: float = 0.0,
    prefilter: bool = True,
) -> torch.Tensor:
    """Evaluate a float *input* at fractional *coordinates* (scipy
    convention; one coordinate array per input axis).

    order 1 or 3; mode "constant" (points outside [0, n-1] on any axis
    return cval) or "mirror".
    """
    if order not in (1, 3):
        raise NotImplementedError(f"map_coordinates order={order} (port has 1 and 3)")
    if mode not in _MODES:
        raise NotImplementedError(f"map_coordinates mode={mode!r} (port has {_MODES})")
    x = torch.as_tensor(input)
    coords = [torch.as_tensor(c, dtype=torch.float32, device=x.device) for c in coordinates]
    if len(coords) != x.ndim:
        raise ValueError("need one coordinate array per input dim")
    out_shape = torch.broadcast_shapes(*(c.shape for c in coords))
    coords = [c.expand(out_shape) for c in coords]

    in_domain = torch.ones(out_shape, dtype=torch.bool, device=x.device)
    if mode == "constant":
        for d, c in enumerate(coords):
            in_domain &= (c >= 0) & (c <= x.shape[d] - 1)

    floors = [torch.floor(c) for c in coords]
    lo = [f.to(torch.int64) for f in floors]
    frac = [c - f for c, f in zip(coords, floors)]
    out = torch.zeros(out_shape, dtype=torch.float32, device=x.device)
    if order == 1:
        for corner in range(2**x.ndim):
            w = torch.ones(out_shape, dtype=torch.float32, device=x.device)
            idxs = []
            valid = torch.ones(out_shape, dtype=torch.bool, device=x.device)
            for d in range(x.ndim):
                hi = (corner >> d) & 1
                w = w * (frac[d] if hi else (1.0 - frac[d]))
                i, ok = _fix_index(mode, lo[d] + hi, x.shape[d])
                idxs.append(i)
                valid &= ok
            vals = x[tuple(idxs)]
            if mode == "constant":
                vals = torch.where(valid, vals, float(cval))
            out = out + vals.to(out.dtype) * w
    else:
        # scipy's 'constant' mode mirror-extends the spline coefficients
        # for window samples that cross the edge; cval applies only to
        # points whose coordinate is out of domain (in_domain below)
        cx = spline_filter(x) if prefilter else x
        wts = [_cubic_weights(f) for f in frac]
        for corner in range(4**x.ndim):
            w = torch.ones(out_shape, dtype=torch.float32, device=x.device)
            idxs = []
            rem = corner
            for d in range(x.ndim):
                o = rem % 4
                rem //= 4
                w = w * wts[d][o]
                i, _ = _fix_index("mirror", lo[d] + (o - 1), x.shape[d])
                idxs.append(i)
            out = out + cx[tuple(idxs)].to(out.dtype) * w
    if mode == "constant":
        out = torch.where(in_domain, out, float(cval))
    return out.to(x.dtype)
