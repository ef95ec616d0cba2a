"""Analytic contrast transfer function (CTF) and helical layer-line math.

Counterpart of ``helicon_tpu/core/ctf.py``: ``electron_wavelength`` :36,
``ctf_1d`` :48 and ``ctf_2d`` :100 (float32 on tensors; ``ctf_2d`` in
fftfreq layout, a stack of defoci in one call where the reference vmaps),
and the host layer-line functions ``layer_line_positions`` :127,
``layer_line_bessel_orders`` :166 and ``simulate_helix_power_spectrum``
:189 (numpy and scipy's ``jv``, copied).

CTF(s) = -(sqrt(1 - w^2) sin(gamma) + w cos(gamma)) exp(-B s^2 / 4),
gamma = pi lam s^2 (df - lam^2 s^2 cs / 2) + phase; positive defocus is
underfocus.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.tensors import on_device

__all__ = [
    "ctf_1d",
    "ctf_2d",
    "electron_wavelength",
    "layer_line_positions",
    "layer_line_bessel_orders",
    "simulate_helix_power_spectrum",
]


def electron_wavelength(voltage_kv) -> float:
    """Relativistic electron wavelength in Angstroms."""
    h = 6.62607015e-34
    m_e = 9.1093837e-31
    e = 1.602176634e-19
    c = 299792458
    V = np.asarray(voltage_kv, dtype=float) * 1000.0
    lam = h / np.sqrt(2 * m_e * e * V * (1 + e * V / (2 * m_e * c**2)))
    return lam * 1e10


def _f32(v) -> float:
    return float(np.float32(v))


def ctf_1d(s, defocus_um: float = 1.0, voltage_kv: float = 300.0, cs_mm: float = 2.7,
           amp_contrast: float = 0.07, phase_shift_deg: float = 0.0,
           bfactor: float = 0.0, *, device="cuda") -> torch.Tensor:
    """CTF at spatial frequencies s (1/A), float32 on s's device (numpy
    on ``device``). The
    constants combine in float64 and round to float32 where the
    reference's Python scalars meet its float32 arrays."""
    s = on_device(s, device)
    lam = float(electron_wavelength(voltage_kv))
    df = defocus_um * 1e4  # A
    cs = cs_mm * 1e7  # A
    s2 = s * s
    phase = _f32(np.deg2rad(np.float32(phase_shift_deg)))
    gamma = math.pi * lam * s2 * (df - 0.5 * lam * lam * s2 * cs) + phase
    w = amp_contrast
    ctf = -(_f32(np.sqrt(np.float32(1 - w * w))) * torch.sin(gamma) + w * torch.cos(gamma))
    if bfactor:
        ctf = ctf * torch.exp(-bfactor * s2 / 4)
    return ctf


def ctf_2d(shape, apix: float, defocus_u_A=10000.0, defocus_v_A=10000.0,
           astig_angle_deg=0.0, voltage_kv: float = 300.0, cs_mm: float = 2.7,
           amp_contrast: float = 0.07, phase_shift_deg: float = 0.0, bfactor: float = 0.0,
           device="cuda") -> torch.Tensor:
    """2D CTF (ny, nx) in fftfreq layout, float32 on ``device`` (the card
    unless the caller asks for the CPU). The defoci and the astigmatism angle may be 1D sequences
    of one length: then a (n, ny, nx) stack, one CTF per entry (the
    reference vmaps over them)."""
    dev = torch.device(device)
    ny, nx = (int(v) for v in shape)
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.as_tensor(np.asarray(defocus_u_A, np.float32), device=dev)
    dv = torch.as_tensor(np.asarray(defocus_v_A, np.float32), device=dev)
    astig = torch.as_tensor(np.deg2rad(np.asarray(astig_angle_deg, np.float32)), device=dev)
    stack = max(du.ndim, dv.ndim, astig.ndim) == 1
    du, dv, astig = (t.reshape(-1, 1, 1) for t in (du, dv, astig))
    apix32 = np.float32(apix)

    def fftfreq(n):  # jnp.fft.fftfreq(n, d=apix) in float32
        i = torch.arange(n, **f32)
        k = torch.remainder(i + n // 2, n) - n // 2
        return k / _f32(apix32 * np.float32(n))

    fy = fftfreq(ny)[:, None]
    fx = fftfreq(nx)[None, :]
    s2 = fx * fx + fy * fy
    ang = torch.atan2(fy, fx)
    lam = np.float32(electron_wavelength(voltage_kv))
    cs = np.float32(cs_mm * 1e7)
    df = 0.5 * (du + dv + (du - dv) * torch.cos(2 * (ang - astig)))
    gamma = (_f32(np.float32(np.pi) * lam) * s2 * (df - _f32(np.float32(0.5) * lam * lam) * s2
                                                    * float(cs))
             + _f32(np.deg2rad(np.float32(phase_shift_deg))))
    w = np.float32(amp_contrast)
    ctf = -(_f32(np.sqrt(np.float32(1) - w * w)) * torch.sin(gamma) + float(w) * torch.cos(gamma))
    out = ctf * torch.exp(-_f32(bfactor) * s2 / 4)
    return out if stack else out[0]
def layer_line_positions(twist: float, rise: float, csym: int = 1, n_lines: int = 10):
    """Layer-line heights Z (1/A) and their (l, n) selection-rule indices.

    Helical diffraction: with pitch P = 360/|twist| * rise, the layer
    line of Bessel order n from the m-start family sits at
    Z = n / P + m / rise (selection rule for a 1-start helix); csym
    restricts allowed n to multiples of csym.
    Returns list of (Z, n, m) sorted by Z, the n_lines smallest Z > 0
    plus the equator (0, 0, 0).
    """
    twist_eff = abs(twist)
    if twist_eff < 1e-6:
        P = math.inf
    else:
        P = 360.0 / twist_eff * rise
    # collect EVERY allowed (n, m) per height, then keep the DOMINANT
    # (lowest |n|) representative per line: the first-visible peak of a
    # layer line is |J_n| of its smallest allowed order, not whichever
    # (n, m) combination a scan order happens to find first
    by_z: dict = {0.0: [(0, 0)]}
    max_n = n_lines * max(1, csym) + csym
    max_m = n_lines + 1
    for m in range(-max_m, max_m + 1):
        for n in range(-max_n, max_n + 1):
            if csym > 1 and n % csym != 0:
                continue
            Z = (n / P if math.isfinite(P) else 0.0) + m / rise
            if Z <= 1e-9:
                continue
            by_z.setdefault(round(Z, 8), []).append((n, m))
    lines = []
    for Zr, nms in by_z.items():
        nms.sort(key=lambda t: (abs(t[0]), abs(t[1])))
        n, m = nms[0]
        lines.append((float(Zr), n, m))
    lines.sort(key=lambda t: t[0])
    return lines[: n_lines + 1]


def layer_line_bessel_orders(twist: float, rise: float, csym: int = 1, n_lines: int = 10):
    """{Z: [n, ...]} ALL allowed Bessel orders per layer-line height,
    sorted by |n| (the line's dominant order first)."""
    kept = {
        round(Z, 8) for Z, _, _ in layer_line_positions(twist, rise, csym, n_lines)
    }
    twist_eff = abs(twist)
    P = math.inf if twist_eff < 1e-6 else 360.0 / twist_eff * rise
    out: dict = {z: [] for z in kept}
    max_n = n_lines * max(1, csym) + csym
    max_m = n_lines + 1
    for m in range(-max_m, max_m + 1):
        for n in range(-max_n, max_n + 1):
            if csym > 1 and n % csym != 0:
                continue
            Z = round((n / P if math.isfinite(P) else 0.0) + m / rise, 8)
            if Z in out and n not in out[Z]:
                out[Z].append(n)
    for z in out:
        out[z].sort(key=abs)
    return out


def simulate_helix_power_spectrum(
    shape,
    apix: float,
    twist: float,
    rise: float,
    csym: int = 1,
    radius: float = 50.0,
    n_lines: int = 10,
):
    """Schematic layer-line power spectrum (hill-style display): each
    allowed line drawn as |J_n(2 pi R r)|^2 along X at height Z."""
    from scipy.special import jv

    ny, nx = shape
    img = np.zeros((ny, nx), np.float32)
    sx = np.fft.fftshift(np.fft.fftfreq(nx, d=apix))
    sy = np.fft.fftshift(np.fft.fftfreq(ny, d=apix))
    for Z, n, m in layer_line_positions(twist, rise, csym, n_lines):
        for zsign in (1, -1) if Z > 0 else (1,):
            iy = np.argmin(np.abs(sy - zsign * Z))
            amp = jv(abs(n), 2 * np.pi * np.abs(sx) * radius) ** 2
            img[iy] = np.maximum(img[iy], amp.astype(np.float32))
    return img
