"""Helical indexing from power spectra: layer lines, Bessel orders and
candidate (twist, rise) tables.

Counterpart of ``helicon_tpu/helix/indexing.py``: ``bessel_first_peak_x``
:43, ``LayerLine``, ``layer_line_profiles`` :84 (the per-row reductions,
on the device of the spectra), ``detect_layer_lines`` :111,
``detect_layer_lines_batch`` :143, ``_detect_from_profiles`` :184 (host
numpy / scipy, copied), ``estimate_bessel_order`` :276,
``_harmonic_support`` :294 and ``estimate_helical_parameters`` :307.
A spectrum stays on its device; only three length-ny vectors an image
(the row strength, its argmax, the meridian's) reach the host, where the
serial peak and selection-rule logic runs in float64 as the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.tensors import on_device

__all__ = [
    "LayerLine",
    "detect_layer_lines",
    "detect_layer_lines_batch",
    "layer_line_profiles",
    "estimate_bessel_order",
    "estimate_helical_parameters",
    "bessel_first_peak_x",
]


def bessel_first_peak_x(n: int) -> float:
    """Position of the first maximum of |J_n(x)| (n >= 0): 0 for J_0, else
    the asymptotic n + 0.8086434 n^(1/3) (2 % off at n = 1, < 1 % from 3)."""
    n = abs(int(n))
    if n == 0:
        return 0.0
    return n + 0.8086434 * n ** (1.0 / 3.0)


@dataclass
class LayerLine:
    """One detected layer line."""

    Z: float  # height, 1/A (absolute value; lines come in +/- pairs)
    intensity: float  # peak power along the line
    r_peak: float  # in-plane frequency (1/A) of the strongest peak
    bessel_order: int | None = None  # estimated |n|, None if no radius given
    meridional: bool = False  # peak on (or adjacent to) the meridian
    candidates: list = field(default_factory=list)


def layer_line_profiles(pwr, *, device="cuda"):
    """Per-row reductions of (a batch of) fftshifted spectra (..., ny, nx),
    on their device: the row maximum outside the meridian core (zeroed),
    its first argmax, and the maximum of where(core, pwr, 0). Returns
    (off_prof, off_argmax, merid_prof), each (..., ny)."""
    pwr = on_device(pwr, device, None)
    nx = pwr.shape[-1]
    cx = nx // 2
    col = torch.arange(nx, device=pwr.device)
    merid = (col >= max(0, cx - 1)) & (col < cx + 2)
    masked = torch.where(merid, 0.0, pwr)
    off_prof, off_argmax = masked.max(dim=-1)
    merid_prof = torch.where(merid, pwr, 0.0).amax(dim=-1)
    return off_prof, off_argmax, merid_prof


def detect_layer_lines(pwr, apix: float, min_prominence: float = 3.0, max_lines: int = 10,
                       radius: float | None = None, *, device="cuda"):
    """Layer lines of one fftshifted (ny, nx) spectrum (meridian along the
    central column, equator along the central row): the rows whose
    strength stands min_prominence MADs above a median background, +/-Z
    pairs merged, meridional lines found apart. With the filament radius
    (A), each line gets a Bessel-order estimate. Returns the LayerLines
    sorted by Z (equator excluded). The reductions run on the spectrum's
    device; the meridian profile is the core's true maximum."""
    pwr = on_device(pwr, device, None)
    ny, nx = pwr.shape
    cx = nx // 2
    masked = pwr.clone()
    masked[:, max(0, cx - 1) : cx + 2] = 0.0
    off_prof, off_argmax = masked.max(dim=1)
    merid_prof = pwr[:, max(0, cx - 1) : cx + 2].amax(dim=1)
    return _detect_from_profiles(
        off_prof.cpu().numpy(), off_argmax.cpu().numpy(), merid_prof.cpu().numpy(), nx, apix,
        min_prominence=min_prominence, max_lines=max_lines, radius=radius,
    )


def detect_layer_lines_batch(pwrs, apix: float, min_prominence: float = 3.0,
                             max_lines: int = 10, radius: float | None = None, device="cuda"):
    """detect_layer_lines of each spectrum of a (B, ny, nx) stack: the
    reductions in one batched call on the stack's device (``device`` for
    an array), one (3, B, ny) float32 array to the host (the argmax is
    exact in float32 below 2^24), the peak logic per image there."""
    pwrs = on_device(pwrs, device)
    off_prof, off_argmax, merid_prof = layer_line_profiles(pwrs)
    packed = torch.stack([off_prof, off_argmax.to(torch.float32), merid_prof]).cpu().numpy()
    off_prof, merid_prof = packed[0], packed[2]
    off_argmax = packed[1].astype(np.int64)
    nx = pwrs.shape[-1]
    return [
        _detect_from_profiles(
            off_prof[i], off_argmax[i], merid_prof[i], nx, apix,
            min_prominence=min_prominence, max_lines=max_lines, radius=radius,
        )
        for i in range(off_prof.shape[0])
    ]
def _detect_from_profiles(
    off_prof,
    off_argmax,
    merid_prof,
    nx: int,
    apix: float,
    min_prominence: float = 3.0,
    max_lines: int = 10,
    radius: float | None = None,
):
    """Shared peak logic on the per-row profiles (see
    :func:`layer_line_profiles` for what each vector carries)."""
    from scipy.ndimage import median_filter
    from scipy.signal import find_peaks

    off_prof = np.asarray(off_prof, np.float64)
    merid_prof = np.asarray(merid_prof, np.float64)
    ny = off_prof.shape[0]
    sy = np.fft.fftshift(np.fft.fftfreq(ny, d=apix))
    sx = np.fft.fftshift(np.fft.fftfreq(nx, d=apix))

    def _peak_rows(prof):
        bg = median_filter(prof, size=max(5, ny // 16))
        resid = prof - bg
        mad = np.median(np.abs(resid - np.median(resid))) * 1.4826 + 1e-12
        peaks, _ = find_peaks(resid, height=min_prominence * mad)
        # merge +/-Z pairs: keep the stronger of each pair
        by_absz: dict[float, tuple[int, float]] = {}
        for p in peaks:
            Z = abs(float(sy[p]))
            if Z <= 1e-9:
                continue
            key = round(Z, 6)
            if key not in by_absz or prof[p] > by_absz[key][1]:
                by_absz[key] = (p, float(prof[p]))
        return by_absz

    # two independent detections: the meridian column (n = 0 lines: the
    # rise family) carries the shape-transform streak of the finite
    # filament, which would contaminate a single joint peak search.
    off = _peak_rows(off_prof)
    on = _peak_rows(merid_prof)

    lines = []
    off_px = {}  # row -> off-meridian argmax, reused by the ghost filter
    for key, (p, inten) in sorted(off.items()):
        px = int(off_argmax[p])
        off_px[p] = px
        r_peak = abs(float(sx[px]))
        n_est = None
        if radius is not None and radius > 0:
            n_est = estimate_bessel_order(r_peak, radius)
        lines.append(
            LayerLine(
                Z=key, intensity=inten, r_peak=r_peak,
                bessel_order=n_est, meridional=False,
            )
        )
    dZ = abs(float(sy[1] - sy[0])) if ny > 1 else 1.0
    df = abs(float(sx[1] - sx[0])) if nx > 1 else 1.0
    # a low-|n| line peaking closer to the meridian than this is likely a
    # streak ghost; a true n = 0 line's first J0 sidelobe sits at
    # x = 3.83, well beyond the n = 1 peak at x = 1.84
    if radius is not None and radius > 0:
        r_ghost = 0.5 * (1.84 + 3.83) / (2.0 * math.pi * radius)
    else:
        r_ghost = 4.0 * df
    ghost_Z = {
        k for k, (p, _) in off.items()
        if 0 < abs(float(sx[off_px[p]])) < r_ghost
    }
    for key, (p, inten) in sorted(on.items()):
        # a meridional line must beat the off-meridian peak on its row
        if merid_prof[p] <= off_prof[p]:
            continue
        # drop streak ghosts: an "on-meridian" peak coincident with a
        # NEAR-meridian off line is that line's tail riding the
        # finite-length shape-transform streak, not an n = 0 line
        if any(abs(key - k) <= 1.5 * dZ for k in ghost_Z):
            continue
        lines.append(
            LayerLine(
                Z=key, intensity=inten, r_peak=0.0,
                bessel_order=0 if radius else None, meridional=True,
            )
        )
    lines.sort(key=lambda l: -l.intensity)
    lines = lines[:max_lines]
    lines.sort(key=lambda l: l.Z)
    return lines


def estimate_bessel_order(r_peak: float, radius: float) -> int:
    """|n| whose first |J_n| maximum sits nearest to x = 2 pi R r_peak."""
    x = 2.0 * math.pi * radius * r_peak
    best, best_err = 0, abs(x - bessel_first_peak_x(0))
    n = 1
    while True:
        err = abs(x - bessel_first_peak_x(n))
        if err < best_err:
            best, best_err = n, err
        # first-peak positions are increasing in n; stop once past x
        if bessel_first_peak_x(n) > x and n > best + 2:
            break
        n += 1
        if n > 200:
            break
    return best


def _harmonic_support(pitch, lines, exclude=None):
    """Summed intensity of detected lines sitting near an integer
    harmonic k = Z * pitch of the candidate pitch. round(k) >= 1: the
    0th harmonic is the equator, so a low-frequency line near k ~ 0 is
    NOT harmonic support."""
    support = 0.0
    for q in lines:
        k = q.Z * pitch
        if q is not exclude and round(k) >= 1 and abs(k - round(k)) < 0.15:
            support += q.intensity
    return support




def estimate_helical_parameters(
    image=None,
    apix: float = 1.0,
    diameter: float | None = None,
    pwr=None,
    csym: int = 1,
    min_prominence: float = 3.0,
    max_lines: int = 10,
    rise_range: tuple[float, float] = (1.5, 200.0),
    radius_factor: float = 0.75,
    device="cuda",
):
    """Candidate (twist, rise) table from layer lines of one 2D image.

    Either `image` (real-space class average / segment with the filament
    axis VERTICAL, the HILL display convention — transpose a
    denovo3D-convention horizontal-axis image first) or a precomputed
    fftshifted `pwr` spectrum must be given. diameter (Angstrom) enables
    Bessel-order estimation (radius = diameter / 2 * 0.75, the
    peak-density radius heuristic).

    Uses the helical selection rule Z = n/P + m/rise:
    - a meridional line (n = 0, m = 1) fixes rise = 1 / Z,
    - the lowest non-meridional line with |n| = 1 (or the lowest line
      when orders are unknown) fixes pitch P = 1 / Z, twist =
      360 * rise / P.

    Returns dict(layer_lines=[LayerLine...], candidates=[{twist, rise,
    pitch, csym, Z_pitch, Z_rise}...]) sorted by decreasing line
    intensity support. Candidates are empty if fewer than one usable
    line is found.

    The spectrum is computed and reduced on the image's device (a tensor
    keeps its own; an array goes to ``device``, the card by default).
    """
    if pwr is None:
        if image is None:
            raise ValueError("either image or pwr is required")
        from ..core.transforms import compute_power_spectra

        pwr, _ = compute_power_spectra(on_device(image, device), apix=apix)
    else:
        pwr = on_device(pwr, device, torch.float64)
    # the scattering-mass radius is typically inside the envelope
    # diameter; radius_factor=1.0 when the density sits at diameter/2
    radius = None if diameter is None else radius_factor * diameter / 2.0
    lines = detect_layer_lines(
        pwr, apix, min_prominence=min_prominence, max_lines=max_lines,
        radius=radius,
    )
    candidates = []
    merid = [l for l in lines if l.meridional or l.bessel_order == 0]
    non_merid = [l for l in lines if not (l.meridional or l.bessel_order == 0)]

    # pitch from the lowest non-meridional line; its Bessel order n means
    # the line sits at n / P (near-equatorial lines of an n-start family)
    pitch_lines = sorted(non_merid, key=lambda l: l.Z)
    pitches = []
    for p in pitch_lines[:3]:
        n = p.bessel_order if p.bessel_order else 1
        pitch = n / p.Z
        support = p.intensity + _harmonic_support(pitch, non_merid, exclude=p)
        pitches.append((pitch, p, support))

    # rise from the lowest meridional (n = 0, m = 1) line
    rises = []
    for m in sorted(merid, key=lambda l: l.Z):
        rise = 1.0 / m.Z
        if rise_range[0] <= rise <= rise_range[1]:
            rises.append((rise, m))

    for pitch, pline, psupport in pitches:
        if rises:
            for rise, mline in rises:
                twist = 360.0 * rise / pitch
                # rise ~ pitch means the "rise" line was the pitch
                # family's own streak: degenerate, not a real candidate
                if twist >= 355.0:
                    continue
                # the power spectrum cannot resolve the twist sign /
                # rotation direction: fold into (0, 180] (RELION
                # convention; the grid search decides handedness)
                if twist > 180.0:
                    twist = 360.0 - twist
                candidates.append(
                    dict(
                        twist=twist,
                        rise=rise,
                        pitch=pitch,
                        csym=csym,
                        Z_rise=mline.Z,
                        Z_pitch=pline.Z,
                        support=psupport + mline.intensity,
                    )
                )
        else:
            # rise line not resolved (damped beyond the signal envelope):
            # report the pitch; twist/rise need an external rise estimate
            candidates.append(
                dict(
                    twist=math.nan,
                    rise=math.nan,
                    pitch=pitch,
                    csym=csym,
                    Z_rise=math.nan,
                    Z_pitch=pline.Z,
                    support=psupport,
                )
            )
    if not pitches:
        for rise, mline in rises:
            # only the rise family was detected: the twist is UNRESOLVED
            # (NaN, like the mirrored pitch-only branch) — reporting 0.0
            # here would present an unmeasured twist as a definite value
            candidates.append(
                dict(
                    twist=math.nan, rise=rise, pitch=math.nan, csym=csym,
                    Z_rise=mline.Z, Z_pitch=math.nan,
                    support=mline.intensity,
                )
            )
    candidates.sort(key=lambda c: -c["support"])
    return dict(layer_lines=lines, candidates=candidates)
