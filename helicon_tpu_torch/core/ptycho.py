"""4D-STEM ptychography: h5 ingest, parallax defocus and batched ePIE.

Counterpart of ``helicon_tpu/core/ptycho.py``: ``load_h5_file`` :40 (h5py,
imported inside the function), ``electron_wavelength_angstrom`` :100,
``get_probe_size`` :110 and ``_build_probe`` :235 (host numpy, copied),
``_phase_cross_correlation_shift`` :132 and ``estimate_defocus_parallax``
:154 (the correlations in float64 on the data's device, the trimmed
least-squares fit on the host), ``_epie_reconstruct`` :265 (batched ePIE
on the device) and ``reconstruct_ptychography`` :343.

ePIE visits the scan positions in the reference's order (a host
``np.random.default_rng(0)`` shuffle each epoch). The batch's overlapped
object update is summed exactly, in 64-bit fixed point (order-free), so
a run repeats bit for bit on the card, where a float scatter-add adds in
atomic order; the phase step keeps amps * exp(1j * angle(Psi)), which is
finite at Psi = 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensors import on_device

__all__ = [
    "load_h5_file",
    "reconstruct_ptychography",
    "electron_wavelength_angstrom",
    "get_probe_size",
    "estimate_defocus_parallax",
]


def load_h5_file(filepath: str):
    """Load a 4D-STEM dataset (reference ptycho.py:12-52 contract).

    Returns (data, vacuumProbe, AccVoltage_V, SemiConvAngle_mrad,
    R_pixel_A). Prefers the EMPIAR-12236 layout ("data" + "vacuumProbe"
    datasets with the reference attribute names); falls back to the first
    4D dataset found plus generic attribute names (energy [keV],
    convergence semi-angle, pixel_size/apix) with vacuumProbe=None.
    """
    from pathlib import Path

    import h5py

    extension = Path(filepath).suffix.lower()
    if extension != ".h5":
        raise ValueError("only hdf5 (.h5) files are supported")

    with h5py.File(filepath, "r") as f:
        if "data" in f:
            node = f["data"]
            data = np.asarray(node)
            vacuum = np.asarray(f["vacuumProbe"]) if "vacuumProbe" in f else None
            attrs = dict(node.attrs)
            acc_v = float(attrs.get("Acceleration voltage [kV]", 300.0)) * 1e3
            semi = float(attrs.get("Convergence semi-angle [mrad]", 0.0))
            r_pix = float(attrs.get("STEM step-size [A]", 1.0))
            return data, vacuum, acc_v, semi, r_pix

        def find_dataset(node, path=""):
            out = []
            for key, item in node.items():
                p = f"{path}/{key}"
                if isinstance(item, h5py.Dataset) and item.ndim == 4:
                    out.append(p)
                elif isinstance(item, h5py.Group):
                    out.extend(find_dataset(item, p))
            return out

        candidates = find_dataset(f)
        if not candidates:
            raise ValueError(f"{filepath}: no 4D dataset found")
        node = f[candidates[0]]
        data = np.asarray(node)
        # nearest attribute wins: apply root first, dataset last
        chain = []
        n = node
        while n is not None:
            chain.append(n)
            n = n.parent if n.name != "/" else None
        attrs: dict = {}
        for g in reversed(chain):
            attrs.update(dict(g.attrs))
        acc_v = float(attrs.get("energy", attrs.get("E_keV", 300.0))) * 1e3
        semi = float(attrs.get("Convergence semi-angle [mrad]",
                               attrs.get("semiconv_mrad", 0.0)))
        r_pix = float(attrs.get("STEM step-size [A]",
                                attrs.get("pixel_size", attrs.get("apix", 1.0))))
        return data, None, acc_v, semi, r_pix


def electron_wavelength_angstrom(voltage_v: float) -> float:
    """Relativistic electron wavelength (A) at the given voltage (V)."""
    from .ctf import electron_wavelength

    return float(electron_wavelength(voltage_v / 1000.0))


def get_probe_size(dp_mean, thresh: float = 0.5):
    """(radius_px, qx0, qy0) of the bright-field disk in a mean
    diffraction pattern (py4DSTEM get_probe_size semantics: the radius
    where the azimuthal average falls to `thresh` of its peak)."""
    dp = np.asarray(dp_mean, np.float64)
    total = dp.sum()
    if total <= 0:
        raise ValueError("empty diffraction pattern")
    ys, xs = np.indices(dp.shape)
    qx0 = float((ys * dp).sum() / total)
    qy0 = float((xs * dp).sum() / total)
    r = np.hypot(ys - qx0, xs - qy0)
    rbin = r.astype(np.int64)
    prof = np.bincount(rbin.ravel(), weights=dp.ravel()) / np.maximum(
        np.bincount(rbin.ravel()), 1
    )
    level = thresh * prof.max()
    below = np.nonzero(prof < level)[0]
    radius = float(below[0]) if len(below) else float(len(prof) - 1)
    return radius, qx0, qy0


UPSAMPLE = 8  # subpixel resolution 1/UPSAMPLE px via Fourier zero-padding


def _phase_cross_correlation_shifts(a, bs) -> np.ndarray:
    """Integer + 1/UPSAMPLE-pixel shift of a relative to each image of bs
    (n, ny, nx), in float64 on a's device: for b = shift(a, s) it is -s.
    The cross-power spectrum, zero-padded UPSAMPLE-fold about its centre,
    inverted; the first maximum, wrapped. Returns (n, 2) on the host."""
    a = torch.as_tensor(a).to(torch.float64)
    bs = torch.as_tensor(bs).to(device=a.device, dtype=torch.float64)
    Cs = torch.fft.fftshift(torch.fft.fft2(a) * torch.conj(torch.fft.fft2(bs)), dim=(-2, -1))
    n, ny, nx = Cs.shape
    up = UPSAMPLE
    pad = torch.zeros((n, ny * up, nx * up), dtype=torch.complex128, device=a.device)
    y0, x0 = (ny * up - ny) // 2, (nx * up - nx) // 2
    pad[:, y0 : y0 + ny, x0 : x0 + nx] = Cs
    del Cs
    cc = torch.fft.ifft2(torch.fft.ifftshift(pad, dim=(-2, -1))).real
    del pad
    flat = cc.flatten(-2).argmax(dim=-1).cpu().numpy()
    shifts = []
    for f in flat:
        shift = []
        for i, m in zip(np.unravel_index(int(f), (ny * up, nx * up)), (ny * up, nx * up)):
            s = i if i <= m / 2 else i - m
            shift.append(s / up)
        shifts.append(shift)
    return np.asarray(shifts, np.float64).reshape(n, 2)


def _phase_cross_correlation_shift(a, b) -> np.ndarray:
    """Shift of a relative to b (2D): for b = shift(a, s) it is -s."""
    return _phase_cross_correlation_shifts(a, torch.as_tensor(b)[None])[0]


def estimate_defocus_parallax(data, wavelength_a: float, q_pixel_mrad: float, r_pixel_a: float,
                              bf_radius_px: float, center, max_samples: int = 48) -> float:
    """Parallax (tcBF) defocus estimate in Angstroms.

    The virtual bright-field image of the detector pixel at angle theta is
    shifted by -C1 theta (A) against the axial one; up to max_samples
    pixels spread over the inner 0.8 of the disk are correlated with it
    in one batch on the data's device (a (scan, scan, ny, nx) tensor
    keeps its device; an array goes to the CPU), then shift = -C1 theta +
    intercepts is fit by least squares on the host, trimmed up to three
    times of its decorrelated samples.
    """
    data = torch.as_tensor(data)
    sr, sc, ny, nx = data.shape
    cy, cx = center
    ys, xs = np.indices((ny, nx))
    rr = np.hypot(ys - cy, xs - cx)
    inside = (rr < 0.8 * bf_radius_px) & (rr > 0)
    cand = np.argwhere(inside)
    if len(cand) == 0:
        return 0.0
    # deterministic subsample spread over the disk
    step = max(1, len(cand) // max_samples)
    cand = cand[::step][:max_samples]
    ref_img = data[:, :, int(round(cy)), int(round(cx))]
    idx = torch.as_tensor(cand, device=data.device)
    imgs = data[:, :, idx[:, 0], idx[:, 1]].permute(2, 0, 1)  # (n, sr, sc)
    # a constant image (zero standard deviation) carries no shift
    flat = imgs.flatten(1)
    live = ((flat.amax(dim=1) > flat.amin(dim=1))
            & (ref_img.amax() > ref_img.amin())).cpu().numpy()
    if not live.any():
        return 0.0
    cand = cand[live]
    shifts = _phase_cross_correlation_shifts(ref_img, imgs[torch.as_tensor(live, device=data.device)])
    T = (np.asarray(cand, np.float64) - np.asarray([cy, cx], np.float64)) * q_pixel_mrad * 1e-3
    S = shifts * r_pixel_a  # Angstroms

    # shift = -C1 * theta + b_axis. The per-axis intercepts absorb the
    # reference pixel's own nonzero angle and any bright-field-center
    # estimation error; the TRIMMED refit drops decorrelated samples —
    # virtual BF images near the disk edge lose correlation with the
    # axial image and return wrap-around garbage shifts that otherwise
    # dominate the fit (observed: a 0.1 px center shift changing the
    # sample set flipped the fitted C1 sign entirely).
    def fit(T, S):
        n = len(T)
        A = np.zeros((2 * n, 3))
        A[:n, 0] = -T[:, 0]
        A[n:, 0] = -T[:, 1]
        A[:n, 1] = 1.0
        A[n:, 2] = 1.0
        b = np.concatenate([S[:, 0], S[:, 1]])
        sol, *_ = np.linalg.lstsq(A, b, rcond=None)
        resid = A @ sol - b
        per_sample = np.hypot(resid[:n], resid[n:])
        return sol, per_sample

    sol, resid = fit(T, S)
    for _ in range(3):
        if len(T) <= 6:
            break
        keep = resid <= max(2.0 * np.median(resid), 1e-12)
        # always keep at least half (trim at most the worst half)
        if keep.sum() < max(6, len(T) // 2):
            keep = np.argsort(resid)[: max(6, len(T) // 2)]
        T2, S2 = T[keep], S[keep]
        if len(T2) == len(T):
            break
        T, S = T2, S2
        sol, resid = fit(T, S)
    return float(sol[0])


def _build_probe(vacuum_intensity, det_shape, bf_radius_px, center,
                 wavelength_a, q_pixel_mrad, defocus_a):
    """Complex probe array (corner/FFT order) from the vacuum-probe
    intensity (or a hard aperture) plus a defocus aberration phase."""
    ny, nx = det_shape
    if vacuum_intensity is not None:
        amp_c = np.sqrt(np.clip(np.asarray(vacuum_intensity, np.float64), 0, None))
    else:
        ys, xs = np.indices((ny, nx))
        rr = np.hypot(ys - center[0], xs - center[1])
        amp_c = (rr <= bf_radius_px).astype(np.float64)
    # centered -> FFT order, with the pattern center moved to (0, 0)
    amp = np.roll(
        amp_c,
        (-int(round(center[0])), -int(round(center[1]))),
        axis=(0, 1),
    )
    ky = np.fft.fftfreq(ny)[:, None] * ny
    kx = np.fft.fftfreq(nx)[None, :] * nx
    k_a = np.hypot(ky, kx) * (q_pixel_mrad * 1e-3) / wavelength_a  # A^-1
    chi = np.pi * wavelength_a * (k_a**2) * defocus_a
    probe_f = amp * np.exp(1j * chi)
    probe = np.fft.ifft2(probe_f)
    # normalize total intensity to the measured mean pattern scale
    norm = np.sqrt((np.abs(probe) ** 2).sum())
    if norm > 0:
        probe = probe / norm
    return probe.astype(np.complex64)


def _overlap_sum(upd: torch.Tensor, flat: torch.Tensor, n_pix: int) -> torch.Tensor:
    """sum of the complex patches ``upd`` (B, py, px) onto a flat object of
    n_pix pixels at flat indices ``flat`` (B, py, px), exactly: each real
    and imaginary part scaled by one power of two into 64-bit integers
    (B * max|part| below 2^62), added in any order, scaled back. The
    result depends on no order of addition, so the card and the CPU agree
    on the same patches and a run repeats."""
    parts = torch.view_as_real(upd).to(torch.float64)
    _, e = torch.frexp(parts.abs().amax())  # every |part| <= 2^e
    shift = 62 - int(np.ceil(np.log2(upd.shape[0] + 1))) - e
    q = torch.ldexp(parts, shift).round().to(torch.int64)
    acc = torch.zeros((n_pix, 2), dtype=torch.int64, device=upd.device)
    acc.index_add_(0, flat.reshape(-1), q.reshape(-1, 2))
    return torch.view_as_complex(torch.ldexp(acc.to(torch.float64), -shift).to(torch.float32))


def _epie_reconstruct(amplitudes, probe0, positions, obj_shape, num_iter: int,
                      step_size: float, batch_size: int, fix_probe_aperture: bool = True):
    """Batched ePIE on the amplitudes' device. amplitudes (N, py, px) in FFT
    (corner) order; positions (N, 2) integer patch corners; returns
    (object, probe) as complex64 tensors. Each epoch visits the positions
    in the order of a host np.random.default_rng(0) shuffle, batch_size at
    a time; a batch's object update is the overlap average of its patches'
    updates, the probe's the batch mean, and with fix_probe_aperture the
    probe's Fourier amplitude stays the vacuum probe's."""
    amps = torch.as_tensor(amplitudes).to(torch.float32)
    dev = amps.device
    n, py, px = amps.shape
    oy, ox = obj_shape
    alpha = float(np.float32(step_size))
    probe = torch.as_tensor(np.asarray(probe0, np.complex64), device=dev)
    probe_f_amp = torch.abs(torch.fft.fft2(probe))
    pos = torch.as_tensor(np.asarray(positions), dtype=torch.int64, device=dev)
    iy = torch.arange(py, device=dev)
    ix = torch.arange(px, device=dev)
    obj = torch.ones(obj_shape, dtype=torch.complex64, device=dev)

    def batch_step(obj, probe, amps_b, pos_b):
        rows = pos_b[:, 0:1, None] + iy[None, :, None]  # (B, py, 1)
        cols = pos_b[:, 1:2, None] + ix[None, None, :]  # (B, 1, px)
        flat = rows * ox + cols  # (B, py, px)
        patches = obj.reshape(-1)[flat]
        psi = probe[None] * patches
        big_psi = torch.fft.fft2(psi)
        big_psi_new = amps_b * torch.exp(1j * torch.angle(big_psi))
        dpsi = torch.fft.ifft2(big_psi_new) - psi
        p_max = torch.clamp_min(torch.abs(probe).amax() ** 2, 1e-12)
        upd = alpha * torch.conj(probe)[None] / p_max * dpsi
        # overlap-average the batch update (parallel ePIE)
        num = _overlap_sum(upd, flat, oy * ox)
        cnt = torch.zeros(oy * ox, dtype=torch.float32, device=dev)
        cnt.index_add_(0, flat.reshape(-1), torch.ones(flat.numel(), device=dev))
        obj = obj + (num / torch.clamp_min(cnt, 1.0)).reshape(obj_shape)
        o_max = torch.clamp_min(torch.abs(patches).amax() ** 2, 1e-12)
        dprobe = torch.mean(alpha * torch.conj(patches) / o_max * dpsi, dim=0)
        probe = probe + dprobe
        if fix_probe_aperture:
            pf = torch.fft.fft2(probe)
            probe = torch.fft.ifft2(probe_f_amp * torch.exp(1j * torch.angle(pf)))
        return obj, probe

    n_batches = max(1, (n + batch_size - 1) // batch_size)
    order = np.arange(n)
    rng = np.random.default_rng(0)
    for _ in range(num_iter):
        rng.shuffle(order)
        epoch = torch.as_tensor(order, device=dev)
        for b in range(n_batches):
            sl = epoch[b * batch_size : (b + 1) * batch_size]
            if len(sl) == 0:
                continue
            obj, probe = batch_step(obj, probe, amps[sl], pos[sl])
    return obj, probe


def reconstruct_ptychography(
    filepath: str,
    defocus_initial_guess: float = -15000,
    iteration_times: int = 30,
    com_rotation_force: float = 89.8,
    com_transpose_force: bool = False,
    dataset_scan_size: tuple = (128, 128),
    batch_size: int = 256,
    step_size: float = 0.5,
    crop_margin: int = 16,
    num_iter: int = 5,
    device="cuda",
) -> np.ndarray:
    """The object phase (radians, float32, cropped by crop_margin) from a
    4D-STEM h5 file: the parallax defocus estimate on the first 64 scan
    rows, then batched ePIE (num_iter epochs) with the probe built from
    the vacuum probe and that defocus (defocus_initial_guess where the
    estimate is 0 or not finite). The file is read on the host; both
    stages run on ``device`` (the card by default). ``iteration_times``,
    ``dataset_scan_size`` are accepted and unused, as in the reference."""
    from pathlib import Path

    if not (isinstance(filepath, str) and len(filepath) > 0):
        raise ValueError("filepath must be a non-empty string")
    if not Path(filepath).exists():
        raise ValueError(f"File {filepath} does not exist")
    if num_iter <= 0 or step_size <= 0 or batch_size <= 0:
        raise ValueError("num_iter, step_size, batch_size must be positive")

    data, vacuum, acc_voltage, semiconv_mrad, r_pixel_a = load_h5_file(filepath)
    return _reconstruct(
        np.asarray(data, np.float32), vacuum, acc_voltage, semiconv_mrad, r_pixel_a,
        defocus_initial_guess=defocus_initial_guess, com_rotation_force=com_rotation_force,
        com_transpose_force=com_transpose_force, batch_size=batch_size, step_size=step_size,
        crop_margin=crop_margin, num_iter=num_iter, device=device)


def _reconstruct(data, vacuum, acc_voltage, semiconv_mrad, r_pixel_a, defocus_initial_guess,
                 com_rotation_force, com_transpose_force, batch_size, step_size, crop_margin,
                 num_iter, device) -> np.ndarray:
    """reconstruct_ptychography after its loader, on a float32 (scan, scan,
    ny, nx) numpy dataset: the calibration on the host, the parallax and
    ePIE on ``device``."""
    sr, sc, ny, nx = data.shape
    wavelength = electron_wavelength_angstrom(acc_voltage)

    dp_mean = data.mean(axis=(0, 1))
    bf_radius, qx0, qy0 = get_probe_size(dp_mean)
    if semiconv_mrad <= 0:
        semiconv_mrad = 1.0  # undetermined calibration: nominal value
    q_pixel_mrad = semiconv_mrad / max(bf_radius, 1e-6)

    data_dev = on_device(data, device)
    # the parallax defocus estimate on a row-cropped subset (reference
    # ptycho.py:176: data[0:64, :])
    defocus = estimate_defocus_parallax(
        data_dev[: min(64, sr)], wavelength, q_pixel_mrad, r_pixel_a, bf_radius, (qx0, qy0)
    )
    if not np.isfinite(defocus) or defocus == 0.0:
        defocus = float(defocus_initial_guess)

    # real-space sampling of the probe/object grid
    dx = wavelength / (ny * q_pixel_mrad * 1e-3)  # A per object pixel
    step_px = r_pixel_a / dx

    # scan lattice -> object pixels, with the forced R/Q rotation applied
    # to the lattice (the reference rotates Q-space by the same angle)
    theta = np.deg2rad(com_rotation_force)
    ii, jj = np.meshgrid(np.arange(sr), np.arange(sc), indexing="ij")
    if com_transpose_force:
        ii, jj = jj, ii
    ry = step_px * (np.cos(theta) * ii - np.sin(theta) * jj)
    rx = step_px * (np.sin(theta) * ii + np.cos(theta) * jj)
    ry -= ry.min()
    rx -= rx.min()
    pad = 16  # reference object_padding_px=(16, 16)
    positions = np.stack(
        [np.round(ry.ravel()) + pad, np.round(rx.ravel()) + pad], axis=1
    ).astype(np.int32)
    obj_shape = (
        int(positions[:, 0].max()) + ny + pad,
        int(positions[:, 1].max()) + nx + pad,
    )

    probe0 = _build_probe(
        vacuum, (ny, nx), bf_radius, (qx0, qy0), wavelength, q_pixel_mrad, defocus
    )
    # measured amplitudes, centered pattern -> FFT corner order, scaled to
    # the unnormalized-FFT convention (unit-energy probe, |O| ~ 1: the
    # patterns' mean total is ny * nx)
    amps = torch.sqrt(torch.clamp_min(data_dev.reshape(-1, ny, nx), 0))
    del data_dev
    amps = torch.roll(amps, (-int(round(qx0)), -int(round(qy0))), dims=(1, 2))
    scale = float(torch.sqrt((amps**2).sum(dim=(1, 2))).mean())
    amps = (amps.to(torch.float64) * (np.sqrt(ny * nx) / max(scale, 1e-12))).to(torch.float32)

    obj, _ = _epie_reconstruct(
        amps,
        probe0,
        positions,
        obj_shape,
        num_iter=num_iter,
        step_size=step_size,
        batch_size=min(batch_size, len(positions)),
    )
    potential = np.angle(obj.cpu().numpy().astype(np.complex128)).astype(np.float32)
    if crop_margin > 0:
        potential = potential[crop_margin:-crop_margin, crop_margin:-crop_margin]
    return potential
