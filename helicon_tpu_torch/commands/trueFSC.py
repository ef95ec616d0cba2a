"""Compute true FSC from two half maps with mask-correlation removal

FSCtrue = (FSCt - FSCn) / (1 - FSCn) beyond the phase-randomization
cutoff, with EMAN2-style adaptive seed-and-grow masking and optional
soft-edge-width optimization.

The port's counterpart of ``helicon_tpu/commands/trueFSC.py``. Both half
maps, their phase-randomized versions and the masks stay on --device (the
card by default); the FSC shells are binned there and only the curves
cross to the host, where the reference's host arithmetic (the curve fits,
the resolutions, the soft-edge search) runs as it does there.

Example:
  python -m helicon_tpu_torch.commands.trueFSC half1.mrc half2.mrc fsc.pdf
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..utils.exceptions import HeliconError

logger = logging.getLogger(__name__)


def main(args):
    from ..utils.logging import log_command_line

    log_command_line()
    with log_to(args):
        out = run(args)
        plot_fsc(out["curves"], args.plotFile, sections=out["sections"])
        logger.info("Saved FSC plot: %s", args.plotFile)
        if args.showPlot:
            _show_plot(args.plotFile)
    print(f"trueFSC resolution at FSC=0.143: {out['res_true']:.2f} A")


@contextlib.contextmanager
def log_to(args):
    """The command's log: the console at --verbose's level and
    <plotFile stem>.log at DEBUG, for the duration of the block."""
    log_file = os.path.splitext(args.plotFile)[0] + ".log"
    fh = logging.FileHandler(log_file, mode="w")
    ch = logging.StreamHandler()
    ch.setLevel(
        logging.CRITICAL
        if args.verbose <= 0
        else logging.INFO if args.verbose == 1 else logging.DEBUG
    )
    for h in (ch, fh):
        h.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.DEBUG)
    try:
        yield
    finally:
        for h in (ch, fh):
            logger.removeHandler(h)
            h.close()


def run(args) -> dict:
    """Everything main does up to the plot: the five curves, the masks and
    the log lines. Returns the curves to plot, the central sections' maps,
    and the true FSC's 0.143 resolution."""
    from ..core.analysis import _shell_labels_3d, calc_fsc, calc_fsc_per_shell
    from ..core.filters import randomize_phases_lowpass
    from ..io.mrc import read_mrc, write_mrc
    from . import command_device

    logger.info(" ".join(sys.argv))
    logger.info("Started at %s", datetime.now())

    device = command_device(args.device)
    for f in (args.map1, args.map2):
        if not Path(f).exists():
            raise HeliconError(f"map not found: {f}")
    map1, apix1 = read_mrc(args.map1)
    map2, apix2 = read_mrc(args.map2)
    if map1.shape != map2.shape:
        raise HeliconError(f"maps must match: {map1.shape} != {map2.shape}")
    map1 = torch.as_tensor(np.asarray(map1, np.float64), device=device)
    map2 = torch.as_tensor(np.asarray(map2, np.float64), device=device)
    if args.apix > 0:
        apix = args.apix
    elif abs(apix1 - apix2) < 1e-6:
        apix = apix1
    else:
        raise HeliconError(f"pixel sizes differ: {apix1} != {apix2}; use --apix")
    logger.info("Sampling: %g A/pixel; map %s", apix, tuple(map1.shape))

    fsc_prefix = os.path.splitext(args.plotFile)[0]
    n = map1.shape[0]
    shell = _shell_labels_3d(n, device)

    logger.info("Calculating FSC of original maps")
    fsc_result = calc_fsc(map1, map2, apix, shell_flat=shell, n=n)
    saxis = fsc_result[:, 0]
    fsc_unmasked = fsc_result[:, 1]
    res_unmasked = _find_resolution(saxis, fsc_unmasked, 0.143)
    logger.info("Resolution at FSC=0.143 (unmasked): %.2f A", res_unmasked)

    if args.cutoffRes > 2:
        cutoffRes = args.cutoffRes
    else:
        cutoffRes = _find_resolution(saxis, fsc_unmasked, 0.8)
        if cutoffRes > 100:
            s_fit, f_fit, _ = _fit_fsc_curve(saxis, fsc_unmasked)
            cutoffRes = _find_resolution(s_fit, f_fit, 0.8)
        if cutoffRes > 10:
            cutoffRes = round(cutoffRes)
        elif cutoffRes > 5:
            cutoffRes = round(cutoffRes * 2) / 2
        else:
            cutoffRes = round(cutoffRes * 4) / 4
    logger.info("Cutoff resolution for phase randomization: %.2f A", cutoffRes)

    F1r = randomize_phases_lowpass(map1, apix, cutoffRes, return_fft=True)
    F2r = randomize_phases_lowpass(map2, apix, cutoffRes, return_fft=True)
    cutoffRes_i = int(n * apix / cutoffRes)
    np.savetxt(
        fsc_prefix + ".unmasked.txt",
        np.column_stack([saxis[1:], fsc_unmasked[1:]]),
    )

    # FSC of the phase-randomized, unmasked maps
    fsc_rand_unmasked = calc_fsc(None, None, apix, F1=F1r, F2=F2r, shell_flat=shell, n=n)
    np.savetxt(
        fsc_prefix + ".randomized-unmasked.txt",
        np.column_stack([fsc_rand_unmasked[1:, 0], fsc_rand_unmasked[1:, 1]]),
    )

    # masks
    user_mask = len(args.maskFile) > 0
    if user_mask:
        masks = [torch.as_tensor(np.asarray(read_mrc(f)[0], np.float64), device=device)
                 for f in args.maskFile]
        mask1 = masks[0]
        mask2 = masks[1] if len(masks) == 2 else masks[0]
        if args.oneMask and len(masks) == 2:
            mask1 = mask2 = (masks[0] + masks[1]) / 2
    elif args.oneMask:
        mask1 = mask2 = _generate_adaptive_mask(
            (map1 + map2) / 2, apix, cutoffRes, args
        )
    else:
        mask1 = _generate_adaptive_mask(map1, apix, cutoffRes, args)
        mask2 = _generate_adaptive_mask(map2, apix, cutoffRes, args)

    map1r = torch.fft.irfftn(F1r, s=map1.shape)
    map2r = torch.fft.irfftn(F2r, s=map2.shape)
    del F1r, F2r

    if not user_mask:
        if args.maskSoft > 0:
            mask_soft_px = args.maskSoft / apix
        elif args.refineMask:
            from scipy.optimize import minimize_scalar

            logger.info("Searching for optimal mask slope width")

            def _fsc_score(x):
                mask_e = _soft_mask(mask1, x)
                fsc_t = calc_fsc_per_shell(map1 * mask_e, map2 * mask_e, apix)
                fsc_nn = calc_fsc_per_shell(map1r * mask_e, map2r * mask_e, apix)
                ci = cutoffRes_i + 2
                t, nn = fsc_t[ci:], fsc_nn[ci:]
                with np.errstate(invalid="ignore", divide="ignore"):
                    tr = (t - nn) / (1 - nn)
                tr[np.isnan(tr)] = 1.0
                return (
                    np.mean(1 - np.abs(tr))
                    + np.mean(np.abs(nn))
                    + np.mean(np.abs(t - tr))
                    + np.mean(1 - np.abs(tr - nn))
                )

            res_opt = minimize_scalar(
                _fsc_score, bounds=(0, n / 3), method="bounded",
                options={"xatol": 2},
            )
            mask_soft_px = res_opt.x
            logger.info("Optimal mask slope width: %.1f px", mask_soft_px)
        else:
            mask_soft_px = 3 * res_unmasked / apix
        mask1 = _soft_mask(mask1, mask_soft_px)
        mask2 = _soft_mask(mask2, mask_soft_px)
        maskdir = os.path.dirname(args.plotFile) or "."
        b1, b2 = Path(args.map1).stem, Path(args.map2).stem
        if args.oneMask:
            write_mrc(
                os.path.join(maskdir, f"{b1}_{b2}.common_mask.mrc"),
                _host32(mask1), apix=apix,
            )
        else:
            write_mrc(os.path.join(maskdir, f"{b1}.mask.mrc"), _host32(mask1), apix=apix)
            write_mrc(os.path.join(maskdir, f"{b2}.mask.mrc"), _host32(mask2), apix=apix)

    m1, m2 = map1 * mask1, map2 * mask2
    m1r, m2r = map1r * mask1, map2r * mask2
    del map1r, map2r

    logger.info("Calculating FSC of masked maps (gold FSC)")
    r = calc_fsc(m1, m2, apix, shell_flat=shell, n=n)
    saxis_m, fsc_t = r[:, 0], r[:, 1]
    res_masked = _find_resolution(saxis_m, fsc_t, 0.143)
    logger.info("Resolution at FSC=0.143 (masked): %.2f A", res_masked)
    np.savetxt(fsc_prefix + ".masked.txt", np.column_stack([saxis_m[1:], fsc_t[1:]]))

    r = calc_fsc(m1r, m2r, apix, shell_flat=shell, n=n)
    fsc_n = r[:, 1]
    np.savetxt(
        fsc_prefix + ".randomized-masked.txt",
        np.column_stack([saxis_m[1:], fsc_n[1:]]),
    )

    fsc_true = np.copy(fsc_t)
    with np.errstate(invalid="ignore", divide="ignore"):
        fsc_true[cutoffRes_i + 1 :] = (
            fsc_t[cutoffRes_i + 1 :] - fsc_n[cutoffRes_i + 1 :]
        ) / (1 - fsc_n[cutoffRes_i + 1 :])
    fsc_true[np.isnan(fsc_true)] = 1.0
    np.savetxt(fsc_prefix + ".true.txt", np.column_stack([saxis_m[1:], fsc_true[1:]]))

    s_fit, f_fit, _ = _fit_fsc_curve(saxis_m, fsc_true)
    res_true = _find_resolution(saxis_m, fsc_true, 0.143)
    res_true_fit = _find_resolution(s_fit, f_fit, 0.143)
    logger.info(
        "Resolution at FSC=0.143 (true): %.2f A (fit: %.2f A)",
        res_true, res_true_fit,
    )
    np.savetxt(fsc_prefix + ".true.fit.txt", np.column_stack([s_fit, f_fit]))

    curves = [
        (saxis[1:], fsc_unmasked[1:], f"unmasked ({res_unmasked:.2f} A)"),
        (saxis_m[1:], fsc_t[1:], f"masked ({res_masked:.2f} A)"),
        (saxis_m[1:], fsc_n[1:], "noise-substituted"),
        (saxis_m[1:], fsc_true[1:], f"corrected ({res_true:.2f} A)"),
    ]
    sections = [("Map 1", _central(map1), _central(m1)), ("Map 2", _central(map2), _central(m2))]
    return dict(curves=curves, sections=sections, res_true=res_true, cutoff_res=cutoffRes)


def _host32(t) -> np.ndarray:
    return t.to(torch.float32).cpu().numpy()


def _central(vol) -> np.ndarray:
    """The central z-section of a map, on the host (all the plot shows)."""
    return vol[vol.shape[0] // 2].cpu().numpy()


def _show_plot(plot_file) -> None:
    """Open the saved plot in a viewer: argv list, shell=False, fire and
    forget."""
    import subprocess

    if str(plot_file).lower().endswith(".pdf"):
        viewers = ["evince", "okular", "zathura", "xpdf", "open"]
    else:
        viewers = ["xdg-open", "open"]
    for viewer in viewers:
        try:
            subprocess.Popen([viewer, str(plot_file)])
            logger.info("Opening %s...", plot_file)
            break
        except FileNotFoundError:
            continue
    else:
        logger.warning("No viewer found; open %s manually", plot_file)


def _find_resolution(saxis, fsc, threshold):
    """First crossing of the threshold, linearly interpolated; 999 when
    never crossed."""
    fsc = np.asarray(fsc)
    saxis = np.asarray(saxis)
    idx = np.where(fsc < threshold)[0]
    if len(idx) == 0:
        return 999.0
    i = idx[0]
    if i == 0:
        return 1.0 / saxis[0] if saxis[0] > 0 else 999.0
    x0, x1, y0, y1 = saxis[i - 1], saxis[i], fsc[i - 1], fsc[i]
    cross = x1 if y0 == y1 else x0 + (threshold - y0) * (x1 - x0) / (y1 - y0)
    return 1.0 / cross if cross > 0 else 999.0


def _fit_fsc_curve(saxis, fsc):
    """Fermi / Butterworth model fit of an FSC curve, the better of the two
    by mean absolute error (host)."""
    from scipy.optimize import minimize

    saxis = np.asarray(saxis)
    fsc = np.asarray(fsc)
    sel = np.isfinite(fsc) & (fsc >= -0.1) & (fsc <= 1.1)
    s_fit, f_fit = saxis[sel], fsc[sel]
    if len(s_fit) < 3:
        return saxis, fsc, _find_resolution(saxis, fsc, 0.143)

    def fermi(mu, T, x):
        return 1.0 / (np.exp(np.clip((x - mu) / T, -50, 50)) + 1.0)

    def butterworth(omega, nn, x):
        return 1.0 / (1.0 + (x / omega) ** nn)

    candidates = []
    res_f = minimize(
        lambda p: 1e10
        if p[1] <= 0
        else np.mean(np.abs(f_fit - fermi(p[0], p[1], s_fit) / fermi(p[0], p[1], 0))),
        x0=[s_fit[len(s_fit) // 2], 0.01],
        method="Nelder-Mead",
    )
    candidates.append(
        (res_f.fun, lambda x: fermi(res_f.x[0], res_f.x[1], x) / fermi(res_f.x[0], res_f.x[1], 0))
    )
    res_b = minimize(
        lambda p: 1e10
        if p[0] <= 0 or p[1] <= 0
        else np.mean(np.abs(f_fit - butterworth(p[0], p[1], s_fit))),
        x0=[max(s_fit[len(s_fit) // 2], 1e-3), 4.0],
        method="Nelder-Mead",
    )
    candidates.append((res_b.fun, lambda x: butterworth(res_b.x[0], res_b.x[1], x)))
    _, best = min(candidates, key=lambda t: t[0])
    s_fine = np.linspace(saxis[1], saxis[-1], 500)
    f_fine = np.clip(best(s_fine), -1, 1)
    return s_fine, f_fine, _find_resolution(s_fine, f_fine, 0.143)


def _otsu_threshold_eman(volume, n_bins=256, ignore_zero=True):
    """EMAN2-matched Otsu threshold on the volume's device
    (core/mask3d.otsu_threshold_3d)."""
    from ..core.mask3d import otsu_threshold_3d

    volume = torch.as_tensor(volume)
    if ignore_zero and not bool((volume != 0).any()):
        return float(volume.min())
    return float(otsu_threshold_3d(volume, n_bins=n_bins, ignore_zero=ignore_zero))


def _generate_adaptive_mask(volume, apix, cutoff_res, args):
    """EMAN2 mask.auto3d-equivalent seed-and-grow mask on the volume's device
    (core/mask3d.adaptive_mask_3d), as float64."""
    from ..core.mask3d import adaptive_mask_3d

    mask, level, _ = adaptive_mask_3d(
        volume,
        apix=apix,
        cutoff_res=cutoff_res,
        thresh_fraction=max(0.0, args.maskFractionThresh),
        thresh_absolute=(
            args.maskThresh[0]
            if args.maskThresh and args.maskThresh[0] > 0
            else 0.0
        ),
        mass_kda=max(0.0, args.maskMass),
    )
    logger.info("Adaptive mask: threshold=%.7g", float(level))
    mass = int(torch.count_nonzero(mask)) * apix**3 * 0.81e-3
    logger.info("Adaptive mask: mass %d kDa", int(round(mass)))
    return mask.to(torch.float64)


def _soft_mask(mask, soft_width):
    """Cosine soft edge over an exact Euclidean distance transform
    (core/mask3d.soft_cosine_mask), as float64 on the mask's device."""
    from ..core.mask3d import soft_cosine_mask

    return soft_cosine_mask(mask, soft_width).to(torch.float64)


def plot_fsc(fsc_curves, plotFile, sections=None):
    """Multi-panel FSC report with the maps' central sections (2D arrays)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_vol = len(sections or [])
    fig = plt.figure(figsize=(10, 4 + 3 * n_vol))
    ax = fig.add_subplot(1 + n_vol, 1, 1)
    for s, f, label in fsc_curves:
        ax.plot(s, f, label=label)
    ax.axhline(0.143, color="gray", ls="--", lw=0.8)
    ax.axhline(0.0, color="black", lw=0.5)
    ax.set_xlabel("Spatial frequency (1/A)")
    ax.set_ylabel("FSC")
    ax.set_ylim(-0.1, 1.05)
    ax.legend(fontsize=8)
    for vi, (title, raw, masked) in enumerate(sections or []):
        for ci, (name, sec) in enumerate([("unmasked", raw), ("masked", masked)]):
            axv = fig.add_subplot(1 + n_vol, 2, 2 + vi * 2 + ci + 1)
            axv.imshow(np.asarray(sec), cmap="gray")
            axv.set_title(f"{title} ({name})", fontsize=8)
            axv.axis("off")
    fig.tight_layout()
    fig.savefig(plotFile)
    plt.close(fig)


def add_args(parser: argparse.ArgumentParser):
    parser.add_argument("map1", help="half map 1 (MRC)")
    parser.add_argument("map2", help="half map 2 (MRC)")
    parser.add_argument("plotFile", help="output plot file (.pdf/.png)")
    parser.add_argument("--apix", type=float, default=0,
                        help="pixel size override (A)")
    parser.add_argument("--cutoffRes", type=float, default=0,
                        help="phase randomization cutoff (A); 0 = auto at FSC=0.8")
    parser.add_argument("--maskFile", type=str, nargs="+", default=[],
                        help="user mask file(s) (1 or 2)")
    parser.add_argument("--oneMask", type=int, default=1,
                        help="use one common mask for both maps")
    parser.add_argument("--maskSoft", type=float, default=0,
                        help="mask soft edge width (A); 0 = auto")
    parser.add_argument("--refineMask", type=int, default=1,
                        help="optimize the soft edge width")
    parser.add_argument("--maskFractionThresh", type=float, default=0,
                        help="mask threshold as a fraction of the max")
    parser.add_argument("--maskThresh", type=float, nargs="+", default=[],
                        help="absolute mask threshold")
    parser.add_argument("--maskMass", type=float, default=0,
                        help="mask mass target (kDa)")
    parser.add_argument("--showPlot", type=int, default=0)
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the maps (cuda = the card; cpu)")
    return parser


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    main(add_args(parser).parse_args())
