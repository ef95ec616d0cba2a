"""Helical-orientation-consistency outlier filter (HOM container C)

Per-helix wrapped-linear fits of the rot-angle progression along each
filament; segments whose angles disagree with the fitted helical
progression are flagged or filtered.

Counterpart of ``helicon_tpu/commands/HOM_containerC.py``. The slope grid
search (:57) runs on ``--device`` (the card by default) for every helix
of a call at once: ``fit_line_wrapped_by_m_grid_batch`` scores the 501
slopes of a chunk of helices as one (helices, slopes, segments) float64
tensor. The rest (phase unwrapping of one sequence, the trimmed consensus
slope, the known-slope refit, the error-distribution fit, the reports,
the STAR IO) is host numpy / scipy / pandas, copied.
tests/test_torch_hom_symmismatch.py pins the port to the original.

  helicon-torch HOM_containerC in.star out.star --filterBad 1 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from ..utils.exceptions import HeliconError

logger = logging.getLogger(__name__)

# bytes of (helices, slopes, segments) float64 work one grid chunk may hold
# on the CPU; on the card, half of its free memory
GRID_CHUNK_BYTES_CPU = 1 << 28


def wrap_sym(z, P):
    """Wrap into [-P/2, P/2)."""
    return (z + P / 2) % P - P / 2


def unwrap_sequence(y, P):
    """Adjust by multiples of P so consecutive diffs lie in [-P/2, P/2)."""
    y = np.asarray(y, float)
    if y.size <= 1:
        return y.copy()
    dy = np.diff(y)
    corr = np.cumsum(wrap_sym(dy, P) - dy)
    return y + np.concatenate(([0.0], corr))


def solve_b_given_m_wrapped(x, o, P, m):
    """Closed-form intercept + SSE for a fixed slope."""
    x = np.asarray(x, float)
    o = np.asarray(o, float)
    r = unwrap_sequence(o - m * x, P)
    b = float(np.mean(r))
    d = wrap_sym(o - (m * x + b), P)
    return b, float(np.sum(d**2))


def _grid_chunk_bytes(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free // 2
    return GRID_CHUNK_BYTES_CPU


def _wrap_sym_t(z: torch.Tensor, P: float) -> torch.Tensor:
    # torch.remainder is the floor modulo of numpy's %
    return torch.remainder(z + P / 2, P) - P / 2


def fit_line_wrapped_by_m_grid_batch(xs, os_, P, m_min, m_max, num_m=501, device="cuda",
                                     return_grids=False):
    """Slope grid search of many helices at once on ``device``.

    xs, os_: per-helix float arrays (track position, angle mod P). For
    each helix and each of the ``num_m`` slopes m of
    ``np.linspace(m_min, m_max, num_m)``: the residual o - m x unwrapped
    by a cumulative sum of wrap_sym(diff) - diff, its mean as the
    intercept b, and the SSE of the wrapped residual; the first slope of
    least SSE wins. Helices are padded to a chunk's longest with their
    last sample (so the padded diffs are zero and add nothing) and
    chunked to fit the device's memory.

    Returns (index of the slope, m, b, SSE) arrays of the helices, their
    |angular errors| (one array per helix), and with ``return_grids`` the
    (m_grid, b (H, num_m), SSE (H, num_m)) grids.
    """
    m_grid = np.linspace(m_min, m_max, num_m)
    H = len(xs)
    n = np.array([len(x) for x in xs], np.int64)
    idx = np.zeros(H, np.int64)
    b_best = np.zeros(H)
    s_best = np.zeros(H)
    abs_err = [None] * H
    b_grid = np.zeros((H, num_m)) if return_grids else None
    s_grid = np.zeros((H, num_m)) if return_grids else None
    m_t = torch.as_tensor(m_grid, device=device)
    order = np.argsort(n, kind="stable")
    budget = _grid_chunk_bytes(device)
    start = 0
    while start < H:
        # helices sorted by length: a chunk pads to its last one's length
        stop = start + 1
        while stop < H and (stop - start + 1) * num_m * int(n[order[stop]]) * 8 * 8 <= budget:
            stop += 1
        sel = order[start:stop]
        L = int(n[sel].max())
        x = np.empty((len(sel), L))
        o = np.empty((len(sel), L))
        for k, h in enumerate(sel):
            x[k, : n[h]], x[k, n[h]:] = xs[h], xs[h][-1]
            o[k, : n[h]], o[k, n[h]:] = os_[h], os_[h][-1]
        xt = torch.as_tensor(x, device=device)
        ot = torch.as_tensor(o, device=device)
        nt = torch.as_tensor(n[sel], device=device)
        valid = torch.arange(L, device=device)[None, :] < nt[:, None]
        r = ot[:, None, :] - m_t[None, :, None] * xt[:, None, :]
        dy = torch.diff(r, dim=-1)
        corr = torch.cumsum(_wrap_sym_t(dy, P) - dy, dim=-1)
        r = torch.cat([r[..., :1], r[..., 1:] + corr], dim=-1)
        b = torch.where(valid[:, None, :], r, 0.0).sum(-1) / nt[:, None]
        del r, dy, corr
        d = _wrap_sym_t(ot[:, None, :] - (m_t[None, :, None] * xt[:, None, :] + b[..., None]), P)
        sse = torch.where(valid[:, None, :], d * d, 0.0).sum(-1)
        del d
        i = torch.argmin(sse, dim=1)
        rows = torch.arange(len(sel), device=device)
        bi = b[rows, i]
        e = torch.abs(torch.remainder(ot - (m_t[i][:, None] * xt + bi[:, None]) + P / 2.0, P)
                      - P / 2.0)
        i_h, b_h, s_h, e_h = (t.cpu().numpy() for t in (i, bi, sse[rows, i], e))
        idx[sel], b_best[sel], s_best[sel] = i_h, b_h, s_h
        for k, h in enumerate(sel):
            abs_err[h] = e_h[k, : n[h]]
        if return_grids:
            b_grid[sel] = b.cpu().numpy()
            s_grid[sel] = sse.cpu().numpy()
        start = stop
    out = (idx, m_grid[idx], b_best, s_best, abs_err)
    return out + ((m_grid, b_grid, s_grid),) if return_grids else out


def fit_line_wrapped_by_m_grid(x, o, P, m_min, m_max, num_m=501, device="cuda"):
    """Grid search over slope m with per-m closed-form intercept for one
    helix (on ``device``). Returns (m, b, SSE, (grids))."""
    i, m, b, s, _, (m_grid, b_grid, s_grid) = fit_line_wrapped_by_m_grid_batch(
        [np.asarray(x, float)], [np.asarray(o, float)], P, m_min, m_max, num_m,
        device=device, return_grids=True)
    return m[0], b[0], s[0], (m_grid, b_grid[0], s_grid[0])


def get_angular_errors(x, o, m_best, b_best, Period):
    """Signed + absolute shortest-arc residuals."""
    yy = m_best * np.asarray(x, float) + b_best
    errors = (np.asarray(o, float) - yy + Period / 2.0) % Period - Period / 2.0
    return errors, np.abs(errors)


def l1_core_average(x, k=50):
    """L1-optimal average of the densest k-point window.
    Returns (m_best, l1_sum, subset)."""
    x = np.asarray(x, float)
    x = x[~np.isnan(x)]
    n = x.size
    if n == 0:
        raise ValueError("No finite data points.")
    k = min(k, n)
    xs = np.sort(x)
    pref = np.concatenate(([0.0], np.cumsum(xs)))
    best_sum, best_m, best_slice = np.inf, None, (0, k)
    if k % 2 == 1:
        half = k // 2
        for i in range(n - k + 1):
            m_idx = i + half
            m = xs[m_idx]
            left = m * (m_idx - i) - (pref[m_idx] - pref[i])
            right = (pref[i + k] - pref[m_idx + 1]) - m * (i + k - m_idx - 1)
            if left + right < best_sum:
                best_sum, best_m, best_slice = left + right, m, (i, i + k)
    else:
        half = k // 2
        for i in range(n - k + 1):
            j = i + half - 1
            m = 0.5 * (xs[j] + xs[j + 1])
            L = j + 1 - i
            left = m * L - (pref[j + 1] - pref[i])
            Rn = i + k - (j + 1)
            right = (pref[i + k] - pref[j + 1]) - m * Rn
            if left + right < best_sum:
                best_sum, best_m, best_slice = left + right, m, (i, i + k)
    return best_m, best_sum, xs[best_slice[0]: best_slice[1]]


def fit_line_wrapped_by_m_known(x, o, P, m_best, fixed: bool = False):
    """Known-slope refit: with |m| fixed, try both signs, take the
    closed-form intercept for each, and keep the sign with the lower L1
    residual. Returns (m, b, SSE_l1).

    fixed=False (default) is the reference's estimator, the mean of the
    mod-P residuals (which can place the intercept ~P/2 off when the
    residuals straddle 0/P); fixed=True takes the mean of the unwrapped
    residual sequence instead.
    """
    m_abs = abs(float(m_best))
    x = np.asarray(x, float)
    o = np.asarray(o, float)
    best = None
    for m in (m_abs, -m_abs):
        r = unwrap_sequence(o - m * x, P)
        b = float(np.mean(r)) if fixed else float(np.mean(r % P))
        d = wrap_sym(o - (m * x + b), P)
        sse = float(np.sum(np.abs(d)))
        if best is None or sse < best[2]:
            best = (float(m), b, sse)
    return best


def G_model(x, A, sigma, Period, n_vals=(-1.0, 0.0, 1.0, 2.0)):
    """Periodic Gaussian error model."""
    x = np.asarray(x, float)
    n = np.asarray(n_vals, float)
    dx = x[None, :] - n[:, None] * Period
    return A * np.exp(-0.5 * (dx / sigma) ** 2).sum(axis=0)


def G2_model(x, APeak, sigmaPeak, ATail, sigmaTail):
    """Peak + tail two-Gaussian error model."""
    x = np.asarray(x, float)
    return APeak * np.exp(-0.5 * (x / sigmaPeak) ** 2) + ATail * np.exp(
        -0.5 * (x / sigmaTail) ** 2
    )


def fit_error_distribution(abs_errors, Period, sigma0=None):
    """G2-model fit of the |angular error| histogram: Freedman-Diaconis
    binning on [0, P/2], Poisson bin errors, empty bins dropped, scipy
    curve_fit.

    Returns dict(APeak, sigmaPeak, ATail, sigmaTail, xx, yy,
    bin_centers, counts); (xx, yy) is the dense curve (500 points on
    [0, P/2]).
    """
    from scipy.optimize import curve_fit

    data = np.abs(np.asarray(abs_errors, float))
    data = data[np.isfinite(data)]
    if data.size < 4:
        raise HeliconError("too few angular errors to fit the error model")
    counts, edges = np.histogram(data, bins="fd", range=(0, Period / 2))
    centers = 0.5 * (edges[:-1] + edges[1:])
    sigma_counts = np.sqrt(counts + 0.5)
    mask = counts > 0
    x_fit, y_fit, y_err = centers[mask], counts[mask], sigma_counts[mask]
    A0 = float(np.max(y_fit))
    s0 = float(sigma0) if sigma0 else max(float(np.std(data)), 1e-3)
    ATail0 = float(np.min(y_fit))
    p0 = [A0, s0, ATail0, Period]
    try:
        popt, _ = curve_fit(
            G2_model, x_fit, y_fit, p0=p0, sigma=y_err, absolute_sigma=False,
            maxfev=20000,
        )
    except RuntimeError:
        popt = p0  # fall back to the initial guess on non-convergence
    APeak, sigmaPeak, ATail, sigmaTail = (float(v) for v in popt)
    xx = np.linspace(0, Period / 2, 500)
    yy = G2_model(xx, APeak, sigmaPeak, ATail, sigmaTail)
    return dict(
        APeak=APeak, sigmaPeak=abs(sigmaPeak), ATail=ATail,
        sigmaTail=abs(sigmaTail), xx=xx, yy=yy,
        bin_centers=centers, counts=counts,
    )


def _plot_one_helix(ax, x, o, m, b, P):
    """One observed-vs-fit panel."""
    xx = np.linspace(float(np.min(x)), float(np.max(x)), 200)
    ax.scatter(x, o, s=4)
    ax.plot(xx, (m * xx + b) % P, "g-", lw=1)
    ax.set_xticks([])
    ax.set_yticks([])


def save_helix_reports(fits, prefix, per_page=50, grid=(10, 5), dpi=150):
    """Per-helix JPG batch pages (10x5 grids) + one combined PDF.
    fits: list of dicts with keys (label, x, o, m, b, P). Returns
    (jpg_paths, pdf_path)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows, cols = grid
    per_page = rows * cols if per_page <= 0 else min(per_page, rows * cols)
    jpgs = []
    for page_start in range(0, len(fits), per_page):
        page = fits[page_start: page_start + per_page]
        fig, axes = plt.subplots(rows, cols, figsize=(cols * 2, rows * 1.4))
        axes = np.atleast_1d(axes).ravel()
        for ax in axes:
            ax.axis("off")
        for ax, fit in zip(axes, page):
            ax.axis("on")
            _plot_one_helix(ax, fit["x"], fit["o"], fit["m"], fit["b"], fit["P"])
            ax.set_title(str(fit["label"]), fontsize=6)
        fig.tight_layout()
        path = f"{prefix}_page_{page_start // per_page + 1:02d}.jpg"
        fig.savefig(path, dpi=dpi)
        plt.close(fig)
        jpgs.append(path)
    pdf_path = None
    if jpgs:
        pdf_path = f"{prefix}_report.pdf"
        jpgs_to_pdf(jpgs, pdf_path, dpi=dpi)
    return jpgs, pdf_path


def jpgs_to_pdf(jpg_paths, pdf_path, dpi=200):
    """Combine JPGs into one multi-page PDF."""
    from PIL import Image

    jpg_paths = [str(p) for p in jpg_paths]
    if not jpg_paths:
        raise ValueError("jpg_paths is empty.")
    images = []
    for p in jpg_paths:
        im = Image.open(p)
        if im.mode != "RGB":
            im = im.convert("RGB")
        images.append(im)
    first, rest = images[0], images[1:]
    pdf_path = Path(pdf_path)
    first.save(
        pdf_path, "PDF", resolution=float(dpi), save_all=True,
        append_images=rest,
    )
    return str(pdf_path)


def _helix_groups(data, group_cols):
    """Row positions of each (micrograph, tube) group in groupby's
    order of first appearance (NaN keys dropped, as groupby does)."""
    codes = data.groupby(group_cols, sort=False).ngroup().to_numpy()
    keep = np.nonzero(codes >= 0)[0]
    pos = keep[np.argsort(codes[keep], kind="stable")]
    bounds = np.cumsum(np.bincount(codes[keep]))
    return np.split(pos, bounds[:-1]) if len(pos) else []


def HelicalSegmentConsistency(
    data: pd.DataFrame,
    *,
    csym: int = 1,
    rise: float = 4.75,
    twist_range=(-5.0, 5.0),
    max_error_deg: float = 30.0,
    refit_known_slope: bool = False,
    fixed_intercept: bool = False,
    fit_error_model: bool = True,
    report_prefix: str = "",
    verbose: int = 0,
    convert_path_fn=None,
    input_star_path: str | None = None,
    output_star_path: str | None = None,
    param: str | None = None,
    device="cuda",
    **kwargs,
):
    """Per-helix rot-progression fit + per-segment error columns.

    For each (micrograph, tube) group the rot angles (mod P = 360/csym)
    are fit as a wrapped-linear function of the track position, every
    helix of three or more segments in one batched grid search on
    ``device``; per-segment absolute angular errors, per-helix slope and
    the trimmed consensus slope across helices are returned.

    convert_path_fn / input_star_path / output_star_path are accepted for
    the reference's call shape (IO is the caller's job); ``param`` is a
    JSON-or-k=v option string whose keys (csym, rise, twist_min/max,
    max_error_deg, refit_known_slope, fixed_intercept) override the
    keyword defaults.

    Returns (data, stats): data gains rlnAngleRotError /
    rlnHelicalConsistencyGood plus the diagnostic columns rlnPartNum,
    rlnMicrographFromImageName, rlnMicUniqId, rlnHelicalTubeAndMicID,
    rlnHelicalTubeAndMicIDGood and rlnHelicalTubeAndMicIDGoodSegValue;
    stats summarizes the fits.
    """
    if param:
        import json

        from ..utils.system import parse_param_str

        try:
            pd_extra = json.loads(param)
            if not isinstance(pd_extra, dict):
                pd_extra = {}
        except (ValueError, TypeError):
            _, pd_extra = parse_param_str(param)
        csym = int(pd_extra.get("csym", csym))
        rise = float(pd_extra.get("rise", rise))
        twist_range = (
            float(pd_extra.get("twist_min", twist_range[0])),
            float(pd_extra.get("twist_max", twist_range[1])),
        )
        max_error_deg = float(pd_extra.get("max_error_deg", max_error_deg))
        refit_known_slope = bool(
            int(pd_extra.get("refit_known_slope", refit_known_slope))
        )
        fixed_intercept = bool(
            int(pd_extra.get("fixed_intercept", fixed_intercept))
        )
    required = (
        "rlnHelicalTubeID rlnAngleRot rlnHelicalTrackLengthAngst".split()
    )
    missing = [c for c in required if c not in data]
    if missing:
        raise HeliconError(f"required columns missing: {' '.join(missing)}")
    if len(data) == 0:
        from ..utils.exceptions import HeliconValueError

        raise HeliconValueError("no segments in the input data")

    data = data.copy()
    # parse rlnImageName into particle number + micrograph and build the
    # unique (micrograph, tube) helix id used for grouping below
    if "rlnImageName" in data:
        split = data["rlnImageName"].astype(str).str.split("@", n=1, expand=True)
        nums = pd.to_numeric(split[0], errors="coerce").astype("Int64")
        if nums.notna().any() and (nums == 0).sum() == 0 and nums.min() >= 1:
            nums = nums - 1  # looks 1-based: shift to 0-based like RELION
        data["rlnPartNum"] = nums.fillna(0).astype(int)
        data["rlnMicrographFromImageName"] = (
            split[1] if split.shape[1] > 1 else ""
        )
        micro_to_id = {
            name: i
            for i, name in enumerate(data["rlnMicrographFromImageName"].unique())
        }
        data["rlnMicUniqId"] = data["rlnMicrographFromImageName"].map(micro_to_id)
        data["rlnHelicalTubeAndMicID"] = data.groupby(
            ["rlnMicUniqId", "rlnHelicalTubeID"]
        ).ngroup().astype(int)

    if "rlnHelicalTubeAndMicID" in data:
        group_cols = ["rlnHelicalTubeAndMicID"]
    else:
        group_cols = [
            c for c in ("rlnMicrographName", "rlnImageName") if c in data
        ][:1] + ["rlnHelicalTubeID"]
    if group_cols == ["rlnHelicalTubeID"]:
        # tube IDs restart at 1 per micrograph: without a micrograph or
        # image column, same-numbered tubes from different micrographs
        # pool into one wrapped-line fit
        logger.warning(
            "no rlnMicrographName/rlnImageName column: grouping by "
            "rlnHelicalTubeID alone — if tube IDs are per-micrograph, "
            "unrelated filaments will be pooled and the fits will be "
            "meaningless"
        )
    P = 360.0 / max(1, csym)
    # NaN = "not evaluated": helices with < 3 segments are not fitted and
    # must not count as consistent
    data["rlnAngleRotError"] = np.nan
    data["rlnHelicalTubeAndMicIDGood"] = 0.0
    data["rlnHelicalTubeAndMicIDGoodSegValue"] = 0.0
    groups = [p for p in _helix_groups(data, group_cols) if len(p) >= 3]
    x_all = data["rlnHelicalTrackLengthAngst"].astype(float).to_numpy()
    o_all = data["rlnAngleRot"].astype(float).to_numpy() % P
    xs = [x_all[p] for p in groups]
    os_ = [o_all[p] for p in groups]
    _, slopes, b_fit, sses, errs = fit_line_wrapped_by_m_grid_batch(
        xs, os_, P, twist_range[0] / rise, twist_range[1] / rise, num_m=501, device=device)
    err_col = data["rlnAngleRotError"].to_numpy().copy()
    good_col = data["rlnHelicalTubeAndMicIDGood"].to_numpy().copy()
    seg_col = data["rlnHelicalTubeAndMicIDGoodSegValue"].to_numpy().copy()

    def put(p, abs_err):
        err_col[p] = np.round(abs_err, 2)
        seg_col[p] = abs_err
        good_col[p] = float(np.mean(abs_err))

    fits = []  # per-helix fit records (for the refit pass + reports)
    for k, p in enumerate(groups):
        put(p, errs[k])
        fits.append(dict(pos=p, x=xs[k], o=os_[k], m=slopes[k], b=b_fit[k], P=P))
    n_segments = [len(p) for p in groups]
    if len(slopes):
        consensus, _, _ = l1_core_average(slopes, k=max(3, len(slopes) // 2))
    else:
        consensus = 0.0

    if refit_known_slope and fits:
        # second pass with the consensus slope magnitude fixed
        for fit in fits:
            m2, b2, _ = fit_line_wrapped_by_m_known(
                fit["x"], fit["o"], P, consensus, fixed=fixed_intercept
            )
            _, abs_err = get_angular_errors(fit["x"], fit["o"], m2, b2, P)
            put(fit["pos"], abs_err)
            fit["m"], fit["b"] = m2, b2
    data["rlnAngleRotError"] = err_col
    data["rlnHelicalTubeAndMicIDGood"] = good_col
    data["rlnHelicalTubeAndMicIDGoodSegValue"] = seg_col

    evaluated = data["rlnAngleRotError"].notna()
    data["rlnHelicalConsistencyGood"] = (
        evaluated & (data["rlnAngleRotError"] <= max_error_deg)
    ).astype(int)
    data["rlnAngleRotError"] = data["rlnAngleRotError"].fillna(0.0)
    stats = dict(
        n_helices=len(slopes),
        n_segments=int(sum(n_segments)),
        n_unevaluated=int((~evaluated).sum()),
        n_good=int(data["rlnHelicalConsistencyGood"].sum()),
        consensus_twist_per_A=float(consensus),
        consensus_twist_per_rise=float(consensus * rise),
        median_sse=float(np.median(sses)) if len(sses) else 0.0,
    )

    if fit_error_model and fits:
        try:
            err_fit = fit_error_distribution(
                data.loc[data["rlnAngleRotError"] > 0, "rlnAngleRotError"], P
            )
            stats.update(
                error_fit_APeak=err_fit["APeak"],
                error_fit_sigmaPeak=err_fit["sigmaPeak"],
                error_fit_ATail=err_fit["ATail"],
                error_fit_sigmaTail=err_fit["sigmaTail"],
            )
        except HeliconError:
            pass  # too few errors: skip the distribution fit

    if report_prefix and fits:
        labels = [label for label, g in data.groupby(group_cols, sort=False) if len(g) >= 3]
        for fit, label in zip(fits, labels):
            fit["label"] = label
        jpgs, pdf = save_helix_reports(fits, report_prefix)
        stats["report_pages"] = jpgs
        stats["report_pdf"] = pdf

    if verbose:
        logger.info("HelicalSegmentConsistency: %s", stats)
    return data, stats


class _StarfileAdapter:
    """starfile-compatible read/write facade over the native STAR codec:
    read gives a dict of "data_*"-keyed tables (a bare DataFrame for a
    single-table file), write takes a dict or a DataFrame. Patching this
    module's ``starfile`` intercepts the command's IO."""

    @staticmethod
    def read(path):
        from ..io.star import read_star

        blocks = read_star(path)
        out = {f"data_{k}" if k else "data_": v for k, v in blocks.items()}
        if len(out) == 1:
            return next(iter(out.values()))
        return out

    @staticmethod
    def write(obj, path, overwrite=True):
        from ..io.star import write_star

        if isinstance(obj, dict):
            blocks = {
                (k[5:] if k.startswith("data_") else k): v
                for k, v in obj.items()
            }
            write_star(path, blocks)
        else:
            write_star(path, {"particles": obj})


starfile = _StarfileAdapter()


def _read_star(path: str) -> pd.DataFrame:
    """Read a RELION STAR file into the particles DataFrame."""
    if starfile is None:
        raise RuntimeError(
            "Reading .star requires the 'starfile' package for robustness.\n"
            "Install with: pip install starfile"
        )
    tables = starfile.read(path)
    if isinstance(tables, dict):
        for key in ("data_particles", "particles", "data_"):
            if key in tables:
                return tables[key]
        return next(iter(tables.values()))
    return tables


def _write_star(df: pd.DataFrame, path: str, like: str | None = None):
    """Write the particles DataFrame, keeping the source file's optics
    table when ``like`` is given."""
    if starfile is None:
        raise RuntimeError(
            "Writing .star requires the 'starfile' package.\n"
            "Install with: pip install starfile"
        )
    if like and Path(like).exists():
        src = starfile.read(like)
        if isinstance(src, dict) and "data_optics" in src:
            out = dict(src)
            out["data_particles"] = df
            starfile.write(out, path, overwrite=True)
            return
    starfile.write(df, path, overwrite=True)


def main(args):
    from ..utils.logging import log_command_line
    from . import command_device

    log_command_line()
    device = command_device(getattr(args, "device", "cuda"))
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.ERROR,
        format="%(message)s", stream=sys.stdout,
    )
    data = _read_star(args.input_star)
    # the extra CLI knobs ride along only when changed from their defaults
    extras = {}
    for key, arg, default in (
        ("csym", "csym", 1),
        ("rise", "rise", 4.75),
        ("max_error_deg", "maxError", 30.0),
        ("report_prefix", "reportPrefix", ""),
    ):
        v = getattr(args, arg, default)
        if v != default:
            extras[key] = v
    tw = (getattr(args, "twistMin", -5.0), getattr(args, "twistMax", 5.0))
    if tw != (-5.0, 5.0):
        extras["twist_range"] = tw
    if getattr(args, "refitKnownSlope", 0):
        extras["refit_known_slope"] = True
    if getattr(args, "fixedIntercept", 0):
        extras["fixed_intercept"] = True
    data, stats = HelicalSegmentConsistency(
        data,
        convert_path_fn=None,
        verbose=args.verbose,
        input_star_path=args.input_star,
        output_star_path=args.output_star,
        param=getattr(args, "param", None) or None,
        device=device,
        **extras,
    )
    if getattr(args, "filterBad", 0):
        n0 = len(data)
        data = data[data["rlnHelicalConsistencyGood"] == 1].reset_index(drop=True)
        logger.info("filtered %d -> %d segments", n0, len(data))
    _write_star(data, args.output_star, like=args.input_star)
    if args.verbose:
        print(stats)


def add_args(parser):
    parser.add_argument("input_star", help="input star file")
    parser.add_argument("output_star", help="output star file")
    parser.add_argument("--param", type=str, default="",
                        help="extra parameter string (reference-compatible)")
    parser.add_argument("--force", type=int, default=0,
                        help="force overwrite the output file")
    parser.add_argument("--csym", type=int, default=1)
    parser.add_argument("--rise", type=float, default=4.75,
                        help="helical rise (A)")
    parser.add_argument("--twistMin", type=float, default=-5.0,
                        help="min twist per rise (deg)")
    parser.add_argument("--twistMax", type=float, default=5.0)
    parser.add_argument("--maxError", type=float, default=30.0,
                        help="max angular error (deg) for a good segment")
    parser.add_argument("--filterBad", type=int, default=0,
                        help="drop inconsistent segments")
    parser.add_argument("--fixedIntercept", type=int, default=0,
                        help="1 = use the corrected unwrapped-mean intercept "
                             "in the known-slope refit instead of the "
                             "reference's mod-P mean (bug-for-bug default)")
    parser.add_argument("--refitKnownSlope", type=int, default=0,
                        help="refit each helix with the consensus slope")
    parser.add_argument("--reportPrefix", type=str, default="",
                        help="write per-helix JPG report pages + PDF "
                             "with this prefix")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the slope grid search (cuda = the card; cpu)")
    return parser


def check_args(args, parser, argv=None):
    from ..utils.exceptions import HeliconFileExistsError

    if Path(args.output_star).exists() and not args.force:
        raise HeliconFileExistsError(
            f"output file {args.output_star} exists; use --force 1"
        )
    return args


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    args = add_args(parser).parse_args()
    main(check_args(args, parser))
