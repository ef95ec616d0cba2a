"""The denovo3D app's workflow without its reactive wiring (no ``shiny``):
what the app computes, testable on its own.

Counterpart of ``helicon_tpu/webApps/denovo3D/workflow.py``:

- the input-source registry with the EMPIAR-10940 default;
- multi-image stitching with overlap averaging, offset estimation and
  phase-correlation montage registration;
- the per-image transform chain (negate, threshold, transpose, flip,
  rotation, y-shift, crop) and its automatic parameters;
- the simulation input mode (a map symmetrized and projected);
- the score-landscape data;
- the incremental, abortable grid search with best-first snapshots, on
  the port's reconstruct_grid: a snapshot after each launch.

Images go in and come out as numpy arrays; the numerical steps run on
``device`` (the card unless the caller asks for "cpu"). Histograms,
stitching arithmetic and the score table stay on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = [
    "URLS",
    "DEFAULT_URL_KEY",
    "image_stitching_x_positions",
    "combine_images_for_display",
    "estimate_threshold_otsu",
    "apply_transform_chain",
    "auto_transform_params",
    "filter_blank_images",
    "preprocess_selected_images",
    "estimate_stitch_offsets",
    "register_and_montage",
    "symmetrize_projection",
    "score_plot_data",
    "run_grid_incremental",
]

# the app's default demo dataset
URLS = {
    "empiar-10940_job010": (
        "https://ftp.ebi.ac.uk/empiar/world_availability/10940/data/EMPIAR/"
        "Class2D/job010/run_it020_classes.mrcs",
        "https://ftp.ebi.ac.uk/pub/databases/emdb/structures/EMD-14046/map/"
        "emd_14046.map.gz",
    )
}
DEFAULT_URL_KEY = "empiar-10940_job010"


def image_stitching_x_positions(images, x_offsets=None):
    """Per-image x start positions for stitching."""
    if not len(images):
        return []
    x_offsets = [] if x_offsets is None else list(x_offsets)
    positions = []
    next_x = 0
    for i, img in enumerate(images):
        offset = x_offsets[i] if i < len(x_offsets) else 0
        positions.append(next_x + int(round(offset)))
        next_x += img.shape[1]
    return positions


def combine_images_for_display(images, x_offsets=None):
    """Overlap-averaged horizontal montage."""
    if not len(images):
        return np.zeros((0, 0), dtype=np.float64)
    x_positions = image_stitching_x_positions(images, x_offsets)
    canvas_left = min(0, min(x_positions))
    canvas_right = max(
        start_x + img.shape[1] for start_x, img in zip(x_positions, images)
    )
    canvas_height = max(img.shape[0] for img in images)
    canvas_width = max(0, canvas_right - canvas_left)
    sum_image = np.zeros((canvas_height, canvas_width), dtype=np.float64)
    count_image = np.zeros((canvas_height, canvas_width), dtype=np.uint16)
    for start_x, img in zip(x_positions, images):
        canvas_start = max(start_x - canvas_left, 0)
        canvas_end = min(start_x - canvas_left + img.shape[1], canvas_width)
        if canvas_start >= canvas_end:
            continue
        img_start = max(0, canvas_left - start_x)
        img_end = img_start + (canvas_end - canvas_start)
        img_slice = img[:, img_start:img_end].astype(np.float64)
        h = img_slice.shape[0]
        sum_image[:h, canvas_start:canvas_end] += img_slice
        count_image[:h, canvas_start:canvas_end] += 1
    return np.divide(
        sum_image,
        count_image,
        where=(count_image > 0),
        out=np.zeros_like(sum_image),
    )


def filter_blank_images(stack):
    """Indices of the non-blank images (max > min): the app's
    `ignore_blank` checkbox."""
    return [
        i for i, im in enumerate(stack)
        if float(np.max(im)) > float(np.min(im))
    ]


def preprocess_selected_images(
    images, apix: float, binning: int = 1,
    lp_angst: float = -1, hp_angst: float = -1, device="cuda",
):
    """Binning and low/high-pass of the selected images. Returns (images,
    effective_apix).

    Binning is an integer block mean; the filter cut-offs are the Nyquist
    fractions 2 * apix / angstrom. The filters run on ``device``.
    """
    from ...core.filters import low_high_pass_filter

    binning = max(1, int(binning))
    out = [np.asarray(im, np.float32) for im in images]
    if binning > 1:
        binned = []
        for a in out:
            ny, nx = a.shape
            cy, cx = ny // binning * binning, nx // binning * binning
            a = a[:cy, :cx].reshape(
                cy // binning, binning, cx // binning, binning
            ).mean(axis=(1, 3))
            binned.append(a.astype(np.float32))
        out = binned
        apix = apix * binning
    lp_frac = 2.0 * apix / lp_angst if lp_angst and lp_angst > 0 else -1
    hp_frac = 2.0 * apix / hp_angst if hp_angst and hp_angst > 0 else -1
    if lp_frac > 0 or hp_frac > 0:
        out = [
            low_high_pass_filter(
                torch.as_tensor(a, device=device), low_pass_fraction=max(lp_frac, 0),
                high_pass_fraction=max(hp_frac, 0),
            ).cpu().numpy().astype(np.float32)
            for a in out
        ]
    return out, float(apix)


def estimate_stitch_offsets(
    images, max_shift_fraction: float = 0.9, min_overlap: int = 8
):
    """Auto x-offsets for the multi-image montage: 1D cross-correlation
    of adjacent images' column profiles (the app's "Stitch Images" dialog,
    estimated automatically). Returns one offset per image (first = 0), in the
    convention of image_stitching_x_positions: offset i is relative to
    the UNSHIFTED concatenation position sum(widths[:i]), so pairwise
    overlaps accumulate (negative = overlap)."""
    if len(images) < 2:
        return [0.0] * len(images)
    pairwise = [0.0]
    for a, b in zip(images[:-1], images[1:]):
        pa = np.asarray(a, np.float64).sum(axis=0)
        pb = np.asarray(b, np.float64).sum(axis=0)
        pa = pa - pa.mean()
        pb = pb - pb.mean()
        n = len(pa) + len(pb) - 1
        corr = np.correlate(pb, pa, mode="full")  # c[k]: sum pb[n+lag]*pa[n]
        # normalize by the overlap length: a raw dot product lets many
        # small random covariances at a long wrong overlap outscore the
        # short true overlap
        counts = np.correlate(
            np.ones_like(pb), np.ones_like(pa), mode="full"
        )
        corr = corr / np.maximum(counts, 1.0)
        lags = np.arange(n) - (len(pa) - 1)
        # peak lag satisfies pb[n+lag] = pa[n], i.e. b's global start
        # g = -lag; offset convention: b starts at a_end + offset
        cand = -lags - len(pa)
        # only consider overlaps in [min_overlap, max_shift_fraction *
        # width]: tiny overlaps are spuriously high after per-sample
        # normalization (one lucky sample), huge ones are unphysical
        wmax = int(max_shift_fraction * min(len(pa), len(pb)))
        ok = (cand <= -min_overlap) & (cand >= -wmax)
        if not ok.any():
            pairwise.append(0.0)
            continue
        best = int(np.argmax(np.where(ok, corr, -np.inf)))
        pairwise.append(float(cand[best]))
    return np.cumsum(pairwise).tolist()


def register_and_montage(images, x_offsets=None, device="cuda"):
    """Registration montage: adjacent tiles registered by phase
    cross-correlation (on ``device``) over their nominal overlap window,
    which recovers the full 2D (dy, dx) shift, not only the x offset, then
    merged with overlap averaging.

    x_offsets: optional manual x guesses (the stitch_x_offsets
    convention); the registration refines them. Returns (montage
    float32, positions [(y, x) int]).
    """
    from ...core.alignment import phase_cross_correlation

    if not len(images):
        return np.zeros((0, 0), np.float32), []
    images = [np.asarray(im, np.float32) for im in images]
    if x_offsets is None:
        # seed positions from the 1D profile correlation (the ITK flow
        # gets its seed from TileConfiguration.txt)
        x_offsets = estimate_stitch_offsets(images)
    xs = image_stitching_x_positions(images, x_offsets)
    positions = [(0, int(xs[0]))]
    for i in range(1, len(images)):
        py, px = positions[i - 1]
        a, b = images[i - 1], images[i]
        # nominal overlap window between a's right edge and b's left
        w = (px + a.shape[1]) - int(xs[i])
        w = int(np.clip(w, 8, min(a.shape[1], b.shape[1])))
        h = min(a.shape[0], b.shape[0])
        win_a = a[:h, -w:]
        win_b = b[:h, :w]
        (sy, sx), _, _ = phase_cross_correlation(torch.as_tensor(win_a, device=device),
                                                 torch.as_tensor(win_b, device=device))
        positions.append(
            (int(py + sy), int(px + a.shape[1] - w + sx))
        )
    # merge on a 2D canvas with overlap averaging
    y0 = min(p[0] for p in positions)
    x0 = min(p[1] for p in positions)
    y1 = max(p[0] + im.shape[0] for p, im in zip(positions, images))
    x1 = max(p[1] + im.shape[1] for p, im in zip(positions, images))
    acc = np.zeros((y1 - y0, x1 - x0), np.float64)
    cnt = np.zeros_like(acc)
    for (py, px), im in zip(positions, images):
        acc[py - y0 : py - y0 + im.shape[0],
            px - x0 : px - x0 + im.shape[1]] += im
        cnt[py - y0 : py - y0 + im.shape[0],
            px - x0 : px - x0 + im.shape[1]] += 1
    out = np.divide(acc, cnt, where=cnt > 0, out=np.zeros_like(acc))
    return out.astype(np.float32), positions


def symmetrize_projection(
    data,
    apix: float,
    twist_degree: float,
    rise_angstrom: float,
    csym: int = 1,
    new_size=None,
    new_apix: float | None = None,
    axial_rotation: float = 0.0,
    tilt: float = 0.0,
    gauss_noise_std: float = 0.0,
    rng=None,
    device="cuda",
):
    """The app's simulation input mode: a 3D map low-passed when new_apix
    coarsens it, helically symmetrized, optionally rotated and tilted (on
    ``device``), projected along x and flipped left-right, plus Gaussian
    noise scaled by the foreground's sigma.

    Returns (projection stack (1, ny, nx) float32, new_apix).
    """
    from ...core.filters import low_high_pass_filter
    from ...core.transforms import apply_helical_symmetry, transform_map

    data = torch.as_tensor(np.asarray(data, np.float32), device=device)
    new_apix = float(new_apix if new_apix else apix)
    if new_apix > apix:
        data = low_high_pass_filter(data, low_pass_fraction=apix / new_apix)
    m = apply_helical_symmetry(
        data, apix=apix, twist_degree=twist_degree,
        rise_angstrom=rise_angstrom, csym=int(csym),
        new_size=new_size, new_apix=new_apix,
    )
    if axial_rotation or tilt:
        m = transform_map(m, rot=axial_rotation, tilt=tilt)
    proj = np.transpose(m.sum(dim=-1).cpu().numpy())[:, ::-1]
    if gauss_noise_std and gauss_noise_std > 0:
        # noise scaled by the foreground sigma
        fg = proj[proj > 1e-3]
        sigma = float(np.std(fg)) if fg.size else float(np.std(proj))
        rng = np.random.default_rng(rng)
        proj = proj + rng.normal(
            scale=sigma * gauss_noise_std, size=proj.shape
        )
    return proj[None].astype(np.float32), new_apix


def score_plot_data(twists, rises, scores):
    """Score-landscape data for the app's plot: the 2D max-aggregated
    (twist, rise) -> score grid when both axes vary, else the 1D curve.

    Returns dict(kind="2d", z (n_twist, n_rise), x twists, y rises,
    best=(tw, ri)) or dict(kind="1d", x, y, xlabel) or None.
    """
    twists = np.asarray(twists, np.float64)
    rises = np.asarray(rises, np.float64)
    scores = np.asarray(scores, np.float64)
    ok = np.isfinite(scores)
    if ok.sum() < 2:
        return None
    twists, rises, scores = twists[ok], rises[ok], scores[ok]
    xu, xi = np.unique(twists, return_inverse=True)
    yu, yi = np.unique(rises, return_inverse=True)
    if len(xu) > 1 and len(yu) > 1:
        z = np.full((len(xu), len(yu)), scores.min(), np.float64)
        np.maximum.at(z, (xi, yi), scores)
        bi = np.unravel_index(np.argmax(z), z.shape)
        return dict(
            kind="2d", z=z, x=xu, y=yu,
            best=(float(xu[bi[0]]), float(yu[bi[1]])),
        )
    if len(xu) > 1:
        order = np.argsort(twists)
        return dict(
            kind="1d", x=twists[order], y=scores[order],
            xlabel="Twist (°)",
        )
    order = np.argsort(rises)
    return dict(
        kind="1d", x=rises[order], y=scores[order], xlabel="Rise (Å)"
    )


def estimate_threshold_otsu(images, negate: bool = False) -> float:
    """Median per-image Otsu threshold (256 bins; the first maximum of the
    between-class variance, as skimage's threshold_otsu)."""
    values = []
    for img in images:
        a = np.asarray(-img if negate else img, np.float64).ravel()
        lo, hi = a.min(), a.max()
        if hi <= lo:
            values.append(lo)
            continue
        hist, edges = np.histogram(a, bins=256, range=(lo, hi))
        hist = hist.astype(np.float64)
        centers = 0.5 * (edges[:-1] + edges[1:])
        w0 = np.cumsum(hist)
        w1 = w0[-1] - w0
        m0 = np.cumsum(hist * centers)
        mu0 = np.divide(m0, w0, where=w0 > 0, out=np.zeros_like(m0))
        mu1 = np.divide(
            m0[-1] - m0, w1, where=w1 > 0, out=np.zeros_like(m0)
        )
        between = w0 * w1 * (mu0 - mu1) ** 2
        values.append(float(centers[int(np.argmax(between))]))
    return float(np.median(values))


def apply_transform_chain(
    images,
    negate: bool = False,
    threshold: float | None = None,
    transpose: bool = False,
    flip: bool = False,
    rotation: float = 0.0,
    shift_y_pixel: float = 0.0,
    vertical_crop_size: int = 0,
    horizontal_crop_size: int = 0,
    device="cuda",
):
    """The app's per-image transform chain, in its order: negate,
    threshold, transpose, flip, rotation with a vertical shift, then the
    centre crop to the (vertical, horizontal) sizes, rounded down to even.
    Runs on ``device``; returns a list of float32 numpy images.
    """
    from ...core.filters import threshold_data
    from ...core.transforms import crop_center, rotate_shift_image

    out = []
    for img in images:
        a = torch.as_tensor(np.asarray(img, np.float32), device=device)
        if negate:
            a = -a
        if threshold is not None:
            a = threshold_data(a, thresh_value=float(threshold))
        if transpose:
            a = a.T
        if flip:
            a = torch.fliplr(a)
        if rotation or shift_y_pixel:
            a = rotate_shift_image(
                a,
                angle=-float(rotation),
                post_shift=(float(shift_y_pixel), 0.0),
            )
        ny, nx = a.shape
        cy = int(vertical_crop_size) if vertical_crop_size > 0 else ny
        cx = int(horizontal_crop_size) if horizontal_crop_size > 0 else nx
        cy, cx = min(cy, ny) // 2 * 2, min(cx, nx) // 2 * 2
        if (cy, cx) != (ny, nx):
            a = crop_center(a, (cy, cx))
        out.append(a.cpu().numpy().astype(np.float32))
    return out


def auto_transform_params(images, apix: float, is_3d: bool = False):
    """The app's automatic (rotation_deg, shift_y_angstrom, vertical_crop,
    horizontal_crop): the helix estimator at 20 % of each image's maximum,
    averaged over the images (host numpy)."""
    from ...core.analysis import estimate_helix_rotation_center_diameter

    tmp = []
    for img in images:
        a = np.asarray(img, np.float32)
        rot, sy, diam = estimate_helix_rotation_center_diameter(
            a, threshold=float(np.max(a)) * 0.2
        )
        if is_3d:
            rot, sy = 0.0, 0.0
        tmp.append((rot, sy, diam))
    tmp = np.asarray(tmp, np.float64)
    rotation = float(np.mean(tmp[:, 0]))
    shift_y = float(np.mean(tmp[:, 1])) * apix
    diameter = float(np.max(tmp[:, 2]))
    ny = int(np.max([img.shape[0] for img in images]))
    nx = int(np.max([img.shape[1] for img in images]))
    if is_3d:
        crop = int(diameter * 1.2) // 4 * 4
    else:
        crop = int(diameter * 2) // 4 * 4
    vertical_crop = max(32, min(crop, ny // 2 * 2))
    horizontal_crop = nx // 2 * 2
    return rotation, shift_y, vertical_crop, horizontal_crop


class GridProgress:
    """Snapshot handed to the app after every candidate batch."""

    def __init__(self, done, total, eta_seconds, ranked, aborted=False):
        self.done = done
        self.total = total
        self.eta_seconds = eta_seconds
        self.ranked = ranked  # [(twist, rise, score)] best-first so far
        self.aborted = aborted


def run_grid_incremental(
    image,
    apix,
    twists,
    rises,
    on_progress=None,
    should_abort=None,
    **grid_kwargs,
):
    """Abortable grid search with best-first snapshots, on the port's
    reconstruct_grid (on the card unless grid_kwargs has device="cpu").

    on_progress receives a GridProgress after each launch and a final one;
    should_abort() -> True stops between launches (the scores done are
    kept, the rest -inf). Returns the GridResult (best_volume only when
    the run finishes).
    """
    from ...denovo3d.grid import reconstruct_grid

    twists = np.asarray(twists, np.float32)
    rises = np.asarray(rises, np.float32)
    t0 = time.time()
    state = dict(aborted=False)
    top_keep = 200  # rank at most this many rows per snapshot

    def _ranked(scores):
        """Best-first (twist, rise, score) rows of the SCORED candidates.

        Unscored entries are -inf (reconstruct_grid's incremental
        sentinel: a legitimate 0.0 score must still rank). Large grids
        are partitioned to the top rows before the sort: the app shows a
        top-N table.
        """
        scored = np.flatnonzero(np.isfinite(scores))
        if len(scored) > top_keep:
            part = np.argpartition(-scores[scored], top_keep)[:top_keep]
            scored = scored[part]
        order = scored[np.argsort(-scores[scored])]
        return [
            (float(twists[i]), float(rises[i]), float(scores[i]))
            for i in order
        ]

    def progress_callback(done, total, scores):
        elapsed = time.time() - t0
        eta = elapsed / max(done, 1) * (total - done)
        if on_progress is not None:
            on_progress(GridProgress(done, total, eta, _ranked(scores)))

    def abort():
        if should_abort is not None and should_abort():
            state["aborted"] = True
            return True
        return False

    res = reconstruct_grid(
        image,
        apix=apix,
        twists=twists,
        rises=rises,
        progress_callback=progress_callback,
        should_abort=abort,
        **grid_kwargs,
    )
    if on_progress is not None:
        done = (
            int(np.isfinite(res.scores).sum())
            if state["aborted"]
            else len(twists)
        )
        on_progress(
            GridProgress(
                done, len(twists), 0.0, _ranked(res.scores), state["aborted"]
            )
        )
    return res
