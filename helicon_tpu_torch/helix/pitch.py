"""Helical pitch from same-class segment pair distances.

Counterpart of ``helicon_tpu/helix/pitch.py``:
``estimate_pitch_from_pair_distances`` :24 (host numpy / scipy, copied):
same-class2D segments of a filament repeat every pitch / csym along its
axis, so the histogram of their pair distances peaks at multiples of
pitch / csym. ``estimate_pitch_from_class2d`` :91 takes its pair
distances from whereIsMyClass's compute module, on ``device``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "estimate_pitch_from_pair_distances",
    "estimate_pitch_from_class2d",
]


def estimate_pitch_from_pair_distances(
    distances,
    csym: int = 1,
    rise: float | None = None,
    bins: int = 100,
    max_pair_dist: float | None = None,
    min_count_fraction: float = 0.2,
):
    """Estimate the helical pitch from same-class pair distances (Å).

    The fundamental peak of the pair-distance histogram sits at
    pitch / csym. Peaks are detected on the histogram above
    ``min_count_fraction`` of its maximum; the estimate refines the
    first peak's position by the centroid of its bin neighborhood, then
    cross-checks against higher harmonics when present.

    Returns dict(pitch, twist (if rise given, else None), peak_dist,
    histogram=(centers, counts), harmonics=[peak positions]).
    """
    from scipy.signal import find_peaks

    distances = (
        np.fromiter(distances, float)
        if not isinstance(distances, (np.ndarray, list, tuple))
        else distances
    )
    d = np.asarray(distances, float).ravel()
    if max_pair_dist is not None and max_pair_dist > 0:
        d = d[d <= max_pair_dist]
    if d.size < 4:
        return dict(
            pitch=None, twist=None, peak_dist=None,
            histogram=(np.array([]), np.array([])), harmonics=[],
        )
    counts, edges = np.histogram(d, bins=bins)
    centers = (edges[:-1] + edges[1:]) / 2
    # pad so boundary bins are peak-eligible (the fundamental often sits
    # in the FIRST bin: the histogram starts at the minimum distance)
    padded = np.concatenate(([0], counts, [0]))
    peaks, _ = find_peaks(padded, height=min_count_fraction * counts.max())
    peaks = [p - 1 for p in peaks]
    if len(peaks) == 0:
        peaks = [int(np.argmax(counts))]
    harmonics = [float(centers[p]) for p in peaks]
    # fundamental = first peak; refine by local centroid over +-2 bins
    p0 = peaks[0]
    lo, hi = max(0, p0 - 2), min(len(centers), p0 + 3)
    w = counts[lo:hi].astype(float)
    peak_dist = float(np.sum(centers[lo:hi] * w) / max(w.sum(), 1e-12))
    # harmonic cross-check: if later peaks sit near integer multiples,
    # average their implied fundamentals for a better estimate
    implied = [peak_dist]
    for h in harmonics[1:]:
        k = round(h / peak_dist)
        if k >= 2 and abs(h / k - peak_dist) < 0.15 * peak_dist:
            implied.append(h / k)
    peak_dist = float(np.mean(implied))
    pitch = peak_dist * csym
    twist = None
    if rise is not None and rise > 0:
        twist = 360.0 * rise / pitch
    return dict(
        pitch=pitch, twist=twist, peak_dist=peak_dist,
        histogram=(centers, counts), harmonics=harmonics,
    )


def estimate_pitch_from_class2d(params, class_indices=None, csym: int = 1,
                                rise: float | None = None, target_total_count: int = -1,
                                device="cuda", **kwargs):
    """End-to-end: Class2D params DataFrame -> pitch estimate.

    params: RELION-convention DataFrame (rlnMicrographName,
    rlnHelicalTubeID, rlnHelicalTrackLengthAngst, rlnClassNumber,
    rlnAnglePsi) as produced by
    whereIsMyClass.compute.get_class2d_params_from_file.
    class_indices: 0-based class selection (default: all classes). The
    pair distances are computed on ``device``.
    """
    from ..webApps.whereIsMyClass.compute import (
        compute_pair_distances,
        get_filament_length,
        select_classes,
    )

    if class_indices is None:
        class_indices = sorted(
            int(c) - 1 for c in np.unique(params["rlnClassNumber"])
        )
    helices = select_classes(params, class_indices)
    lengths = get_filament_length(helices)
    dists, _ = compute_pair_distances(
        helices, lengths=lengths, target_total_count=target_total_count, device=device
    )
    return estimate_pitch_from_pair_distances(
        dists, csym=csym, rise=rise, **kwargs
    )
