"""whereIsMyClass compute layer: micrograph resampling and band-pass,
project-layout inference, class selection, the same-class same-polarity
pair distances, class abundance, 3D-class projection sheets, Class2D
parameter ingest from STAR / CS files, and the plotly figure builders.

Counterpart of ``helicon_tpu/webApps/whereIsMyClass/compute.py``. The
pixel work and the pair distances run on ``device`` (the card by
default): ``get_micrograph`` :69 (the block mean and scipy's grid-mode
linear zoom of ``_resize_local_mean`` :40, then the band-pass),
``compute_pair_distances`` :135 (every filament's pairs in one padded
pass) and ``get_one_map_xyz_projects`` :202. The rest is host pandas /
numpy, copied. tests/test_torch_whereismyclass.py pins the port to the
original.
"""

from __future__ import annotations

import logging
import pathlib

import numpy as np
import torch

from ...core.filters import low_high_pass_filter
from ...core.interp import map_coordinates
from ...io.mrc import mrc_header, read_mrc
from ...utils.cache import cache, setup_cache_dir
from ...utils.tensors import on_device

logger = logging.getLogger(__name__)

_cache_dir = setup_cache_dir()

# bytes of float64 pair tables one pass of compute_pair_distances may hold
PAIR_CHUNK_BYTES = 1 << 28


def get_project_root_dir(param_file: str):
    """RELION (star: 3 levels up) / CryoSPARC (cs: 2 levels up) project
    root."""
    f = pathlib.Path(param_file)
    if param_file.endswith(".star"):
        return f.parent.parent.parent
    if param_file.endswith(".cs"):
        return f.parent.parent
    return None


def _grid_zoom_linear(data: torch.Tensor, output_shape) -> torch.Tensor:
    """scipy.ndimage.zoom(order=1, grid_mode=True, mode="grid-constant")
    of a 2D tensor, in float64: output pixel k samples the input at
    (k + 0.5) * n_in / n_out - 0.5 (pixel edges aligned), with zeros
    beyond the edges."""
    coords = []
    for ax, (n_in, n_out) in enumerate(zip(data.shape, output_shape)):
        c = (torch.arange(n_out, dtype=torch.float64, device=data.device) + 0.5) * (
            n_in / n_out) - 0.5
        coords.append(c[:, None] if ax == 0 else c[None, :])
    return map_coordinates(data.to(torch.float64), coords, order=1, mode="grid-constant")


def _resize_local_mean(data, output_shape, device="cuda") -> torch.Tensor:
    """Anti-aliased local-mean resize (a float32 tensor on the data's
    device, or ``device``): an integer-factor block mean over the whole
    field when downscaling, then a grid-mode linear zoom to the exact
    target shape."""
    data = on_device(data, device)
    ny, nx = data.shape
    oy, ox = output_shape
    if oy <= ny and ox <= nx:
        fy, fx = max(1, ny // oy), max(1, nx // ox)
        if fy > 1 or fx > 1:
            by, bx = ny // fy, nx // fx
            data = data[: by * fy, : bx * fx].reshape(by, fy, bx, fx).mean(dim=(1, 3))
            ny, nx = data.shape
            if (ny, nx) == (oy, ox):
                return data
    return _grid_zoom_linear(data, (oy, ox)).to(torch.float32)


def get_micrograph(filename, target_apix: float, low_pass_angstrom: float,
                   high_pass_angstrom: float, device="cuda"):
    """Load, resample and band-pass one micrograph on ``device``.
    Returns (data as numpy float32, target_apix, original_apix)."""
    data, apix = read_mrc(filename, mmap=True)
    data = torch.as_tensor(np.array(np.squeeze(data), np.float32), device=device)
    apix = round(float(apix), 4)
    ny, nx = data.shape
    new_ny = int(ny * apix / target_apix + 0.5) // 2 * 2
    new_nx = int(nx * apix / target_apix + 0.5) // 2 * 2
    data = _resize_local_mean(data, (new_ny, new_nx))
    if low_pass_angstrom > 0 or high_pass_angstrom > 0:
        data = low_high_pass_filter(
            data,
            low_pass_fraction=2 * target_apix / low_pass_angstrom if low_pass_angstrom > 0 else 0,
            high_pass_fraction=(2 * target_apix / high_pass_angstrom
                                if high_pass_angstrom > 0 else 0),
        )
    return data.cpu().numpy(), target_apix, apix


def get_class_file(param_file: str):
    """Class-average stack path from the metadata file path."""
    f = pathlib.Path(param_file)
    if param_file.endswith(".star"):
        if "Class3D" in f.as_posix():
            return sorted(f.parent.glob(f.stem[:10] + "class*.mrc"))
        return f.parent / (f.stem[:10] + "classes.mrcs")
    if param_file.endswith(".cs"):
        return f.parent / (f.stem[:7] + "class_averages.mrc")
    return None


def get_filament_length(helices, particle_box_length: float = 0):
    """Per-filament length from track extents."""
    lengths = []
    for _, g in helices:
        t = g["rlnHelicalTrackLengthAngst"].astype(float).values
        lengths.append(t.max() - t.min() + particle_box_length)
    return lengths


def select_classes(params, class_indices):
    """(micrograph, tube) groups of particles in the 0-based classes."""
    mask = params["rlnClassNumber"].astype(int).isin(np.asarray(class_indices) + 1)
    particles = params.loc[mask, :]
    return list(particles.groupby(["rlnMicrographName", "rlnHelicalTubeID"]))


def select_helices_from_helixID(params, ids):
    mask = params["helixID"].astype(int).isin(ids)
    return list(
        params.loc[mask, :].groupby(["rlnMicrographName", "rlnHelicalTubeID"])
    )


def _padded_helices(helices, order):
    """Track position, psi and class code (float64 / int64, (H, L)) of the
    helices in ``order``; padding has class -1."""
    import pandas as pd

    frames = [helices[i][1] for i in order]
    n = np.array([len(f) for f in frames], np.int64)
    H, L = len(frames), int(n.max()) if len(frames) else 0
    pos = np.zeros((H, L))
    psi = np.zeros((H, L))
    cls = np.full((H, L), -1, np.int64)
    if H:
        rows = np.repeat(np.arange(H), n)
        cols = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        def column(name):
            return np.concatenate([f[name].to_numpy() for f in frames])

        pos[rows, cols] = column("rlnHelicalTrackLengthAngst").astype(float)
        psi[rows, cols] = column("rlnAnglePsi").astype(float)
        cls[rows, cols] = pd.factorize(column("rlnClassNumber"))[0]
    return pos, psi, cls


def _pair_table(pos, psi, cls, device):
    """Distances (H, L, L) float64 and the mask of the pairs that count:
    i < j, one class, one polarity (|psi_i - psi_j| wrapped < 90) and
    d > 0."""
    pos = torch.as_tensor(pos, device=device)
    psi = torch.as_tensor(psi, device=device)
    cls = torch.as_tensor(cls, device=device)
    L = pos.shape[1]
    d = torch.abs(pos[:, :, None] - pos[:, None, :])
    dpsi = psi[:, :, None] - psi[:, None, :]
    same_polarity = torch.abs(torch.remainder(dpsi + 180, 360) - 180) < 90
    upper = torch.ones(L, L, dtype=torch.bool, device=device).triu(1)
    mask = (upper & same_polarity & (cls[:, :, None] == cls[:, None, :])
            & (cls[:, :, None] >= 0) & (d > 0))
    return d, mask


def compute_pair_distances(helices, lengths=None, target_total_count: int = -1,
                           device="cuda"):
    """Same-class same-polarity segment pair distances, longest filaments
    first until the target count. Returns (sorted distances, min filament
    length used).

    The filaments are taken in the reference's order (``np.argsort`` of
    the lengths, reversed) in passes of at most ``PAIR_CHUNK_BYTES`` of
    pair tables; each pass counts every filament's pairs on ``device``,
    so the target's break falls after the same filament. The distances
    are exact float64 differences, so the sorted result equals the
    reference's bit for bit."""
    order = (np.argsort(lengths))[::-1] if lengths is not None else np.arange(len(helices))
    stop = lengths is not None and target_total_count > 0
    sizes = [len(helices[k][1]) for k in order]
    min_len = 0
    kept = []
    total = 0
    i = 0
    while i < len(order):
        # a pass: as many filaments as the byte budget holds at the longest
        # one's padded size (~24 bytes a pair slot: distances, psi
        # differences and masks)
        j, L = i + 1, sizes[i]
        while j < len(order) and (j - i + 1) * max(L, sizes[j]) ** 2 * 24 <= PAIR_CHUNK_BYTES:
            L, j = max(L, sizes[j]), j + 1
        pos, psi, cls = _padded_helices(helices, order[i:j])
        d, mask = _pair_table(pos, psi, cls, device)
        counts = mask.sum(dim=(1, 2)).cpu().numpy()
        last = j - i
        over = np.nonzero(total + np.cumsum(counts) > target_total_count)[0] if stop else []
        if len(over):
            last = int(over[0]) + 1
            min_len = lengths[order[i + last - 1]]
        kept.append(d[:last][mask[:last]])
        total += int(counts[:last].sum())
        if len(over):
            break
        i = j
    if total == 0:
        return [], 0
    return torch.sort(torch.cat(kept)).values.cpu().numpy(), min_len


def estimate_inter_segment_distance(data):
    """Median spacing between consecutive segments."""
    dists_all = []
    for _, particles in data.groupby(
        ["rlnMicrographName", "rlnHelicalTubeID"], sort=False
    ):
        if len(particles) < 2:
            continue
        d = np.sort(particles["rlnHelicalTrackLengthAngst"].astype(float).values)
        dists_all.append(d[1:] - d[:-1])
    return float(np.median(np.hstack(dists_all)))


def get_class_abundance(params, nClass: int):
    """Particle count per class. Classes outside [1, nClass] are skipped
    with a warning."""
    abundance = np.zeros(nClass, dtype=int)
    skipped = []
    for gn, g in params.groupby("rlnClassNumber"):
        i = int(gn) - 1
        if 0 <= i < nClass:
            abundance[i] = len(g)
        else:
            skipped.append(int(gn))
    if skipped:
        logger.warning(
            "params reference class(es) %s but the class stack has only "
            "%d images — mismatched files?", skipped, nClass,
        )
    return abundance


@cache(cache_dir=str(_cache_dir / "whereIsMyClass"), ignore=["device"], expires_after=7,
       verbose=0)
def get_one_map_xyz_projects(data, nx, device="cuda"):
    """[central z-slice | y-projection | x-projection] sheet of one 3D
    class (numpy in and out, computed on ``device``), min-max normalized
    with a constant-map guard; 1-pixel separators between panels."""
    data = on_device(data, device)
    lo, hi = data.min(), data.max()
    if float(hi - lo) != 0:
        data = (data - lo) / (hi - lo)
    sheet = torch.zeros((nx, nx * 3 + 2), dtype=torch.float32, device=data.device)
    sheet[:, 0:nx] = data[int(nx / 2), :, :] * nx
    sheet[:, nx + 1: nx * 2 + 1] = data.sum(dim=1)
    sheet[:, nx * 2 + 2: nx * 3 + 2] = data.sum(dim=2)
    return sheet.cpu().numpy()


def get_class3d_projections_from_files(classFiles, device="cuda"):
    """Projection sheets for a list of 3D class maps."""
    projections = []
    apix, nx = 1.0, 0
    for f in classFiles:
        data, apix = read_mrc(f)
        nx = int(mrc_header(f).nx)
        projections.append(get_one_map_xyz_projects(np.asarray(data), nx, device=device))
    return np.array(projections), apix, nx


# ---------------------------------------------------------------------------
# Class2D parameter ingest
# ---------------------------------------------------------------------------


def star_to_dataframe(starFile):
    """RELION v3 star -> particles DataFrame with the optics table in
    .attrs. Requires both blocks. ``starfile.read`` is the load seam when
    that package is importable; the native STAR reader otherwise."""
    from ...utils.system import optional_loader

    starfile = optional_loader("starfile", "read")
    if starfile is not None:
        blocks = starfile.read(starFile, always_dict=True)
    else:
        from ...io.star import read_star

        blocks = read_star(starFile)
    if "optics" not in blocks or "particles" not in blocks:
        raise AssertionError(
            f"{starFile} has {' '.join(blocks.keys())} but optics and "
            "particles are expected"
        )
    data = blocks["particles"]
    data.attrs["optics"] = blocks["optics"]
    data.attrs["starFile"] = str(starFile)
    return data


def cs_to_dataframe(cs_file):
    """CryoSPARC Class2D .cs -> RELION-convention DataFrame: 1-indexed
    rlnClassNumber, per-micrograph filament UID remap when UIDs are
    global, fractional -> pixel coordinates."""
    import pandas as pd

    from ...io.cs import read_cs

    cs = read_cs(cs_file)
    data = pd.DataFrame.from_records(cs.tolist(), columns=cs.dtype.names)
    required = (
        "blob/idx blob/path filament/filament_uid filament/arc_length_A "
        "alignments2D/class alignments2D/pose location/center_x_frac "
        "location/center_y_frac location/micrograph_shape".split()
    )
    missing = [a for a in required if a not in data]
    if missing:
        raise ValueError(
            f"required attrs '{', '.join(missing)}' are not included in "
            f"{cs_file}. If the particles were imported from a RELION star "
            "file, run: helicon images2star <cs file> <output star> "
            "--copyParm <original star file>"
        )

    def _str(col):
        s = data[col]
        return s.str.decode("utf-8") if s.dtype == object and isinstance(
            s.iloc[0], bytes
        ) else s.astype(str)

    ret = pd.DataFrame()
    ret["rlnImageName"] = (
        (data["blob/idx"].astype(int) + 1).map("{:06d}".format)
        + "@"
        + _str("blob/path")
    )
    if "micrograph_blob/path" in data:
        ret["rlnMicrographName"] = _str("micrograph_blob/path")
    else:
        ret["rlnMicrographName"] = _str("blob/path")

    uids = data["filament/filament_uid"]
    if uids.min() > 1000:
        # global CryoSPARC UIDs: renumber 1..n per micrograph
        for _, m in data.groupby("blob/path"):
            mapping = {
                v: i + 1 for i, v in enumerate(sorted(m["filament/filament_uid"].unique()))
            }
            ret.loc[m.index, "rlnHelicalTubeID"] = m["filament/filament_uid"].map(mapping)
        ret["rlnHelicalTubeID"] = ret["rlnHelicalTubeID"].astype(int)
    else:
        ret["rlnHelicalTubeID"] = uids.astype(int)

    ret["rlnHelicalTrackLengthAngst"] = (
        data["filament/arc_length_A"].astype(np.float32).values.round(2)
    )
    shapes = np.stack(data["location/micrograph_shape"].values)
    my, mx = shapes[:, 0], shapes[:, 1]
    ret["rlnCoordinateX"] = (
        (data["location/center_x_frac"] * mx).astype(float).round(2)
    )
    ret["rlnCoordinateY"] = (
        (data["location/center_y_frac"] * my).astype(float).round(2)
    )
    ret["rlnClassNumber"] = data["alignments2D/class"].astype(int) + 1
    return ret


def get_class2d_from_file(classFile):
    """(class averages ndarray, apix) from a 2D class .mrc(s) stack.
    ``mrcfile.open`` is the load seam when that package is importable;
    the native MRC reader otherwise."""
    from ...utils.system import optional_loader

    mrcfile = optional_loader("mrcfile", "open")
    if mrcfile is not None:
        with mrcfile.open(classFile) as mrc:
            apix = round(float(mrc.voxel_size.x), 4)
            data = np.asarray(mrc.data)
    else:
        data, apix = read_mrc(classFile)
        data = np.asarray(data)
    # always (n_classes, ny, nx), whichever reader loaded it
    if data.ndim == 2:
        data = data[np.newaxis]
    return data, apix


def get_class2d_params_from_file(params_file):
    """Dispatch .star/.cs Class2D metadata and validate required columns."""
    pf = str(params_file)
    if pf.endswith(".star"):
        params = star_to_dataframe(pf)
    elif pf.endswith(".cs"):
        params = cs_to_dataframe(pf)
    else:
        raise ValueError(
            f"{params_file} is not a valid Class2D parameter file. "
            "Only star or cs files are supported"
        )
    required = (
        "rlnImageName rlnHelicalTubeID rlnHelicalTrackLengthAngst "
        "rlnClassNumber rlnCoordinateX rlnCoordinateY".split()
    )
    missing = [a for a in required if a not in params]
    if missing:
        raise ValueError(f"parameters {missing} are not available")
    return params


# ---------------------------------------------------------------------------
# plotly figure builders (plotly is optional and imported lazily)
# ---------------------------------------------------------------------------

# marker glyphs cycled independently of the 10-color plotly palette:
# (10 colors) x (14 glyphs) = 140 distinct (color, symbol) combinations
# before any two class overlays look identical
_MARKER_GLYPHS = (
    "circle", "square", "diamond", "cross", "x", "triangle-up",
    "triangle-down", "triangle-left", "triangle-right", "pentagon",
    "hexagon", "octagon", "star", "bowtie",
)


def _plotly():
    try:
        import plotly
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError(
            "plotly is required for the whereIsMyClass figures: "
            "pip install plotly"
        ) from e
    return plotly, go


def _figure_layout(title, *, width=None, height=None, **axis_overrides):
    """Base layout shared by the figures: centered small-font title,
    white background, explicit or auto sizing."""
    layout = dict(
        title=dict(text=title, x=0.5, y=0.95, xanchor="center",
                   font=dict(size=14)),
        plot_bgcolor="white",
        showlegend=False,
        margin=dict(l=0, r=0, t=50, b=0),
    )
    if width:
        layout["width"] = width
    if height:
        layout["height"] = height
    if not (width or height):
        layout["autosize"] = True
    layout.update(axis_overrides)
    return layout


def plot_micrograph(micrograph, title, apix, plot_height=None, plot_width=None):
    """Grey heatmap of a micrograph in physical (A) coordinates, y axis
    image-convention (reversed) and aspect-locked to x."""
    _, go = _plotly()
    z = np.asarray(micrograph)
    h, w = z.shape
    fig = go.FigureWidget(
        data=[
            go.Heatmap(
                name="image",
                z=z,
                x=np.arange(w) * apix,
                y=np.arange(h) * apix,
                colorscale="Greys",
                showscale=False,
                hoverongaps=False,
            )
        ]
    )
    fig.update_layout(
        **_figure_layout(
            title,
            width=plot_width,
            height=plot_height,
            xaxis=dict(visible=False, range=[0, w * apix]),
            yaxis=dict(visible=False, range=[0, h * apix],
                       scaleanchor="x", autorange="reversed"),
        )
    )
    return fig


def mark_classes_on_helices(fig, helices, marker_size):
    """Replace the figure's class-marker overlay: one scatter trace per
    (helix, class) keyed "class_<id>", styled from the cycled palette x
    glyph table.

    helices: {(helix_id, class_id): {"x": [...], "y": [...]}}
    """
    plotly, go = _plotly()
    assert fig is not None
    fig.data = tuple(d for d in fig.data if not d.name.startswith("class_"))
    if not helices:
        return
    palette = plotly.colors.qualitative.Plotly
    glyphs = _MARKER_GLYPHS
    fig.add_traces(
        [
            go.Scatter(
                name=f"class_{class_id}",
                x=xy["x"],
                y=xy["y"],
                mode="markers",
                marker=dict(
                    size=marker_size,
                    color=palette[i % len(palette)],
                    opacity=0.6,
                    symbol=glyphs[i % len(glyphs)],
                ),
            )
            for i, ((_hid, class_id), xy) in enumerate(helices.items())
        ]
    )


def draw_distance_measurement(fig, first_point, second_point):
    """Dotted white line between two picked points; with either point
    unset, any existing measurement line is removed instead."""
    _, go = _plotly()
    assert fig is not None
    kept = tuple(d for d in fig.data if d.name != "distance_line")
    if first_point is None or second_point is None:
        if len(kept) < len(fig.data):
            fig.data = kept
        return
    fig.data = kept
    fig.add_trace(
        go.Scatter(
            name="distance_line",
            x=(first_point[0], second_point[0]),
            y=(first_point[1], second_point[1]),
            mode="lines",
            line=dict(color="white", dash="dot"),
        )
    )


def _histogram_bin_labels(hist, edges, centers, pitch_twist):
    """Per-bin hover strings: count + optional pitch->twist readout
    (twist = 360 / (pitch * csym / rise)) for each requested csym."""
    labels = []
    for c, lo, hi, n in zip(centers, edges[:-1], edges[1:], hist):
        parts = [f"{c:.0f} ({lo:.0f}-{hi:.0f})Å: {n}"]
        if pitch_twist:
            rise = pitch_twist["rise"]
            parts += [
                f"Twist for C{csym}: {360 / (c * csym / rise):.2f}°"
                for csym in pitch_twist["csyms"]
            ]
        labels.append("<br>".join(parts))
    return labels


def plot_histogram(
    data,
    title,
    xlabel,
    ylabel,
    max_pair_dist=None,
    bins=50,
    log_y=True,
    show_pitch_twist=None,
    multi_crosshair=False,
    fig=None,
):
    """Pair-distance histogram bar figure; log10(1+count) display by
    default and per-bin pitch->twist hover info. Passing an existing fig
    updates its bar trace in place (the app's live-update path)."""
    _, go = _plotly()
    data = np.asarray(list(data), float)
    if max_pair_dist is not None and max_pair_dist > 0:
        data = data[data <= max_pair_dist]
    hist, edges = np.histogram(data, bins=bins)
    centers = (edges[:-1] + edges[1:]) / 2
    disp = np.log10(1 + hist) if log_y else hist
    hover = _histogram_bin_labels(hist, edges, centers, show_pitch_twist)
    if fig:
        fig.data[0].x = centers
        fig.data[0].y = disp
        fig.data[0].hovertext = hover
        return fig
    fig = go.FigureWidget(
        data=[go.Bar(x=centers, y=disp, hovertext=hover, name="histogram")]
    )
    fig.update_layout(
        title=dict(text=title, x=0.5),
        xaxis_title=xlabel,
        yaxis_title=(f"log10(1 + {ylabel})" if log_y else ylabel),
        plot_bgcolor="white",
    )
    return fig
