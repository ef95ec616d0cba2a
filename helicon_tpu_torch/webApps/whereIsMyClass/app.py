"""whereIsMyClass Shiny Express app (requires the `shiny` extra; the
micrograph/histogram figures additionally need plotly + shinywidgets,
exactly like the reference).

A copy of ``helicon_tpu/webApps/whereIsMyClass/app.py`` on the port: the
same page, inputs and reactive graph, with the micrographs, the class
projections and the pair distances computed on the device ``DEVICE`` of
``helicon_tpu_torch.webApps.whereIsMyClass`` (the card; the tests set it
to "cpu" before the import). Reference: webApps/whereIsMyClass/app.py
(655 LoC). Workflow parity:

- Class2D params ingest (.star/.cs) with per-helix length/ID annotation
  (reference app.py:403-437)
- class-average gallery with abundance sort + blank filter and
  multi-select (466-510)
- helices table for the selected classes; picking a row loads its
  micrograph with band-pass/resample controls (513-556)
- per-class markers on the micrograph with a marked-classes checkbox
  group incl. select/unselect-all (557-641)
- pair-distance histogram with per-bin pitch->twist crosshair info
  (compute.plot_histogram)
- interactive distance measurement: two clicks on the micrograph draw a
  dotted measurement line and report the distance (642-655)

All figure/metric computation lives in :mod:`compute` (unit tested);
this file is the reactive wiring.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pandas as pd

try:
    from shiny import reactive, req
    # Express-style page: ui/render/input MUST come from shiny.express
    # (core shiny.ui has no page_opts and its containers are not
    # context managers — the app would crash at launch)
    from shiny.express import input, output, render, ui  # noqa: F401
except ImportError as e:  # pragma: no cover - gated on the shiny extra
    raise ImportError(
        "the whereIsMyClass web app requires the optional 'shiny' extra"
    ) from e

try:  # figures degrade to static tables when plotly is absent
    from shinywidgets import render_widget

    _HAS_WIDGETS = True
except ImportError:  # pragma: no cover
    _HAS_WIDGETS = False

from helicon_tpu_torch.utils.shiny import image_select, int_or as _int, numeric_or as _num
from helicon_tpu_torch.utils.system import encode_numpy
from helicon_tpu_torch.webApps import whereIsMyClass as _package
from helicon_tpu_torch.webApps.whereIsMyClass import compute

# the device of every computation of this session
DEVICE = _package.DEVICE

ui.page_opts(title="whereIsMyClass (helicon-tpu-torch)", fillable=True)

# ---------------------------------------------------------------- state
params = reactive.value(None)
project_root_dir = reactive.value(None)
filepath_classes = reactive.value(None)
data_all = reactive.value(None)  # (class images, apix)
abundance = reactive.value(None)
displayed_class_ids = reactive.value([])
selected_class_ids = reactive.value([])  # 0-based class indices
displayed_micrograph_filename = reactive.value(None)
displayed_micrograph_data = reactive.value(None)
displayed_micrograph_apix_original = reactive.value(1.0)
displayed_helix_ids = reactive.value([])
displayed_helices_class_ids = reactive.value([])
first_point = reactive.value(None)
second_point = reactive.value(None)
_micrograph_fig = {"fig": None}

# ---------------------------------------------------------------- sidebar
with ui.sidebar(width="30vw"):
    # primary input: a SERVER-SIDE path (the reference uses an
    # ipyfilechooser on the server — app.py:66-76). A browser upload only
    # copies the metadata file into a temp dir, so the sibling class
    # stack and project micrographs would never resolve.
    ui.input_text(
        "param_path", "Server path to Class2D metadata (.star/.cs)", ""
    )
    ui.input_action_button("load_param_path", "Load")
    ui.input_file(
        "param_file",
        "... or upload (distances only; micrographs need the server path)",
    )
    ui.input_checkbox("sort_abundance", "Sort classes by abundance", True)
    ui.input_checkbox("ignore_blank", "Ignore blank classes", True)
    ui.input_numeric("target_apix", "Micrograph display pixel size (A)", 5.0)
    ui.input_numeric("low_pass_angstrom", "Low-pass (A)", 20.0)
    ui.input_numeric("high_pass_angstrom", "High-pass (A)", 0.0)
    ui.input_numeric("marker_size", "Class marker size", 10)
    ui.input_numeric("max_pair_dist", "Max pair distance (A)", -1)
    ui.input_numeric("rise", "Rise (A) for pitch->twist crosshairs", 4.75)
    ui.input_text("csyms", "Csyms for crosshairs (comma)", "1,2,3")
    ui.input_numeric("bins", "Histogram bins", 100)
    ui.input_checkbox("log_y", "Log-scale histogram counts", True)
    ui.input_checkbox_group(
        "marked_helices_classes",
        "Mark these classes (decreasing abundance):",
        choices=[],
    )
    ui.input_action_button("select_all_marked_helices_classes", "Select all")
    ui.input_action_button("unselect_all_marked_helices_classes", "Unselect all")


# ---------------------------------------------------------------- ingest
@reactive.effect
@reactive.event(input.load_param_path)
def get_params_from_server_path():
    filepath = (input.param_path() or "").strip()
    req(filepath)
    import pathlib

    if not pathlib.Path(filepath).exists():
        ui.modal_show(
            ui.modal(f"{filepath} does not exist on the server",
                     title="File not found", easy_close=True, footer=None)
        )
        return
    _load_params(filepath)


@reactive.effect
@reactive.event(input.param_file)
def get_params_from_file():
    f = input.param_file()
    req(f)
    _load_params(f[0]["datapath"])


def _load_params(filepath):
    project_root_dir.set(compute.get_project_root_dir(filepath))
    filepath_classes.set(compute.get_class_file(filepath))
    try:
        df = compute.get_class2d_params_from_file(filepath)
        # per-helix length + sequential helixID (reference app.py:415-421)
        helices = df.groupby(["rlnMicrographName", "rlnHelicalTubeID"])
        for hi, (_, helix) in enumerate(helices):
            length = helix["rlnHelicalTrackLengthAngst"].astype(float).max().round()
            df.loc[helix.index, "length"] = length
            df.loc[helix.index, "helixID"] = hi + 1
        params.set(df)
    except Exception as e:
        ui.modal_show(
            ui.modal(
                f"failed to read class2D parameters from {filepath}: {e}",
                title="File read error", easy_close=True, footer=None,
            )
        )


@reactive.effect
@reactive.event(filepath_classes)
def get_2d_images_from_files():
    fc = filepath_classes.get()
    req(fc)
    try:
        if isinstance(fc, list):
            data, apix, _ = compute.get_class3d_projections_from_files(fc, device=DEVICE)
        else:
            data, apix = compute.get_class2d_from_file(fc)
        data_all.set((np.asarray(data), float(apix)))
    except Exception:
        ui.modal_show(
            ui.modal(
                f"failed to read 2D class average images from {fc}",
                title="File read error", easy_close=True, footer=None,
            )
        )


@reactive.effect
@reactive.event(params, data_all, input.ignore_blank, input.sort_abundance)
def get_displayed_class_ids():
    df = params.get()
    da = data_all.get()
    req(df is not None and da is not None)
    data, apix = da
    n = len(data)
    abundance.set(compute.get_class_abundance(df, n))
    order = np.arange(n, dtype=int)
    if input.sort_abundance():
        order = np.argsort(abundance.get())[::-1]
    if input.ignore_blank():
        order = [i for i in order if np.max(data[i]) > np.min(data[i])]
    displayed_class_ids.set(list(map(int, order)))


@reactive.effect
@reactive.event(input.select_class)
def toggle_selected_class():
    i = int(input.select_class())
    ids = displayed_class_ids.get()
    req(0 <= i < len(ids))
    cid = ids[i]
    sel = list(selected_class_ids.get())
    if cid in sel:
        sel.remove(cid)
    else:
        sel.append(cid)
    selected_class_ids.set(sel)


def _selected_helices():
    df = params.get()
    sel = selected_class_ids.get()
    if df is None or not sel:
        return None, None
    helices = compute.select_classes(df, sel)
    lengths = compute.get_filament_length(helices)
    return helices, lengths


def _helices_table():
    """One row per helix of the selected classes (micrograph, helixID,
    length, classes present) — the selection table of app.py:466-510."""
    helices, lengths = _selected_helices()
    if helices is None:
        return pd.DataFrame()
    rows = []
    for ((mic, tid), g), length in zip(helices, lengths):
        rows.append(
            dict(
                helixID=int(g["helixID"].iloc[0]),
                rlnMicrographName=str(mic),
                length=float(length),
                classes=",".join(
                    str(int(c)) for c in sorted(g["rlnClassNumber"].unique())
                ),
            )
        )
    return pd.DataFrame(rows).sort_values("length", ascending=False)


# ------------------------------------------------- micrograph + markers
@reactive.effect
@reactive.event(input.helices_table_selected_rows)
def get_selected_helices():
    rows = input.helices_table_selected_rows()
    req(rows)
    table = _helices_table()
    req(len(table))
    helix = table.iloc[int(rows[0])]
    root = project_root_dir.get()
    micrograph = pathlib.Path(root or ".") / helix["rlnMicrographName"]
    if not micrograph.exists():
        ui.modal_show(
            ui.modal(
                f"{micrograph} is not available",
                title="ERROR: micrograph not available",
                easy_close=True, footer=None,
            )
        )
        return
    displayed_micrograph_filename.set(micrograph)
    displayed_helix_ids.set([int(helix["helixID"])])
    class_ids = list(map(int, str(helix["classes"]).split(",")))
    displayed_helices_class_ids.set(class_ids)
    choices = [str(c) for c in class_ids]
    ui.update_checkbox_group(
        "marked_helices_classes", choices=choices, selected=choices
    )


@reactive.effect
@reactive.event(
    displayed_micrograph_filename,
    input.target_apix,
    input.low_pass_angstrom,
    input.high_pass_angstrom,
)
def load_micrograph():
    fn = displayed_micrograph_filename.get()
    req(fn)
    data, apix, apix_original = compute.get_micrograph(
        filename=fn,
        target_apix=_num(input.target_apix(), 5.0),
        low_pass_angstrom=_num(input.low_pass_angstrom(), 20.0),
        high_pass_angstrom=_num(input.high_pass_angstrom(), 0.0),
        device=DEVICE,
    )
    displayed_micrograph_data.set((np.asarray(data), float(apix)))
    displayed_micrograph_apix_original.set(float(apix_original))


@reactive.effect
@reactive.event(input.select_all_marked_helices_classes)
def select_all_marked():
    choices = [str(c) for c in displayed_helices_class_ids.get()]
    ui.update_checkbox_group(
        "marked_helices_classes", choices=choices, selected=choices
    )


@reactive.effect
@reactive.event(input.unselect_all_marked_helices_classes)
def unselect_all_marked():
    choices = [str(c) for c in displayed_helices_class_ids.get()]
    ui.update_checkbox_group(
        "marked_helices_classes", choices=choices, selected=[]
    )


def _marked_class_xys():
    """{(helix_id, class_id): dict(x=[A], y=[A])} for the marker overlay
    (reference app.py:599-621)."""
    df = params.get()
    if df is None:
        return {}
    apix = displayed_micrograph_apix_original.get()
    xys = {}
    for helix_id in displayed_helix_ids.get():
        for class_id in input.marked_helices_classes():
            mask = (df["helixID"] == helix_id) & (
                df["rlnClassNumber"] == int(class_id)
            )
            xys[(helix_id, int(class_id))] = dict(
                x=df.loc[mask, "rlnCoordinateX"].values * apix,
                y=df.loc[mask, "rlnCoordinateY"].values * apix,
            )
    return xys


if _HAS_WIDGETS:

    @render_widget
    def display_micrograph():
        md = displayed_micrograph_data.get()
        req(md is not None)
        data, apix = md
        fig = compute.plot_micrograph(
            data,
            title=str(
                pathlib.Path(str(displayed_micrograph_filename.get())).name
            ),
            apix=apix,
        )
        _micrograph_fig["fig"] = fig
        fig.data[0].on_click(_on_micrograph_click)
        return fig

    def _on_micrograph_click(trace, points, state):
        if not len(points.xs):
            return
        p = (float(points.xs[0]), float(points.ys[0]))
        if first_point.get() is None or second_point.get() is not None:
            first_point.set(p)
            second_point.set(None)
        else:
            second_point.set(p)

    @reactive.effect
    @reactive.event(
        input.marked_helices_classes, displayed_micrograph_data
    )
    def mark_classes_on_micrograph():
        fig = _micrograph_fig["fig"]
        req(fig is not None)
        compute.mark_classes_on_helices(
            fig=fig,
            helices=_marked_class_xys(),
            marker_size=_int(input.marker_size(), 10),
        )

    @reactive.effect
    @reactive.event(first_point, second_point, ignore_none=False)
    def display_distance_measurement():
        fig = _micrograph_fig["fig"]
        req(fig is not None)
        compute.draw_distance_measurement(
            fig=fig,
            first_point=first_point.get(),
            second_point=second_point.get(),
        )

    @render_widget
    def pair_distance_histogram():
        helices, lengths = _selected_helices()
        req(helices is not None)
        dists, _ = compute.compute_pair_distances(helices, lengths, device=DEVICE)
        req(len(dists))
        csyms = [
            int(c) for c in str(input.csyms()).split(",") if c.strip()
        ]
        return compute.plot_histogram(
            dists,
            title=f"{len(dists):,} same-class pair distances",
            xlabel="Pair distance (A)",
            ylabel="Count",
            max_pair_dist=_num(input.max_pair_dist(), -1),
            bins=_int(input.bins(), 100),
            log_y=bool(input.log_y()),
            show_pitch_twist=dict(rise=_num(input.rise(), 4.75), csyms=csyms),
            multi_crosshair=True,
        )

else:  # plotly-free fallbacks keep the app usable

    @render.ui
    def display_micrograph():
        md = displayed_micrograph_data.get()
        if md is None:
            return ui.p("Pick a helix row to display its micrograph.")
        return ui.tags.img(src=encode_numpy(md[0]), width="100%")

    @render.ui
    def pair_distance_histogram():
        helices, lengths = _selected_helices()
        if helices is None:
            return None
        dists, _ = compute.compute_pair_distances(helices, lengths, device=DEVICE)
        if not len(dists):
            return ui.p("no pair distances for the selected classes")
        hist, edges = np.histogram(dists, bins=max(1, _int(input.bins(), 100)))
        rows = [
            ui.tags.tr(
                ui.tags.td(f"{0.5 * (edges[i] + edges[i + 1]):.0f}"),
                ui.tags.td(str(int(hist[i]))),
            )
            for i in np.argsort(hist)[::-1][:20]
        ]
        return ui.tags.table(
            ui.tags.tr(ui.tags.th("distance (A)"), ui.tags.th("count")), *rows
        )


# ---------------------------------------------------------------- panels
@render.ui
def class_gallery():
    da = data_all.get()
    ids = displayed_class_ids.get()
    if da is None or not ids:
        return ui.p("Load a Class2D star/cs file.")
    data, apix = da
    ab = abundance.get()
    labels = [f"{i + 1}: {int(ab[i]):,d}" for i in ids]
    # highlight the selected classes (displayed-index space): reading
    # selected_class_ids here also makes the gallery re-render on click
    sel = [ids.index(c) for c in selected_class_ids.get() if c in ids]
    return image_select(
        "select_class",
        f"{len(ids)}/{len(data)} classes | "
        f"{data[0].shape[1]}x{data[0].shape[0]} pixels | {apix} A/pixel",
        [np.asarray(data[i]) for i in ids],
        image_labels=labels,
        image_size=96,
        initial_selected_indices=sel,
    )


@render.data_frame
def helices_table():
    table = _helices_table()
    return render.DataGrid(table, selection_mode="row", height="300px")


@render.text
def distance_readout():
    p1, p2 = first_point.get(), second_point.get()
    if p1 is None or p2 is None:
        return "Click two points on the micrograph to measure a distance."
    d = float(np.hypot(p2[0] - p1[0], p2[1] - p1[1]))
    return f"measured distance: {d:.1f} A"
