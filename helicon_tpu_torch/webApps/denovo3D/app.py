"""denovo3D Shiny Express app (requires the optional `shiny` extra).

A copy of ``helicon_tpu/webApps/denovo3D/app.py`` on the port: the same
page, inputs and reactive graph, with every computation on the device
``DEVICE`` of ``helicon_tpu_torch.webApps.denovo3D`` (the card; the tests
set it to "cpu" before the import). Reference: webApps/denovo3D/app.py
(2598 LoC). Workflow parity:

- input modes upload / url / emdb with the EMPIAR-10940 default
  (reference app.py:136-214); EMDB maps are symmetrized and projected to
  synthetic 2D inputs (1768-1790)
- clickable class-average gallery with multi-select + stitching preview
  for multi-image runs (77-125)
- per-image transform chain: negate/threshold/transpose/flip/rotation/
  y-shift/crop with auto-transform and reset (1502-1605, 2086-2250)
- grid search with incremental score-sorted display, ETA progress, and
  an abort button (2455-2523); pose refinement + score metric + fsc_test
  are exposed (2286-2452)
- top-N result rendering with reprojections (2526-2579)

The compute logic lives in the shiny-free :mod:`workflow` module (unit
tested); this file is the reactive wiring. The grid runs in launches of
candidates instead of the reference's ThreadPool, on the first "# CUDA
devices" cards (-1: every visible card, as the reference's default; the
scoring pass is sharded over them inside this process) or, where
``DEVICE`` is the CPU, on the CPU.

Control-surface parity: every reference sidebar input id exists here
either verbatim or as a pure rename —
  twist_min/twist_max -> twist_range (slider tuple), rise_min/rise_max
  -> rise_range, twisting_handedness -> handedness, top_n_results ->
  top_n, stop_denovo3D -> abort, apix -> image_index_apix, cpu ->
  n_devices (the CUDA cards), image_stitching (commented out in the
  reference) -> stitch_x_offsets + perform_stitching.
Additions: fsc_test, refine_tilt/psi/dy (CLI features also surfaced in
the app).
"""

from __future__ import annotations

import asyncio
import threading

import numpy as np
import torch

try:
    import shiny
    from shiny import reactive, req
    # Express-style page: ui/render/input MUST come from shiny.express
    # (core shiny.ui has no page_opts and its containers are not
    # context managers — the app would crash at launch)
    from shiny.express import input, output, render, ui  # noqa: F401
except ImportError as e:  # pragma: no cover - gated on the shiny extra
    raise ImportError(
        "the denovo3D web app requires the optional 'shiny' extra; "
        "use `helicon denovo3d_cli` for the batch interface"
    ) from e

import helicon_tpu_torch as helicon
from helicon_tpu_torch.denovo3d import build_candidate_grid
from helicon_tpu_torch.utils.shiny import google_analytics, image_select
from helicon_tpu_torch.utils.system import encode_numpy
from helicon_tpu_torch.webApps import denovo3D as _package
from helicon_tpu_torch.webApps.denovo3D import pipeline
from helicon_tpu_torch.webApps.denovo3D.workflow import (
    DEFAULT_URL_KEY,
    URLS,
    apply_transform_chain,
    auto_transform_params,
    combine_images_for_display,
    estimate_stitch_offsets,
    estimate_threshold_otsu,
    filter_blank_images,
    preprocess_selected_images,
    register_and_montage,
    run_grid_incremental,
    score_plot_data,
    symmetrize_projection,
)

# the device of every computation of this session
DEVICE = _package.DEVICE

ui.page_opts(title="denovo3D (helicon-tpu-torch)", fillable=True)
ui.head_content(ui.tags.title("Helicon denovo3D"))
google_analytics(tag_id="G-FDSYXQNKLX")
ui.tags.style("* { font-size: 10pt; }")

# ---------------------------------------------------------------- state
input_data = reactive.value(None)  # DotDict(data, apix, emdb_id, is_3d)
all_images = reactive.value(None)  # 2D image stack + apix
selected_indices = reactive.value([])
transformed_images = reactive.value([])
stitch_offsets = reactive.value([])
grid_progress = reactive.value(None)  # workflow.GridProgress
grid_result = reactive.value(None)
search_apix = reactive.value(None)  # effective apix after binning
_abort_flag = threading.Event()
_progress_holder: dict = {"snap": None, "done": False}


from helicon_tpu_torch.utils.shiny import (  # shared None-safe input coercers
    int_or as _int,
    numeric_or as _num,
)


def _selected_images():
    imgs = all_images.get()
    idx = selected_indices.get()
    if imgs is None or not idx:
        return []
    return [np.asarray(imgs["data"][i], np.float32) for i in idx]


# ---------------------------------------------------------------- sidebar
with ui.sidebar(width="33vw"):
    with ui.navset_pill(id="tab"):
        with ui.nav_panel("Input"):
            ui.input_checkbox(
                "show_emdb_input_mode", "Show EMDB input mode", value=True
            )

            @render.ui
            @reactive.event(input.show_emdb_input_mode)
            def input_mode_ui():
                # reference app.py gates the emdb choice on this box
                choices = ["upload", "url"] + (
                    ["emdb"] if input.show_emdb_input_mode() else []
                )
                return ui.input_radio_buttons(
                    "input_mode_images",
                    "How to obtain the input images:",
                    choices=choices,
                    selected="url",
                    inline=True,
                )

            @render.ui
            @reactive.event(input.input_mode_images)
            def input_source_ui():
                mode = input.input_mode_images()
                if mode == "upload":
                    return ui.input_file(
                        "upload_images",
                        "Upload images in MRC format (.mrcs, .mrc)",
                        accept=[".mrcs", ".mrc"],
                    )
                if mode == "url":
                    return ui.input_text(
                        "url_images",
                        "Download URL for a RELION/cryoSPARC 2D class file",
                        value=URLS[DEFAULT_URL_KEY][0],
                    )
                return ui.div(
                    ui.input_text(
                        "emdb_id",
                        "Amyloid structure EMDB ID",
                        value="EMD-14046",
                    ),
                    ui.input_action_button("randomize_emdb_id", "Randomize"),
                )

            ui.input_checkbox("is_3d", "The input is a 3D map", value=False)
            ui.input_checkbox(
                "ignore_blank", "Ignore blank input images", value=True
            )
            ui.input_numeric("image_index_apix", "Pixel size override (A)", 0.0)
            ui.input_numeric(
                "selected_image_display_size",
                "Selected image display size (pixel)",
                128, min=32, max=512, step=32,
            )

        with ui.nav_panel("Simulate"):
            # 3D input -> symmetrized noisy projection as the search
            # input (reference app.py:247-410 simulation sidebar +
            # 1776-1827 symmetrization_projection handler)
            ui.input_numeric("input_apix", "Input voxel size (A)", 0.0, step=0.1)
            ui.input_numeric("input_twist", "Twist (deg)", 29.4, step=0.1)
            ui.input_numeric("input_rise", "Rise (A)", 4.75, step=0.1)
            ui.input_numeric("input_csym", "Csym", 1, min=1, step=1)
            ui.input_numeric("output_apix", "Output pixel size (A)", 5.0, min=0.1, step=0.1)
            ui.input_numeric("output_length", "Output length (pixels)", 256, min=32, step=16)
            ui.input_numeric("output_width", "Output width (pixels)", 128, min=32, step=16)
            ui.input_numeric(
                "output_axial_rotation", "Axial rotation (deg)", 0, min=-20, max=20, step=1
            )
            ui.input_numeric(
                "output_tilt", "Tilt out of plane (deg)", 0, min=-90, max=90, step=1
            )
            ui.input_numeric(
                "gauss_noise_std", "Gaussian noise standard deviation", 0.0
            )
            ui.input_task_button(
                "symmetrization_projection", "Generate projection"
            )

        with ui.nav_panel("Transform"):
            ui.input_radio_buttons(
                "input_ui_type",
                "Image transformation parameters input type:",
                ["Slider", "Input box"],
                inline=True,
            )
            ui.input_checkbox("img_negate", "Negate", value=False)
            ui.input_checkbox("img_transpose", "Transpose", value=False)
            ui.input_checkbox("img_flip", "Flip left-right", value=False)
            ui.input_numeric("threshold", "Threshold", 0.0, step=0.001)

            @render.ui
            @reactive.event(input.input_ui_type)
            def rotation_shift_ui():
                # reference app.py input_ui_type: the rotation/shift
                # controls render as sliders or as numeric input boxes
                if input.input_ui_type() == "Input box":
                    return ui.div(
                        ui.input_numeric(
                            "pre_rotation", "Rotation (deg)", 0.0, step=0.1
                        ),
                        ui.input_numeric(
                            "shift_y", "Vertical shift (pixel)", 0.0, step=1.0
                        ),
                    )
                return ui.div(
                    ui.input_slider(
                        "pre_rotation", "Rotation (deg)", min=-45, max=45,
                        value=0.0, step=0.1,
                    ),
                    ui.input_slider(
                        "shift_y", "Vertical shift (pixel)", min=-100,
                        max=100, value=0.0, step=1,
                    ),
                )

            ui.input_numeric("vertical_crop_size", "Vertical crop (pixel)", 0)
            ui.input_numeric(
                "horizontal_crop_size", "Horizontal crop (pixel)", 0
            )
            ui.input_numeric("binning", "Binning", 1, min=1, max=100, step=1)
            ui.input_numeric("lp_angst", "Low pass filtering (A)", -1.0, step=0.1)
            ui.input_numeric("hp_angst", "High pass filtering (A)", -1.0, step=0.1)
            ui.input_text(
                "stitch_x_offsets",
                "Stitching x-offsets (comma-separated, multi-image)",
                value="",
            )
            ui.input_checkbox(
                "image_stitching",
                "Feature-registration stitching (2D)",
                value=False,
            )
            ui.input_action_button("perform_stitching", "Stitch images")
            ui.input_action_button("auto_transform", "Auto transform")
            ui.input_action_button("reset_transform", "Reset")

        with ui.nav_panel("Search"):
            ui.input_slider(
                "twist_range", "Twist range (deg)", 0.1, 180.0, (0.5, 45.0)
            )
            ui.input_numeric("twist_step", "Twist step (deg)", 1.0)
            ui.input_slider("rise_range", "Rise range (A)", 1.0, 200.0, (4.0, 5.0))
            ui.input_numeric("rise_step", "Rise step (A)", 0.25)
            ui.input_radio_buttons(
                "handedness", "Handedness",
                choices=["both", "left", "right"], selected="both", inline=True,
            )
            ui.input_numeric("csym", "Csym", 1, min=1)
            ui.input_select(
                "interpolation", "Interpolation", ["nn", "linear"]
            )
            ui.input_select(
                "score_metric", "Score metric",
                ["cosine", "ssim", "ms_ssim", "mutual_information", "composite"],
            )
            ui.input_numeric("fsc_test", "FSC half-set mode (0=off)", 0, min=0, max=4)
            ui.input_numeric("refine_tilt", "Refine tilt bound (deg)", 0.0)
            ui.input_numeric("refine_psi", "Refine psi bound (deg)", 0.0)
            ui.input_numeric("refine_dy", "Refine dy bound (pixel)", 0.0)
            ui.input_select(
                "lr_algorithm", "Solver model",
                ["lsq", "lreg", "ridge", "lasso", "elasticnet", "ard"],
            )
            ui.input_numeric("lr_alpha", "Regularization alpha", -1.0)
            ui.input_numeric(
                "lr_l1_ratio", "L1 regularization ratio", 0.5,
                min=0.0, max=1.0, step=0.1,
            )
            ui.input_radio_buttons(
                "positive_constraint", "Positive constraint",
                {"-1": "Auto", "0": "No", "1": "Yes"},
                selected="-1", inline=True,
            )
            ui.input_numeric(
                "target_apix2d", "Target image pixel size (A)", -1.0, min=-1, step=1
            )
            ui.input_numeric(
                "target_apix3d", "Target voxel size (A)", -1.0, min=-1, step=1
            )
            ui.input_numeric(
                "reconstruct_length_rise", "Reconstruction length (rise)",
                3, min=1, step=1,
            )
            ui.input_numeric("sym_oversample", "Symmetry oversample (-1=auto)", -1)
            ui.input_numeric(
                "n_devices", "# CUDA devices (-1 = all)", -1, min=-1, step=1
            )
            ui.input_numeric("top_n", "Top N results", 10, min=1)
            ui.input_checkbox("plot_scores", "Plot scores", value=True)
            ui.input_checkbox(
                "show_download_print_buttons",
                "Show download/print buttons",
                value=False,
            )

    ui.input_task_button("run_denovo3D", "Run denovo3D")
    ui.input_action_button("abort", "Abort")
    ui.input_action_button("clear_cache", "Clear joblib cache")


# ---------------------------------------------------------------- ingest
@reactive.effect
@reactive.event(input.input_mode_images, input.upload_images)
def get_images_from_upload():
    req(input.input_mode_images() == "upload")
    f = input.upload_images()
    req(f)
    from helicon_tpu_torch.io.mrc import read_mrc

    data, apix = read_mrc(f[0]["datapath"])[:2]
    input_data.set(
        helicon.DotDict(
            data=np.asarray(data), apix=float(apix), emdb_id=None,
            is_3d=helicon.is_3d(np.asarray(data)),
        )
    )


@reactive.effect
@reactive.event(input.input_mode_images, input.url_images)
def get_images_from_url():
    req(input.input_mode_images() == "url")
    url = input.url_images()
    req(url)
    try:
        data, apix = pipeline.get_images_from_url(url)
    except Exception:
        ui.modal_show(
            ui.modal(
                f"failed to download 2D images from {url}",
                title="File download error", easy_close=True, footer=None,
            )
        )
        return
    emdb_id = helicon.get_emdb_id(url)
    input_data.set(
        helicon.DotDict(
            data=np.asarray(data), apix=float(apix), emdb_id=emdb_id,
            is_3d=bool(emdb_id) or helicon.is_3d(np.asarray(data)),
        )
    )


@reactive.effect
@reactive.event(input.randomize_emdb_id)
def randomize_emdb_id():
    import random

    from helicon_tpu_torch.io.dataset import EMDB

    ids = EMDB().amyloid_atlas_ids()
    ui.update_text("emdb_id", value=f"EMD-{random.choice(ids)}")


@reactive.effect
@reactive.event(input.input_mode_images, input.emdb_id)
def get_images_from_emdb():
    req(input.input_mode_images() == "emdb")
    emdb_id = input.emdb_id()
    req(emdb_id)
    try:
        data, apix = pipeline.get_images_from_emdb(emd_id=emdb_id)
    except Exception:
        ui.modal_show(
            ui.modal(
                f"failed to obtain {emdb_id} map from EMDB",
                title="File download error", easy_close=True, footer=None,
            )
        )
        return
    input_data.set(
        helicon.DotDict(
            data=np.asarray(data), apix=float(apix), emdb_id=emdb_id, is_3d=True,
        )
    )


@reactive.effect
@reactive.event(input.symmetrization_projection)
def generate_symmetrized_projection():
    """3D input -> user-parameterized symmetrized noisy projection
    (reference app.py:1776-1827); replaces the auto XYZ projections."""
    d = input_data.get()
    req(d is not None and (d.is_3d or input.is_3d()))
    apix_in = _num(input.input_apix()) or float(d.apix)
    proj, new_apix = symmetrize_projection(
        np.asarray(d.data),
        apix=apix_in,
        twist_degree=_num(input.input_twist(), 29.4),
        rise_angstrom=_num(input.input_rise(), 4.75),
        csym=max(1, _int(input.input_csym(), 1)),
        new_size=(
            _int(input.output_length(), 256),
            _int(input.output_width(), 128),
            _int(input.output_width(), 128),
        ),
        new_apix=_num(input.output_apix(), 5.0),
        axial_rotation=_num(input.output_axial_rotation()),
        tilt=_num(input.output_tilt()),
        gauss_noise_std=_num(input.gauss_noise_std()),
        device=DEVICE,
    )
    all_images.set(dict(data=proj, apix=float(new_apix)))
    selected_indices.set([0])


@reactive.effect
@reactive.event(input_data, input.is_3d, input.ignore_blank)
def update_all_images():
    d = input_data.get()
    req(d is not None)
    data, apix = np.asarray(d.data), float(d.apix)
    if d.is_3d or input.is_3d():
        # 3D map -> XYZ projections as synthetic inputs (reference
        # app.py:1766-1790 passes is_amyloid + apix so amyloid maps
        # project a single 4.75 A rung along Z instead of summing every
        # twisted rung into a rotational blur)
        from helicon_tpu_torch.helix import generate_xyz_projections

        is_amyloid = d.emdb_id is not None  # the EMDB mode is amyloid-focused
        projs = generate_xyz_projections(
            data, is_amyloid=is_amyloid, apix=apix, device=DEVICE
        )
        stack = np.stack([p.cpu().numpy() for p in projs]).astype(np.float32)
    else:
        stack = data if data.ndim == 3 else data[None]
    if input.ignore_blank():
        keep = filter_blank_images(stack)
        stack = stack[np.asarray(keep, int)] if keep else stack[:0]
    if _num(input.image_index_apix()) > 0:
        apix = _num(input.image_index_apix())
    all_images.set(dict(data=stack, apix=apix))
    selected_indices.set([0] if len(stack) else [])


@reactive.effect
@reactive.event(input.select_image)
def toggle_selected_image():
    i = int(input.select_image())
    sel = list(selected_indices.get())
    if i in sel:
        sel.remove(i)
    else:
        sel.append(i)
    selected_indices.set(sorted(sel))


# ------------------------------------------------------------- transforms
@reactive.effect
@reactive.event(selected_indices, input.img_negate)
def update_threshold_estimate():
    imgs = _selected_images()
    req(imgs)
    t = estimate_threshold_otsu(imgs, negate=bool(input.img_negate()))
    ui.update_numeric("threshold", value=round(float(t), 3))


@reactive.effect
@reactive.event(input.auto_transform)
def run_auto_transform():
    imgs = _selected_images()
    req(imgs)
    d = input_data.get()
    apix = float(all_images.get()["apix"])
    rotation, shift_y, vc, hc = auto_transform_params(
        imgs, apix=apix, is_3d=bool(d and d.is_3d)
    )
    ui.update_slider("pre_rotation", value=round(rotation, 1))
    ui.update_slider("shift_y", value=round(shift_y / max(apix, 1e-6), 1))
    ui.update_numeric("vertical_crop_size", value=int(vc))
    ui.update_numeric("horizontal_crop_size", value=int(hc))


@reactive.effect
@reactive.event(input.reset_transform)
def reset_transform():
    ui.update_checkbox("img_negate", value=False)
    ui.update_checkbox("img_transpose", value=False)
    ui.update_checkbox("img_flip", value=False)
    ui.update_slider("pre_rotation", value=0.0)
    ui.update_slider("shift_y", value=0.0)
    ui.update_numeric("vertical_crop_size", value=0)
    ui.update_numeric("horizontal_crop_size", value=0)
    ui.update_text("stitch_x_offsets", value="")


@reactive.effect
@reactive.event(
    selected_indices, input.img_negate, input.threshold, input.img_transpose,
    input.img_flip, input.pre_rotation, input.shift_y,
    input.vertical_crop_size, input.horizontal_crop_size,
    input.binning, input.lp_angst, input.hp_angst,
)
def update_transformed_images():
    imgs = _selected_images()
    if not imgs:
        transformed_images.set([])
        return
    # binning + band-pass run BEFORE the geometric chain (reference
    # app.py:1890-1943 preprocesses the selected originals); binning
    # scales the effective pixel size the search must use
    apix = float(all_images.get()["apix"])
    imgs, eff_apix = preprocess_selected_images(
        imgs, apix,
        binning=_int(input.binning(), 1),
        lp_angst=_num(input.lp_angst(), -1),
        hp_angst=_num(input.hp_angst(), -1),
        device=DEVICE,
    )
    search_apix.set(eff_apix)
    out = apply_transform_chain(
        imgs,
        negate=bool(input.img_negate()),
        # reference app.py:1996-2012 always thresholds at the current
        # value (0.0 included — a falsy gate silently disabled it)
        threshold=float(input.threshold() or 0.0),
        transpose=bool(input.img_transpose()),
        flip=bool(input.img_flip()),
        rotation=float(input.pre_rotation()),
        shift_y_pixel=float(input.shift_y()),
        vertical_crop_size=int(input.vertical_crop_size() or 0),
        horizontal_crop_size=int(input.horizontal_crop_size() or 0),
        device=DEVICE,
    )
    transformed_images.set(out)


@reactive.effect
@reactive.event(input.perform_stitching)
def run_perform_stitching():
    """Auto-estimate the montage x-offsets by cross-correlating
    adjacent images' column profiles (the reference's Stitch Images
    dialog, made automatic)."""
    imgs = transformed_images.get()
    req(imgs and len(imgs) > 1)
    offs = estimate_stitch_offsets(imgs)
    ui.update_text(
        "stitch_x_offsets",
        value=",".join(f"{int(o)}" for o in offs),
    )


@reactive.effect
@reactive.event(input.stitch_x_offsets)
def update_stitch_offsets():
    txt = (input.stitch_x_offsets() or "").strip()
    try:
        stitch_offsets.set(
            [float(v) for v in txt.split(",") if v.strip()] if txt else []
        )
    except ValueError:
        pass


@reactive.effect
@reactive.event(input.clear_cache)
def clear_joblib_cache():
    from joblib import Memory

    cache_dir = helicon.cache_dir / "denovo3D"
    if cache_dir.exists():
        Memory(location=str(cache_dir), verbose=0).clear()


# ------------------------------------------------------------------- run
def _search_image():
    """One 2D image for the grid: the transformed image, or the stitched
    montage when several are selected (reference app.py:77-125)."""
    imgs = transformed_images.get()
    if not imgs:
        return None
    if len(imgs) == 1:
        return imgs[0]
    offs = stitch_offsets.get()
    if input.image_stitching():
        # 2D feature-registration montage (the reference's ITK
        # TileMontage option, pipeline.py:500-599)
        mont, _ = register_and_montage(imgs, offs or None, device=DEVICE)
        return mont.astype(np.float32)
    return combine_images_for_display(imgs, offs).astype(np.float32)


@ui.bind_task_button(button_id="run_denovo3D")
@reactive.extended_task
async def reconstruction_task(image, apix, twists, rises, kwargs):
    _abort_flag.clear()
    _progress_holder["snap"] = None
    _progress_holder["done"] = False

    def on_progress(snap):
        _progress_holder["snap"] = snap

    def work():
        try:
            return run_grid_incremental(
                image, apix, twists, rises,
                on_progress=on_progress,
                should_abort=_abort_flag.is_set,
                **kwargs,
            )
        finally:
            _progress_holder["done"] = True

    task = asyncio.get_event_loop().run_in_executor(None, work)
    with ui.Progress(min=0, max=len(twists)) as p:
        p.set(message="Grid search in progress", detail="compiling ...")
        while not _progress_holder["done"]:
            await asyncio.sleep(0.3)
            snap = _progress_holder["snap"]
            if snap is not None:
                # propagate to dependents from a concurrent task:
                # a bare set() without lock+flush leaves the ranked
                # table frozen until the task completes
                async with reactive.lock():
                    grid_progress.set(snap)
                    await reactive.flush()
                p.set(
                    snap.done,
                    message=f"Completed {snap.done}/{snap.total}",
                    detail=f"{helicon.timedelta2string(snap.eta_seconds)} remaining",
                )
    res = await task
    if _progress_holder["snap"] is not None:
        async with reactive.lock():
            grid_progress.set(_progress_holder["snap"])
            await reactive.flush()
    return res


@reactive.effect
@reactive.event(input.run_denovo3D)
def start_reconstruction():
    img = _search_image()
    req(img is not None)
    t0, t1 = input.twist_range()
    r0, r1 = input.rise_range()
    twist_step = _num(input.twist_step(), 1.0)
    rise_step = _num(input.rise_step(), 0.25)
    if twist_step <= 0 or rise_step <= 0:
        # np.arange with step 0 raises ZeroDivisionError inside the
        # effect (fatal to the session); a negative step yields an
        # empty grid that fails later in the worker
        ui.notification_show(
            "Twist/rise steps must be positive", type="error"
        )
        return
    twists, rises = build_candidate_grid(
        t0, t1, twist_step, r0, r1, rise_step,
        handedness=input.handedness(),
    )
    if not len(twists):
        ui.notification_show(
            "No (twist, rise) candidates in the requested ranges",
            type="error",
        )
        return
    algorithm = dict(model=input.lr_algorithm())
    if _num(input.lr_alpha(), -1.0) >= 0:
        algorithm["alpha"] = _num(input.lr_alpha())
    algorithm["l1_ratio"] = min(1.0, max(0.0, _num(input.lr_l1_ratio(), 0.5)))
    refine = {}
    if _num(input.refine_tilt()) > 0:
        refine["tilt"] = _num(input.refine_tilt())
    if _num(input.refine_psi()) > 0:
        refine["psi"] = _num(input.refine_psi())
    if _num(input.refine_dy()) > 0:
        refine["dy"] = _num(input.refine_dy())
    devices = None
    nd = _int(input.n_devices(), -1)
    if torch.device(DEVICE).type == "cuda":
        # the first nd visible cards, or all of them (the reference's
        # jax.devices()[:nd] and its default); without a card the search
        # fails on DEVICE and collect_result shows it
        cards = list(range(torch.cuda.device_count() if torch.cuda.is_available() else 0))
        devices = (cards[:nd] if nd > 0 else cards) or None
    kwargs = dict(
        csym=max(1, _int(input.csym(), 1)),
        interpolation=input.interpolation(),
        score_metric=input.score_metric(),
        fsc_test=_int(input.fsc_test()),
        refine_tilt_psi_dy_range=refine or None,
        algorithm=algorithm,
        positive_constraint=_int(input.positive_constraint(), -1),
        target_apix2d=_num(input.target_apix2d(), -1),
        target_apix3d=_num(input.target_apix3d(), -1),
        reconstruct_length_rise=max(
            1.0, _num(input.reconstruct_length_rise(), 3.0)
        ),
        sym_oversample=_int(input.sym_oversample(), -1),
        horizontalize=0,  # the transform chain already leveled the image
        transpose=0,
        return_best_volume=True,
        device=DEVICE,
    )
    if devices is not None:
        kwargs["devices"] = devices
    # binning changed the pixel size of the transformed images
    apix = float(search_apix.get() or all_images.get()["apix"])
    reconstruction_task(img, apix, twists, rises, kwargs)


@reactive.effect
@reactive.event(input.abort)
def abort_reconstruction():
    _abort_flag.set()


@reactive.effect
def collect_result():
    try:
        res = reconstruction_task.result()
    except Exception as e:  # surface worker errors instead of dying:
        # .result() re-raises inside the effect, which is fatal to the
        # whole session — the user would lose every loaded image
        ui.modal_show(
            ui.modal(
                str(e), title="Reconstruction failed", easy_close=True,
                footer=None,
            )
        )
        return
    if res is not None:
        grid_result.set(res)


# --------------------------------------------------------------- display
@reactive.calc
def _gallery_data_urls():
    """Base64 thumbnails, recomputed only when the IMAGES change — a
    selection click re-renders the gallery (for the highlight border)
    and must not re-encode 50 JPEGs each time."""
    imgs = all_images.get()
    if imgs is None or not len(imgs["data"]):
        return []
    return [encode_numpy(np.asarray(im)) for im in imgs["data"][:50]]


@render.ui
def image_gallery_ui():
    urls = _gallery_data_urls()
    if not urls:
        return ui.p("Provide input images (upload / URL / EMDB).")
    return image_select(
        "select_image",
        "Click to select/deselect images:",
        urls,
        image_labels=[str(i + 1) for i in range(len(urls))],
        image_size=96,
        initial_selected_indices=selected_indices.get(),
    )


@render.ui
def transformed_preview():
    img = _search_image()
    if img is None:
        return None
    size = max(32, _int(input.selected_image_display_size(), 128))
    return ui.div(
        ui.tags.label("Search input (transformed/stitched):"),
        ui.tags.img(
            src=encode_numpy(np.asarray(img)), width=f"{4 * size}px",
            id="input_image_display",
        ),
    )


@render.ui
def download_print_buttons():
    """Print buttons for the input/reconstructed image panels
    (reference app.py print_input_images / print_reeconstructed_images:
    window.open + document.write of the panel contents)."""
    if not input.show_download_print_buttons():
        return None

    def _print_js(element_id):
        return (
            "var w = window.open();"
            "w.document.write(document.head.outerHTML);"
            "var el = document.getElementById('" + element_id + "');"
            "if (el) { w.document.write(el.outerHTML); }"
            "w.document.close(); w.focus(); w.print(); w.close();"
        )

    return ui.div(
        ui.input_action_button(
            "print_input_images", "Print input images",
            onclick=_print_js("input_image_display"),
        ),
        ui.input_action_button(
            "print_reeconstructed_images", "Print reeconstructed images",
            onclick=_print_js("best_result_display"),
        ),
    )


def _score_heatmap_png(plot):
    """(twist, rise) score landscape as an image: viridis-free grayscale
    heat map with the best cell outlined (reference app.py:1078-1113
    builds the same max-aggregated grid with a red box via plotly)."""
    z = plot["z"]
    lo, hi = float(z.min()), float(z.max())
    img = (z - lo) / (hi - lo) if hi > lo else np.zeros_like(z)
    scale = max(1, int(np.ceil(256 / max(img.shape))))
    big = np.kron(img.T[::-1], np.ones((scale, scale)))  # rise up, twist right
    bi = int(np.argmax(plot["x"] == plot["best"][0]))
    bj = int(np.argmax(plot["y"] == plot["best"][1]))
    r0 = big.shape[0] - (bj + 1) * scale
    c0 = bi * scale
    big[r0 : r0 + scale, c0] = 1.0
    big[r0 : r0 + scale, min(c0 + scale - 1, big.shape[1] - 1)] = 1.0
    big[r0, c0 : c0 + scale] = 1.0
    big[min(r0 + scale - 1, big.shape[0] - 1), c0 : c0 + scale] = 1.0
    return encode_numpy(big.astype(np.float32))


@render.ui
def score_plot():
    """Score landscape (gated on the plot_scores checkbox)."""
    if not input.plot_scores():
        return None
    snap = grid_progress.get()
    res = grid_result.get()
    if res is not None:
        plot = score_plot_data(res.twists, res.rises, res.scores)
    elif snap is not None and snap.ranked:
        rows = np.asarray(snap.ranked, np.float64)
        plot = score_plot_data(rows[:, 0], rows[:, 1], rows[:, 2])
    else:
        return None
    if plot is None:
        return None
    if plot["kind"] == "2d":
        return ui.div(
            ui.tags.label(
                f"Score landscape (best: twist={plot['best'][0]:.3f} deg, "
                f"rise={plot['best'][1]:.3f} A; x=twist, y=rise):"
            ),
            ui.tags.img(src=_score_heatmap_png(plot), width="512px"),
        )
    # 1D: inline SVG polyline score curve
    x, y = plot["x"], plot["y"]
    xs = (x - x.min()) / max(x.max() - x.min(), 1e-30) * 480 + 10
    lo, hi = float(y.min()), float(y.max())
    ys = 150 - (y - lo) / max(hi - lo, 1e-30) * 140
    pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(xs, ys))
    return ui.div(
        ui.tags.label(f"Scores vs {plot['xlabel']}:"),
        ui.HTML(
            '<svg width="500" height="160" style="background:#f8f8f8">'
            f'<polyline points="{pts}" fill="none" stroke="blue"/></svg>'
        ),
    )


@render.ui
def progress_table():
    snap = grid_progress.get()
    if snap is None:
        return ui.p("Press Run to start the grid search.")
    head = ui.tags.tr(
        ui.tags.th("twist (deg)"), ui.tags.th("rise (A)"), ui.tags.th("score")
    )
    n = int(input.top_n() or 10)
    rows = [
        ui.tags.tr(
            ui.tags.td(f"{t:.3f}"), ui.tags.td(f"{r:.3f}"), ui.tags.td(f"{s:.5f}")
        )
        for t, r, s in snap.ranked[:n]
    ]
    status = (
        "aborted" if snap.aborted
        else f"{snap.done}/{snap.total} candidates scored"
    )
    return ui.div(ui.p(status), ui.tags.table(head, *rows))


@render.ui
def best_result():
    res = grid_result.get()
    if res is None or res.best_volume is None:
        return None
    vol = np.asarray(res.best_volume)
    proj_y = vol.sum(axis=1)
    proj_x = vol.sum(axis=2).T
    bits = [
        ui.tags.label(
            f"Best: twist={float(res.twists[res.best_index]):.3f} deg, "
            f"rise={float(res.rises[res.best_index]):.3f} A, "
            f"score={float(res.scores[res.best_index]):.5f}"
        ),
        ui.tags.img(src=encode_numpy(proj_x), width="512px"),
        ui.tags.img(src=encode_numpy(proj_y), width="512px"),
    ]
    if res.refined_params and res.best_index in res.refined_params:
        t_r, p_r, d_r = res.refined_params[res.best_index]
        bits.insert(
            1,
            ui.p(
                f"refined pose: tilt={t_r:.2f} deg psi={p_r:.2f} deg "
                f"dy={d_r:.2f} px"
            ),
        )
    return ui.div(*bits, id="best_result_display")
