"""The port's two web apps, their widgets and every launcher, against the
JAX package's.

- Structure: the checks of tests/test_webapp_apps.py on the port's
  ``app.py`` files (they parse, carry the reference's input and output
  ids, take ``ui`` from ``shiny.express``, import no JAX).
- Boot: the apps of tests/test_webapp_boot.py on the same functional
  shiny shim (tests/_ref_shims), each app's ``DEVICE`` set to "cpu"
  before its import; denovo3D's bounded search equals the direct
  ``workflow.run_grid_incremental`` call bit for bit, and the reference
  app's search on the same image within 1e-4 (the tolerance of
  tests/test_torch_webapp.py).
- ``utils/shiny.py`` pinned to the reference's on the shim.
- The launchers with ``subprocess.call`` mocked (neither shiny nor
  streamlit nor a network here), and ``helicon-torch``'s subcommand
  lists against the reference's dispatcher.
"""

import ast
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHIMS = str(Path(__file__).resolve().parent / "_ref_shims")
PORT_APPS = ROOT / "helicon_tpu_torch" / "webApps"

APP_MODULES = (
    "helicon_tpu_torch.webApps.denovo3D.app",
    "helicon_tpu_torch.webApps.whereIsMyClass.app",
    "helicon_tpu.webApps.denovo3D.app",
    "helicon_tpu.webApps.whereIsMyClass.app",
)

GRID_BUDGET = dict(cg_iters=16, fista_iters=32, power_iters=2)


# --------------------------------------------------------------------------
# structure (tests/test_webapp_apps.py on the port's files)
# --------------------------------------------------------------------------


def _source(app):
    return (PORT_APPS / app / "app.py").read_text()


TOKENS = {
    "denovo3D": [
        "input_mode_images", "upload_images", "url_images", "emdb_id", "randomize_emdb_id",
        "URLS[DEFAULT_URL_KEY]", "img_negate", "img_transpose", "img_flip", "threshold",
        "pre_rotation", "shift_y", "vertical_crop_size", "horizontal_crop_size",
        "auto_transform", "reset_transform", "apply_transform_chain", "stitch_x_offsets",
        "combine_images_for_display", "run_denovo3D", "abort", "run_grid_incremental",
        "reactive.extended_task", "ui.Progress", "grid_progress", "refine_tilt_psi_dy_range",
        "score_metric", "fsc_test", "clear_cache", "DEVICE = _package.DEVICE"],
    "whereIsMyClass": [
        "get_micrograph", "mark_classes_on_helices", "draw_distance_measurement",
        "marked_helices_classes", "select_all_marked_helices_classes",
        "unselect_all_marked_helices_classes", "plot_histogram", "show_pitch_twist",
        "first_point", "second_point", "sort_abundance", "ignore_blank", "helices_table",
        "DEVICE = _package.DEVICE"],
}


def _ids(src):
    """Every string literal that names an input or output of the page."""
    return {n.value for n in ast.walk(ast.parse(src))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.isidentifier()}


@pytest.mark.parametrize("app", sorted(TOKENS))
def test_app_structure(app):
    """Parses; the reference's workflow tokens; every identifier-like string
    of the reference's page (input and output ids) is in the port's; ui from
    shiny.express; no JAX and no JAX package."""
    src = _source(app)
    tree = ast.parse(src)
    for token in TOKENS[app]:
        assert token in src, token
    ref_src = (ROOT / "helicon_tpu" / "webApps" / app / "app.py").read_text()
    assert _ids(ref_src) - _ids(src) <= {"jax"}, _ids(ref_src) - _ids(src)
    line = src.split("from shiny.express import", 1)[1].split("\n")[0]
    assert " ui" in line
    assert "from shiny import reactive, render, req, ui" not in src
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "helicon_tpu", "helicon"), name


# --------------------------------------------------------------------------
# boot on the shim (tests/test_webapp_boot.py on the port's apps)
# --------------------------------------------------------------------------


def _purge():
    for mod in list(sys.modules):
        if (mod in ("shiny", "shinywidgets", "plotly")
                or mod.startswith(("shiny.", "plotly.")) or mod in APP_MODULES):
            sys.modules.pop(mod)


@pytest.fixture()
def shiny_shim(monkeypatch):
    import helicon_tpu_torch.webApps.denovo3D as d3
    import helicon_tpu_torch.webApps.whereIsMyClass as wimc

    monkeypatch.setattr(d3, "DEVICE", "cpu")
    monkeypatch.setattr(wimc, "DEVICE", "cpu")
    monkeypatch.syspath_prepend(SHIMS)
    _purge()
    import shiny

    shiny.get_session().reset()
    yield shiny
    _purge()


def _fake_class_average(ny=48, nx=96):
    from helicon_tpu_torch.helix import simulate_helical_projection

    return np.squeeze(simulate_helical_projection(
        n=1, twist=30.0, rise=6.0, csym=1, helical_diameter=40.0, ball_radius=5.0,
        polymer=0, planarity=1.0, ny=ny, nx=nx, apix=2.0, rng=0,
        device="cpu")).astype(np.float32)


def _boot_denovo3d(shiny_shim, monkeypatch, package="helicon_tpu_torch", calls=None,
                   **grid_overrides):
    """Import a denovo3D app on the shim with a synthetic default-URL ingest
    and the bounded budget; ``calls`` collects each search's arguments."""
    pipeline = importlib.import_module(f"{package}.webApps.denovo3D.pipeline")
    workflow = importlib.import_module(f"{package}.webApps.denovo3D.workflow")
    img = _fake_class_average()
    monkeypatch.setattr(pipeline, "get_images_from_url", lambda url: (img[None], 2.0))
    real_run = workflow.run_grid_incremental

    def bounded_run(image, apix, twists, rises, **kwargs):
        for k, v in GRID_BUDGET.items():
            kwargs.setdefault(k, v)
        kwargs.update(grid_overrides)
        if package == "helicon_tpu":
            import jax

            kwargs["devices"] = jax.devices()[:1]
        if calls is not None:
            calls.append((np.array(image), apix, np.array(twists), np.array(rises),
                          {k: v for k, v in kwargs.items()
                           if k not in ("on_progress", "should_abort")}))
        return real_run(image, apix, twists, rises, **kwargs)

    monkeypatch.setattr(workflow, "run_grid_incremental", bounded_run)
    app = importlib.import_module(f"{package}.webApps.denovo3D.app")
    return app, shiny_shim.get_session(), real_run


def _run_small_grid(s):
    s.set_input("twist_range", (25.0, 35.0))
    s.set_input("twist_step", 5.0)
    s.set_input("rise_range", (5.0, 7.0))
    s.set_input("rise_step", 1.0)
    s.set_input("handedness", "right")
    s.press("run_denovo3D")  # sync_tasks: runs the grid to completion


class TestDenovo3DBoot:
    def test_page_builds_and_ingests_default_url(self, shiny_shim, monkeypatch):
        app, s, _ = _boot_denovo3d(shiny_shim, monkeypatch)
        assert app.DEVICE == "cpu"
        for key in ("input_mode_images", "twist_range", "rise_range", "score_metric",
                    "run_denovo3D", "abort", "n_devices"):
            assert key in s.inputs, key
        assert s.inputs["input_mode_images"] == "url"
        assert app.all_images.get() is not None
        assert app.selected_indices.get() == [0]
        assert len(app.transformed_images.get()) == 1
        gallery = s.render("image_gallery_ui")
        assert gallery is not None and "Click to select" in gallery.text()
        assert s.render("transformed_preview") is not None
        assert "Press Run" in s.render("progress_table").text()
        assert not s.errors, s.errors

    def test_transform_chain_reacts(self, shiny_shim, monkeypatch):
        app, s, _ = _boot_denovo3d(shiny_shim, monkeypatch)
        base = app.transformed_images.get()[0].copy()
        s.set_input("img_negate", True)
        negated = app.transformed_images.get()[0]
        assert negated.shape == base.shape and not np.array_equal(negated, base)
        s.press("reset_transform")
        assert s.inputs["img_negate"] is False
        assert not s.errors, s.errors

    def test_grid_search_equals_direct_call_and_reference_app(self, shiny_shim, monkeypatch):
        """The app's search to its sorted table; the same search called
        directly gives the same scores bit for bit; the reference app on the
        same image within 1e-4 and the same top-1."""
        calls = []
        app, s, real_run = _boot_denovo3d(shiny_shim, monkeypatch, calls=calls)
        _run_small_grid(s)
        res = app.grid_result.get()
        assert res is not None and res.best_volume is not None
        assert "candidates scored" in s.render("progress_table").text()
        assert "Best: twist=" in s.render("best_result").text()
        best_t, best_r = float(res.twists[res.best_index]), float(res.rises[res.best_index])
        assert 360.0 / best_t * best_r == pytest.approx(72.0)
        assert not s.errors, s.errors
        image, apix, twists, rises, kwargs = calls[0]
        assert kwargs["device"] == "cpu" and "devices" not in kwargs
        direct = real_run(image, apix, twists, rises, **kwargs)
        np.testing.assert_array_equal(direct.scores, res.scores)
        assert direct.best_index == res.best_index

        _purge()  # the reference app on a fresh shim session
        fresh = importlib.import_module("shiny")
        fresh.get_session().reset()
        ref_calls = []
        ref_app, rs, _ = _boot_denovo3d(fresh, monkeypatch, package="helicon_tpu",
                                        calls=ref_calls)
        _run_small_grid(rs)
        ref = ref_app.grid_result.get()
        np.testing.assert_array_equal(ref_calls[0][0], image)
        np.testing.assert_array_equal(np.asarray(ref.twists), res.twists)
        np.testing.assert_allclose(res.scores, np.asarray(ref.scores), rtol=0, atol=1e-4)
        assert int(ref.best_index) == res.best_index

    def test_more_than_one_device_names_a10b(self, shiny_shim, monkeypatch):
        """"# CUDA devices" on the CPU app (DEVICE "cpu"): 2 takes the one
        CPU device, as -1 does, and both searches run to the same result,
        no modal (several cards in one process are ported, ROADMAP A10b);
        on the card the field takes the first n visible cards, -1 all."""
        calls = []
        app, s, _ = _boot_denovo3d(shiny_shim, monkeypatch, calls=calls)
        modals, results = len(s.modals), []
        for nd in (2, -1):
            s.set_input("n_devices", nd)
            _run_small_grid(s)
            results.append(app.grid_result.get())
        assert all(r is not None for r in results)
        np.testing.assert_array_equal(results[0].scores, results[1].scores)
        assert results[0].best_index == results[1].best_index
        assert [c[4].get("devices") for c in calls] == [None, None]
        assert len(s.modals) == modals and not s.errors, ([m.text() for m in s.modals],
                                                          s.errors)
        # the card's rule, on three visible cards, with the search replaced
        monkeypatch.setattr(app, "DEVICE", "cuda")
        monkeypatch.setattr(app.torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(app.torch.cuda, "device_count", lambda: 3)
        seen = []
        monkeypatch.setattr(app, "reconstruction_task",
                            lambda img, apix, tw, ri, kwargs: seen.append(kwargs.get("devices")))
        for nd in (2, -1, 5):
            s.set_input("n_devices", nd)
            _run_small_grid(s)
        assert seen == [[0, 1], [0, 1, 2], [0, 1, 2]]

    def test_invalid_steps_notify_instead_of_crashing(self, shiny_shim, monkeypatch):
        app, s, _ = _boot_denovo3d(shiny_shim, monkeypatch)
        s.set_input("twist_step", 0.0)
        s.press("run_denovo3D")
        assert any("must be positive" in msg for _, msg in s.notifications)
        assert app.grid_result.get() is None
        assert not s.errors, s.errors


def _write_class2d_project(tmp_path):
    """RELION-style Class2D job dir: run_it025_data.star + classes.mrcs."""
    import pandas as pd

    from helicon_tpu_torch.io.metadata import dataframe2file
    from helicon_tpu_torch.io.mrc import write_mrc

    job = tmp_path / "Class2D" / "job042"
    job.mkdir(parents=True)
    classes = np.stack([_fake_class_average(32, 32), np.zeros((32, 32), np.float32)])
    write_mrc(job / "run_it025_classes.mrcs", classes, apix=2.0)
    rows = []
    for tube in (1, 2):
        for seg in range(4):
            rows.append(dict(
                rlnImageName=f"{len(rows) + 1:06d}@parts.mrcs", rlnMicrographName="mic_0001.mrc",
                rlnHelicalTubeID=tube, rlnHelicalTrackLengthAngst=seg * 50.0,
                rlnClassNumber=1, rlnCoordinateX=100.0 + 10 * seg,
                rlnCoordinateY=200.0 + 10 * tube, rlnAnglePsi=15.0,
                rlnDetectorPixelSize=5.0, rlnMagnification=10000.0))
    df = pd.DataFrame(rows)
    df.attrs["convention"] = "relion"
    star = job / "run_it025_data.star"
    dataframe2file(df, str(star))
    return star


class TestWhereIsMyClassBoot:
    def test_page_builds(self, shiny_shim):
        app = importlib.import_module("helicon_tpu_torch.webApps.whereIsMyClass.app")
        s = shiny_shim.get_session()
        assert app.DEVICE == "cpu"
        for key in ("param_path", "load_param_path", "sort_abundance", "target_apix",
                    "rise", "bins"):
            assert key in s.inputs, key
        assert app.params.get() is None
        assert not s.errors, s.errors

    def test_load_and_display_classes(self, shiny_shim, tmp_path):
        star = _write_class2d_project(tmp_path)
        app = importlib.import_module("helicon_tpu_torch.webApps.whereIsMyClass.app")
        s = shiny_shim.get_session()
        s.set_input("param_path", str(star))
        s.press("load_param_path")
        df = app.params.get()
        assert df is not None and "helixID" in df.columns
        assert app.data_all.get() is not None
        assert app.displayed_class_ids.get() == [0]
        assert int(app.abundance.get()[0]) == 8
        s.set_input("select_class", 0)
        assert app.selected_class_ids.get() == [0]
        assert not s.errors, s.errors

    def test_missing_path_shows_modal(self, shiny_shim, tmp_path):
        app = importlib.import_module("helicon_tpu_torch.webApps.whereIsMyClass.app")
        s = shiny_shim.get_session()
        s.set_input("param_path", str(tmp_path / "nope.star"))
        s.press("load_param_path")
        assert s.modals, "expected a file-not-found modal"
        assert app.params.get() is None
        assert not s.errors, s.errors

    def test_micrograph_figure_path(self, shiny_shim, tmp_path):
        """The plotly branch: a helix row loads its micrograph (on DEVICE,
        equal to compute.get_micrograph's direct call), the heatmap, the
        class markers, a two-click distance and the pair-distance histogram."""
        from helicon_tpu_torch.io.mrc import write_mrc
        from helicon_tpu_torch.webApps.whereIsMyClass import compute

        star = _write_class2d_project(tmp_path)
        rng = np.random.default_rng(0)
        write_mrc(tmp_path / "mic_0001.mrc",
                  rng.standard_normal((64, 64)).astype(np.float32), apix=5.0)
        app = importlib.import_module("helicon_tpu_torch.webApps.whereIsMyClass.app")
        assert app._HAS_WIDGETS, "shinywidgets shim not active"
        s = shiny_shim.get_session()
        s.set_input("param_path", str(star))
        s.press("load_param_path")
        s.set_input("select_class", 0)
        s.set_input("helices_table_selected_rows", (0,))
        shown = app.displayed_micrograph_data.get()
        assert shown is not None
        want = compute.get_micrograph(tmp_path / "mic_0001.mrc", 5.0, 20.0, 0.0, device="cpu")
        np.testing.assert_array_equal(shown[0], want[0])
        fig = s.render("display_micrograph")
        assert fig is not None and fig.data[0]._kind == "heatmap"
        assert s.inputs["marked_helices_classes"]
        s.set_input("marked_helices_classes", s.inputs["marked_helices_classes"])
        assert [d for d in fig.data if d.name.startswith("class_")]

        class _Pts:
            xs = [10.0]
            ys = [20.0]

        class _Pts2:
            xs = [40.0]
            ys = [60.0]

        fig.data[0]._fire_click(_Pts)
        fig.data[0]._fire_click(_Pts2)
        assert any(d.name == "distance_line" for d in fig.data)
        assert "measured distance: 50.0" in s.render("distance_readout")
        hist = s.render("pair_distance_histogram")
        assert hist is not None and hist.data[0]._kind == "bar"
        assert not s.errors, s.errors


# --------------------------------------------------------------------------
# utils/shiny.py pinned to the reference's
# --------------------------------------------------------------------------


def _dump(tag):
    if not hasattr(tag, "children"):
        return tag
    return (tag.name, tuple(sorted((k, str(v)) for k, v in tag.attrs.items())),
            tuple(_dump(c) for c in tag.children))


def test_shiny_widgets_match_reference(shiny_shim):
    from helicon_tpu.utils import shiny as ref_shiny
    from helicon_tpu_torch.utils import shiny as port_shiny

    assert set(port_shiny.__all__) == set(ref_shiny.__all__)
    for fn in ("numeric_or", "int_or"):
        for args in ((None,), (None, 7), ("3",), (2.5, 1)):
            assert getattr(port_shiny, fn)(*args) == getattr(ref_shiny, fn)(*args)
    imgs = [np.arange(64, dtype=np.float32).reshape(8, 8), np.ones((8, 8), np.float32)]
    for name, kw in (("image_select", dict(initial_selected_indices=[1])),
                     ("image_gallery", dict())):
        want = getattr(ref_shiny, name)("sel", "Pick", imgs, image_labels=["a", "b"], **kw)
        got = getattr(port_shiny, name)("sel", "Pick", imgs, image_labels=["a", "b"], **kw)
        assert _dump(got) == _dump(want)
    assert _dump(port_shiny.google_analytics("G-X")) == _dump(ref_shiny.google_analytics("G-X"))
    q = dict(a=["1"], b=["x", "y"])
    assert _dump(port_shiny.set_client_url_query_params(q)) == _dump(
        ref_shiny.set_client_url_query_params(q))


# --------------------------------------------------------------------------
# launchers and the dispatcher
# --------------------------------------------------------------------------

LOCAL = ("denovo3D", "whereIsMyClass")
REMOTE = ("hill", "hi3d", "helicalLattice", "helicalPitch", "helicalProjection",
          "ctfSimulation", "procart", "map2seq")


def _launch(package, name, monkeypatch, tmp_path):
    """Run a launcher's main with subprocess.call, the browser and the
    download mocked; (argv of the one call, the URLs fetched)."""
    import webbrowser

    launchers = importlib.import_module(f"{package}.commands._launchers")
    path_utils = importlib.import_module(f"{package}.utils.path_utils")
    calls, fetched = [], []
    monkeypatch.setattr(launchers.subprocess, "call", lambda argv: calls.append(argv) or 0)
    monkeypatch.setattr(webbrowser, "open", lambda url: calls.append(["browser", url]))

    def fake_download(url, target_file_name=None, return_filename=False):
        fetched.append(url)
        Path(target_file_name).write_text("# downloaded\n")

    monkeypatch.setattr(path_utils, "download_file_from_url", fake_download)
    module = importlib.import_module(f"{package}.commands.{name}")
    module.main(module.add_args(__import__("argparse").ArgumentParser()).parse_args([]))
    assert len(calls) == 1
    return calls[0], fetched


@pytest.mark.parametrize("name", LOCAL)
def test_local_launchers_run_the_ports_app(name, monkeypatch, tmp_path):
    argv, fetched = _launch("helicon_tpu_torch", name, monkeypatch, tmp_path)
    ref_argv, _ = _launch("helicon_tpu", name, monkeypatch, tmp_path)
    app = Path(argv[-1])
    assert app == PORT_APPS / name / "app.py" and app.is_file()
    assert argv[:-1] == ref_argv[:-1] and argv[:2] == ["shiny", "run"]
    assert fetched == []


@pytest.mark.parametrize("name", REMOTE)
def test_remote_launchers_match_reference(name, monkeypatch, tmp_path):
    argv, fetched = _launch("helicon_tpu_torch", name, monkeypatch, tmp_path)
    ref_argv, ref_fetched = _launch("helicon_tpu", name, monkeypatch, tmp_path)
    assert fetched == ref_fetched
    if argv[0] == "shiny":
        assert argv[:-1] == ref_argv[:-1] and Path(argv[-1]).name == "app.py"
        assert Path(argv[-1]).is_file()
    else:
        assert argv == ref_argv and argv[0] in ("streamlit", "browser")


def test_dispatcher_lists_the_references_commands(monkeypatch):
    """helicon-torch lists the reference's 17 subcommands; with shiny and
    streamlit present it dispatches a launcher."""
    import helicon_tpu.commands.helicon as ref
    from helicon_tpu_torch.commands import _launchers, helicon

    assert sorted(helicon.cli_commands) == sorted(ref.cli_commands)
    assert sorted(helicon.shiny_commands) == sorted(ref.shiny_commands)
    assert sorted(helicon.streamlit_commands) == sorted(ref.streamlit_commands)
    assert len(helicon.cli_commands + helicon.shiny_commands + helicon.streamlit_commands) == 17
    monkeypatch.setattr(helicon, "has_shiny", lambda: True)
    monkeypatch.setattr(helicon, "has_streamlit", lambda: True)
    calls = []
    monkeypatch.setattr(_launchers.subprocess, "call", lambda argv: calls.append(argv) or 0)
    helicon.main(["whereIsMyClass"])
    assert calls and Path(calls[0][-1]) == PORT_APPS / "whereIsMyClass" / "app.py"
    with pytest.raises(SystemExit):
        helicon.main(["hill", "--help"])
