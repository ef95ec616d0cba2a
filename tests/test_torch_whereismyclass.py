"""The port's whereIsMyClass compute layer (webApps/whereIsMyClass/
compute.py), helix/pitch.estimate_pitch_from_class2d and utils/cache.py
against the JAX package's, on the inputs of tests/test_whereismyclass.py.

Host copies must give equal results; the pair distances equal the
reference's bit for bit (exact float64 differences, sorted), the
resampled and band-passed micrograph lies within 1e-5 of the image's
range of the reference's, and the projection sheets within 1e-6 of the
sheet's largest value. The port runs here with ``device="cpu"``.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.helix import pitch as ref_pitch
from helicon_tpu.io.mrc import write_mrc
from helicon_tpu.webApps.whereIsMyClass import compute as ref
from helicon_tpu_torch.helix import pitch as port_pitch
from helicon_tpu_torch.webApps.whereIsMyClass import compute as port

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_whereismyclass import _cs_fixture, _helices  # noqa: E402


def _frames_equal(a, b):
    pd.testing.assert_frame_equal(a, b)
    assert a.attrs.keys() == b.attrs.keys()


def _project(n_mic=6, n_tube=4, n_class=5, seed=0):
    """A seeded Class2D project: filaments of 3-40 segments, two
    polarities, repeated track positions (d = 0 pairs) and classes that
    repeat along each filament."""
    rng = np.random.default_rng(seed)
    rows = []
    for mic in range(n_mic):
        for tube in range(1, n_tube + 1):
            n = int(rng.integers(3, 41))
            pos = np.round(np.sort(rng.uniform(0, 3000, n)), 2)
            pos[n // 2] = pos[n // 2 - 1]
            for s in range(n):
                rows.append(dict(
                    rlnImageName=f"{len(rows) + 1:06d}@s.mrcs",
                    rlnMicrographName=f"m{mic}.mrc",
                    rlnHelicalTubeID=tube,
                    rlnHelicalTrackLengthAngst=pos[s],
                    rlnClassNumber=int(rng.integers(1, n_class + 1)),
                    rlnAnglePsi=float(rng.choice([10.0, 190.0, 100.0, -80.0])
                                      + rng.normal(0, 2)),
                    rlnCoordinateX=float(rng.uniform(0, 4000)),
                    rlnCoordinateY=float(rng.uniform(0, 4000)),
                ))
    return pd.DataFrame(rows)


@pytest.mark.parametrize("path", ["/proj/Class2D/job042/run_it025_data.star",
                                  "/proj/J42/J42_020_particles.cs", "/proj/whatever.xyz",
                                  "/proj/Class3D/job1/run_it025_data.star"])
def test_layout_helpers_match_reference(path):
    assert port.get_project_root_dir(path) == ref.get_project_root_dir(path)
    assert port.get_class_file(path) == ref.get_class_file(path)


def test_selection_helpers_match_reference():
    df = _project()
    df["helixID"] = df["rlnHelicalTubeID"]
    for idx in ([0], [0, 2], [1, 3, 4], [8]):
        a, b = ref.select_classes(df, idx), port.select_classes(df, idx)
        assert [k for k, _ in a] == [k for k, _ in b]
        for (_, ga), (_, gb) in zip(a, b):
            _frames_equal(ga, gb)
        assert (port.get_filament_length(b, particle_box_length=100.0)
                == ref.get_filament_length(a, particle_box_length=100.0))
    a, b = ref.select_helices_from_helixID(df, [1, 3]), port.select_helices_from_helixID(df, [1, 3])
    assert [k for k, _ in a] == [k for k, _ in b]
    assert port.estimate_inter_segment_distance(df) == ref.estimate_inter_segment_distance(df)
    for n in (3, 5, 10):
        np.testing.assert_array_equal(port.get_class_abundance(df, n),
                                      ref.get_class_abundance(df, n))
    with pytest.raises(Exception):
        port.estimate_inter_segment_distance(_helices(1, 1))


@pytest.mark.parametrize("target", [-1, 50, 400, 10**9])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_pair_distances_equal_bit_for_bit(target, with_lengths, monkeypatch):
    df = _project()
    helices = ref.select_classes(df, [0, 1, 2, 3])
    lengths = ref.get_filament_length(helices) if with_lengths else None
    want, want_min = ref.compute_pair_distances(helices, lengths, target)
    got, got_min = port.compute_pair_distances(helices, lengths, target, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got_min == want_min
    # passes of a few filaments each break after the same filament
    monkeypatch.setattr(port, "PAIR_CHUNK_BYTES", 40_000)
    got, got_min = port.compute_pair_distances(helices, lengths, target, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got_min == want_min


def test_pair_distances_reference_cases():
    for df in (_helices(1, 4), _helices(3, 6, cls=2)):
        helices = list(df.groupby(["rlnMicrographName", "rlnHelicalTubeID"]))
        want, _ = ref.compute_pair_distances(helices)
        got, _ = port.compute_pair_distances(helices, device="cpu")
        np.testing.assert_array_equal(got, want)
    df = _helices(1, 4)
    df.loc[df.index[:2], "rlnAnglePsi"] = 190.0
    helices = list(df.groupby(["rlnMicrographName", "rlnHelicalTubeID"]))
    np.testing.assert_array_equal(port.compute_pair_distances(helices, device="cpu")[0],
                                  ref.compute_pair_distances(helices)[0])
    assert port.compute_pair_distances([], device="cpu") == ([], 0)


@pytest.mark.parametrize("csym,rise,classes", [(1, None, None), (2, 4.75, [0, 1]),
                                               (3, 4.75, [0, 2, 4])])
def test_pitch_from_class2d_matches_reference(csym, rise, classes):
    df = _project(n_mic=8, seed=3)
    want = ref_pitch.estimate_pitch_from_class2d(df, classes, csym=csym, rise=rise,
                                                 target_total_count=2000)
    got = port_pitch.estimate_pitch_from_class2d(df, classes, csym=csym, rise=rise,
                                                 target_total_count=2000, device="cpu")
    for k in ("pitch", "twist", "peak_dist", "harmonics"):
        assert got[k] == want[k]
    for a, b in zip(got["histogram"], want["histogram"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,apix,target", [((1000, 1400), 1.0, 4.0),
                                               ((1000, 1400), 1.0, 2.5),
                                               ((1000, 1400), 1.3, 5.0),
                                               ((1000, 1400), 1.0, 0.8)])
def test_get_micrograph_matches_reference(tmp_path, shape, apix, target):
    img = np.random.default_rng(4).normal(0, 1, shape).astype(np.float32)
    img += np.linspace(0, 3, shape[1], dtype=np.float32)[None, :]
    f = tmp_path / "mic.mrc"
    write_mrc(f, img, apix=apix)
    for low, high in ((20.0, 0.0), (0.0, 0.0), (20.0, 500.0)):
        want, wt, wa = ref.get_micrograph(str(f), target, low, high)
        got, gt, ga = port.get_micrograph(str(f), target, low, high, device="cpu")
        assert (gt, ga) == (wt, wa) and got.dtype == np.float32 and got.shape == want.shape
        span = float(want.max() - want.min())
        assert np.abs(got - want).max() <= 1e-5 * span


@pytest.mark.parametrize("shape,out", [((1000, 10), (400, 10)), ((37, 41), (20, 30)),
                                       ((10, 12), (23, 17)), ((64, 64), (16, 16)),
                                       ((50, 70), (40, 56))])
def test_resize_local_mean_matches_scipy(shape, out):
    data = np.random.default_rng(5).normal(0, 1, shape).astype(np.float32)
    data += np.tile(np.arange(shape[0], dtype=np.float32)[:, None], (1, shape[1]))
    want = ref._resize_local_mean(data, out)
    got = port._resize_local_mean(data, out, device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.ptp(want)))


def test_resize_local_mean_non_integer_factor_covers_full_field():
    data = np.tile(np.arange(1000, dtype=np.float32)[:, None], (1, 10))
    out = port._resize_local_mean(data, (400, 10), device="cpu").numpy()
    assert out.shape == (400, 10)
    assert abs(out.mean() - data.mean()) < data.mean() * 0.01
    assert out[-1, 0] > 0.95 * data[-1, 0]


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_projection_sheets_match_reference(tmp_path, kind):
    rng = np.random.default_rng(6)
    vols = [rng.random((24, 24, 24)).astype(np.float32) if kind == "random"
            else np.full((24, 24, 24), 3.0, np.float32) for _ in range(3)]
    files = []
    for i, v in enumerate(vols):
        files.append(tmp_path / f"run_it025_class{i + 1:03d}.mrc")
        write_mrc(files[-1], v, apix=1.5)
    want, wa, wn = ref.get_class3d_projections_from_files(files)
    got, ga, gn = port.get_class3d_projections_from_files(files, device="cpu")
    assert (ga, gn) == (wa, wn) and got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(float(np.abs(want).max()), 1))


def test_star_and_cs_ingest_match_reference(tmp_path):
    from helicon_tpu.io.metadata import dataframe2star
    from helicon_tpu.io.star import write_star

    df = _helices()
    df.attrs["optics"] = pd.DataFrame([dict(
        rlnOpticsGroup=1, rlnOpticsGroupName="opticsGroup1", rlnImagePixelSize=1.0,
        rlnVoltage=300.0, rlnSphericalAberration=2.7, rlnAmplitudeContrast=0.1)])
    df["rlnOpticsGroup"] = 1
    dataframe2star(df, tmp_path / "c2d.star")
    a = ref.star_to_dataframe(tmp_path / "c2d.star")
    b = port.star_to_dataframe(tmp_path / "c2d.star")
    pd.testing.assert_frame_equal(a, b)
    pd.testing.assert_frame_equal(a.attrs["optics"], b.attrs["optics"])
    assert a.attrs["starFile"] == b.attrs["starFile"]
    pd.testing.assert_frame_equal(ref.get_class2d_params_from_file(str(tmp_path / "c2d.star")),
                                  port.get_class2d_params_from_file(str(tmp_path / "c2d.star")))
    write_star(tmp_path / "bad.star", {"particles": _helices()})
    for mod in (ref, port):
        with pytest.raises(AssertionError):
            mod.star_to_dataframe(tmp_path / "bad.star")
    for base, sub in ((0, "a"), (10**12, "b")):
        (tmp_path / sub).mkdir()
        f = _cs_fixture(tmp_path / sub, uid_base=base)
        pd.testing.assert_frame_equal(ref.cs_to_dataframe(f), port.cs_to_dataframe(f))
        pd.testing.assert_frame_equal(ref.get_class2d_params_from_file(str(f)),
                                      port.get_class2d_params_from_file(str(f)))
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.get_class2d_params_from_file("whatever.xyz")


@pytest.mark.parametrize("shape", [(16, 20), (3, 16, 20)])
def test_class2d_from_file_matches_reference(tmp_path, shape):
    stack = np.random.default_rng(7).random(shape).astype(np.float32)
    write_mrc(tmp_path / "run_it020_classes.mrcs", stack, apix=1.23456)
    a, aa = ref.get_class2d_from_file(tmp_path / "run_it020_classes.mrcs")
    b, ba = port.get_class2d_from_file(tmp_path / "run_it020_classes.mrcs")
    np.testing.assert_array_equal(a, b)
    assert aa == ba


@pytest.fixture()
def plotly_shim(monkeypatch):
    """The figure builders on the functional test shim when the real
    plotly is absent (tests/_ref_shims/plotly)."""
    try:
        import plotly  # noqa: F401
    except ImportError:
        monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent / "_ref_shims"))
        for mod in [m for m in sys.modules if m.split(".")[0] == "plotly"]:
            sys.modules.pop(mod)
        importlib.import_module("plotly")
    yield
    for mod in [m for m in sys.modules if m.split(".")[0] == "plotly"]:
        sys.modules.pop(mod)


def _traces(fig):
    return [(d.name, np.asarray(getattr(d, "x", None), dtype=object).tolist(),
             np.asarray(getattr(d, "y", None), dtype=object).tolist()) for d in fig.data]


def test_figure_builders_match_reference(plotly_shim):
    figs = []
    for mod in (ref, port):
        fig = mod.plot_micrograph(np.arange(64, dtype=np.float32).reshape(8, 8), "t", 1.5,
                                  plot_width=100)
        mod.mark_classes_on_helices(
            fig, {(1, 2): dict(x=np.array([1.0, 2.0]), y=np.array([3.0, 4.0])),
                  (2, 5): dict(x=np.array([5.0]), y=np.array([6.0]))}, marker_size=5)
        mod.draw_distance_measurement(fig, (0.0, 0.0), (3.0, 4.0))
        hist = mod.plot_histogram([100.0, 200.0, 200.0, 410.0], "t", "pair dist (Å)", "count",
                                  max_pair_dist=400, show_pitch_twist=dict(rise=4.75,
                                                                          csyms=[1, 2]))
        figs.append((_traces(fig), _traces(hist), list(hist.data[0].hovertext)))
    assert figs[0] == figs[1]


def test_builders_raise_clean_importerror_without_plotly():
    try:
        import plotly  # noqa: F401

        pytest.skip("plotly installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="plotly"):
        port.plot_micrograph(np.zeros((4, 4)), "t", 1.0)


def test_cache_copy_matches_reference(tmp_path, monkeypatch):
    ref_cache = importlib.import_module("helicon_tpu.utils.cache")
    port_cache = importlib.import_module("helicon_tpu_torch.utils.cache")

    monkeypatch.setenv("HELICON_CACHE_DIR", str(tmp_path / "c"))
    assert port_cache.setup_cache_dir() == ref_cache.setup_cache_dir() == tmp_path / "c"
    calls = []

    def f(x, verbose=0):
        calls.append(x)
        return x * 2

    cached = port_cache.cache(cache_dir=tmp_path / "j", ignore=["verbose"], expires_after=7)(f)
    assert cached(3) == cached(3, verbose=1) == 6
    assert calls == [3]  # joblib keyed it, verbose ignored
    assert cached.__name__ == "f"
    port_cache.clear_cache(tmp_path / "j")
    assert list((tmp_path / "j").iterdir()) == []
    # no joblib (or no writable directory): the function passes through
    monkeypatch.setitem(sys.modules, "joblib", None)
    assert port_cache.cache(cache_dir=tmp_path / "k")(f) is f
    assert ref_cache.cache(cache_dir=tmp_path / "k")(f) is f
    assert port_cache.DummyMemory().cache(f) is f


def test_optional_loader_matches_reference(monkeypatch):
    from helicon_tpu.utils.system import optional_loader as ref_loader
    from helicon_tpu_torch.utils.system import optional_loader as port_loader

    for name, attr in (("numpy", "asarray"), ("numpy", "no_such"), ("no_such_module", "x")):
        assert port_loader(name, attr) is ref_loader(name, attr)
