"""The images2star options of the PyTorch port against the JAX package's,
on the reference's own test cases.

Every test of tests/test_images2star.py and tests/test_images2star_more.py
runs twice, in two working directories of equal path length: once as it
stands (``helicon_tpu.ops.images2star.dispatch``) and once with its module's
``plug`` replaced by the port's ``helicon_tpu_torch.ops.images2star`` with
``device="cpu"``. Both runs must pass the reference test's own assertions.
Each dispatch call's output frame must then be equal
(``assert_frame_equal``, exact, ``.attrs`` with the optics table too), a
failing call must raise the same error with the same message, and each
written file must agree:

* MRC files: the same header (but the statistics dmin / dmax / dmean / rms)
  and the same voxels, within the tolerance of the option that wrote them:
  createStack 1e-6 of the image's peak in float32, and with float16=1 that
  plus one float16 ulp of the value (the float32 values agree within 1e-6 of
  the peak, then each rounds to float16); extractHelices 1e-5 of the peak;
  denoiseCurvelet 1e-5 of the peak (tests/test_torch_curvelet.py's gate on
  the denoisers); every other option exactly (maskGold too: these cases run
  no high-pass filter, so its mask is computed from the same values);
* any other file byte for byte, once the working directory is written the
  same in both.

The images are compared one by one. The registry test reads the port's
``_plugins``. An error of the port's own classes reaches the reference test
as the reference's class of the same name and message. Further cases at the
end hold what the reference's tests do not reach: maskGold's high-pass path
(masks equal but for pixels within 1e-5 relative of the threshold),
createStack's padding and float16 stack, calibratePixelSize on a gold ring,
the denoiseCurvelet seams and errors, and each option raising without a card
when asked for one.
"""

import argparse
import collections
import importlib.util
import inspect
import random
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)

import helicon_tpu.ops.images2star as ref_plug
import helicon_tpu_torch.ops.images2star as port_plug
from helicon_tpu.io.mrc import mrc_header, read_mrc, write_mrc
from helicon_tpu.utils import exceptions as ref_exceptions
from helicon_tpu_torch.io import epu as port_epu
from helicon_tpu_torch.utils import exceptions as port_exceptions
from helicon_tpu_torch.utils.exceptions import HeliconError

HERE = Path(__file__).parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_MODULES = {name: _load(name) for name in ("test_images2star", "test_images2star_more")}


def _cases():
    out = []
    for mname, mod in REF_MODULES.items():
        for name, obj in vars(mod).items():
            if name.startswith("test_") and inspect.isfunction(obj):
                out.append((mname, None, name))
            elif name.startswith("Test") and inspect.isclass(obj):
                out += [(mname, name, m) for m in vars(obj) if m.startswith("test_")]
    return out


CASES = _cases()

# the options whose images are compared within a tolerance (of the image's
# peak); the rest must write the same bytes
IMAGE_TOL = {"createStack": 1e-6, "extractHelices": 1e-5, "denoiseCurvelet": 1e-5}


class _Recorder:
    """Stands in for a reference test module's ``plug``: dispatches to one
    package and records each call's result and the files it wrote."""

    def __init__(self, pkg, run_dir, device=None):
        self.pkg, self.run_dir, self.device = pkg, run_dir, device
        self._plugins = pkg._plugins
        self.calls = []
        self.files = {}
        self._seen = self._snapshot()

    def _snapshot(self):
        return {p: (p.stat().st_mtime_ns, p.stat().st_size)
                for p in self.run_dir.rglob("*") if p.is_file()}

    def dispatch(self, option, data, args, index_d, param):
        if self.device is not None:
            args.device = self.device
        try:
            out = self.pkg.dispatch(option, data, args, index_d, param)
        except BaseException as e:
            self.calls.append((option, "raise", type(e).__name__, _norm(str(e), self.run_dir)))
            if type(e) is getattr(port_exceptions, type(e).__name__, None):
                # the reference test expects its own package's class
                raise getattr(ref_exceptions, type(e).__name__)(*e.args) from e
            raise
        finally:
            now = self._snapshot()
            for p, st in now.items():
                if self._seen.get(p) != st:
                    self.files[p.relative_to(self.run_dir)] = option
            self._seen = now
        frame = out[0].copy(deep=True)
        frame.attrs = {k: (v.copy(deep=True) if isinstance(v, pd.DataFrame) else v)
                       for k, v in out[0].attrs.items()}
        self.calls.append((option, "frame", frame))
        return out


def _norm(text, run_dir):
    return text.replace(str(run_dir) + "/", "<RUN>/")


def _norm_frame(df, run_dir):
    """The frame with the run directory written as <RUN>, and each
    *CreateTime column (a file's st_ctime, which differs between the two
    runs) as the order of its values."""
    df = df.copy()
    for c in df.columns:
        if c.endswith("CreateTime"):
            df[c] = df[c].rank(method="dense")
            continue
        if df[c].dtype == object or pd.api.types.is_string_dtype(df[c]):
            df[c] = df[c].map(lambda v: _norm(v, run_dir) if isinstance(v, str) else v)
    return df


def _run_case(case, run_dir, recorder_pkg, device, relion_df):
    mname, cname, fname = case
    mod = REF_MODULES[mname]
    run_dir.mkdir()
    rec = _Recorder(recorder_pkg, run_dir, device)
    np.random.seed(0)
    random.seed(0)
    if hasattr(port_epu.EPU_micrograph_path_2_movie_xml_path, "xml_files"):
        port_epu.EPU_micrograph_path_2_movie_xml_path.xml_files = {}
    fn = getattr(getattr(mod, cname)(), fname) if cname else getattr(mod, fname)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "plug", rec)
        mp.chdir(run_dir)
        kwargs = {}
        for p in inspect.signature(fn).parameters:
            if p == "tmp_path":
                kwargs[p] = run_dir
            elif p == "monkeypatch":
                kwargs[p] = mp
            elif p == "relion_df":
                df = relion_df.copy(deep=True)
                df.attrs = dict(relion_df.attrs)
                kwargs[p] = df
            else:
                raise AssertionError(f"unexpected fixture {p}")
        fn(**kwargs)
    return rec


def _compare_mrc(a, b, option, name):
    ha, hb = Path(a).read_bytes()[:1024], Path(b).read_bytes()[:1024]
    if len(ha) < 1024:  # a stand-in file of a test, not an MRC
        assert Path(a).read_bytes() == Path(b).read_bytes(), name
        return
    stats = list(range(76, 88)) + list(range(216, 220))
    keep = [i for i in range(1024) if i not in stats]
    assert bytes(ha[i] for i in keep) == bytes(hb[i] for i in keep), name
    da, _ = read_mrc(a)
    db, _ = read_mrc(b)
    assert da.shape == db.shape and da.dtype == db.dtype, name
    tol = IMAGE_TOL.get(option)
    if tol is None:
        assert Path(a).read_bytes()[1024:] == Path(b).read_bytes()[1024:], name
        return
    da = np.asarray(da, np.float64).reshape(-1, *da.shape[-2:])
    db = np.asarray(db, np.float64).reshape(-1, *db.shape[-2:])
    for i, (x, y) in enumerate(zip(da, db)):
        peak = max(np.abs(x).max(), 1e-30)
        if read_mrc(a)[0].dtype == np.float16:
            # the float32 gate, then at most one float16 rounding step
            ulp = np.spacing(np.abs(x).astype(np.float16)).astype(np.float64)
            assert (np.abs(x - y) <= ulp + tol * peak).all(), (name, i)
        else:
            assert np.abs(x - y).max() <= tol * peak, (name, i, np.abs(x - y).max() / peak)


@pytest.mark.parametrize("case", CASES, ids=[".".join(p for p in c[1:] if p) for c in CASES])
def test_reference_case_matches(case, tmp_path, relion_df):
    ref = _run_case(case, tmp_path / "r", ref_plug, None, relion_df)
    port = _run_case(case, tmp_path / "p", port_plug, "cpu", relion_df)
    assert len(ref.calls) == len(port.calls), ([c[:2] for c in ref.calls], [c[:2] for c in port.calls])
    for r, p in zip(ref.calls, port.calls):
        assert r[:2] == p[:2]
        if r[1] == "raise":
            assert r[2:] == p[2:]
            continue
        fr, fp = _norm_frame(r[2], tmp_path / "r"), _norm_frame(p[2], tmp_path / "p")
        pd.testing.assert_frame_equal(fr, fp, check_exact=True)
        assert set(r[2].attrs) == set(p[2].attrs)
        for k, v in r[2].attrs.items():
            w = p[2].attrs[k]
            if isinstance(v, pd.DataFrame):
                pd.testing.assert_frame_equal(v, w, check_exact=True)
            elif isinstance(v, str):
                assert _norm(v, tmp_path / "r") == _norm(w, tmp_path / "p"), k
            else:
                assert v == w, k
    assert ref.files == port.files
    for rel, option in ref.files.items():
        a, b = tmp_path / "r" / rel, tmp_path / "p" / rel
        if rel.suffix in (".mrc", ".mrcs"):
            _compare_mrc(a, b, option, str(rel))
        else:
            ta, tb = a.read_bytes(), b.read_bytes()
            assert _norm(ta.decode("latin-1"), tmp_path / "r") == _norm(
                tb.decode("latin-1"), tmp_path / "p"), str(rel)


def test_all_reference_cases_collected():
    assert len(CASES) == 75


# ---------------------------------------------------------------------------
# what the reference's cases do not reach
# ---------------------------------------------------------------------------


def _args(**kw):
    ns = argparse.Namespace(verbose=0, folder=[], output_starFile="out.star")
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _both(option, df, param, tmp_path, **kw):
    """(reference frame, port frame), each run in its own directory."""
    outs = []
    for pkg, sub, dev in ((ref_plug, "r", None), (port_plug, "p", "cpu")):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            args = _args(**kw) if dev is None else _args(device=dev, **kw)
            data = df.copy(deep=True)
            data.attrs = {k: (v.copy() if isinstance(v, pd.DataFrame) else v)
                          for k, v in df.attrs.items()}
            outs.append(pkg.dispatch(option, data, args, collections.defaultdict(int),
                                     param.replace("<RUN>", str(d)))[0])
    return outs


def _particles(n, file):
    return pd.DataFrame({"rlnImageName": [f"{i + 1:06d}@{file}" for i in range(n)]})


def _gold_images(n, size, seed=0):
    g = np.random.default_rng(seed)
    imgs = g.normal(0, 1, (n, size, size)).astype(np.float32)
    y, x = np.mgrid[:size, :size]
    imgs += (0.3 * np.sin(2 * np.pi * x / size))[None].astype(np.float32)
    for img in imgs:
        for cy, cx in g.uniform(4, size - 4, (3, 2)):
            img[(y - cy) ** 2 + (x - cx) ** 2 < 9] = 40.0
    return imgs


def _gold_mask_reference(img, apix, value_sigma, gradient_sigma, min_area):
    """The reference's maskGold decision on one image (its median, MAD and
    threshold) with the JAX package's high-pass filter."""
    from helicon_tpu.core.filters import low_high_pass_filter

    frac = 2 * apix / gradient_sigma
    img = img - np.asarray(low_high_pass_filter(img, low_pass_fraction=min(frac, 1.0)))
    med = np.median(img)
    mad = np.median(np.abs(img - med)) + 1e-12
    hi, lo = med + value_sigma * mad * 1.4826, med - value_sigma * mad * 1.4826
    return img, hi, lo


@pytest.mark.parametrize("route", ["particles", "micrograph"])
def test_mask_gold_high_pass_matches(route, tmp_path):
    """With the high-pass filter on (gradient_sigma > 0), the outputs agree
    wherever both packages mask or both keep; a pixel masked by one only
    lies within 1e-5 relative of a threshold; the noise is the same draw."""
    imgs = _gold_images(3, 48)
    write_mrc(tmp_path / "p.mrcs", imgs, apix=1.0)
    if route == "particles":
        df = _particles(3, tmp_path / "p.mrcs")
    else:
        write_mrc(tmp_path / "m.mrc", imgs[0], apix=1.0)
        df = pd.DataFrame({"rlnMicrographName": [str(tmp_path / "m.mrc")] * 2})
        imgs = imgs[:1]
    param = "value_sigma=4:gradient_sigma=12:min_area=4:outdir=<RUN>/masked"
    fr, fp = _both("maskGold", df, param, tmp_path)
    name = "p.mrcs" if route == "particles" else "m.mrc"
    outr = read_mrc(tmp_path / "r" / "masked" / name)[0].reshape(-1, 48, 48)
    outp = read_mrc(tmp_path / "p" / "masked" / name)[0].reshape(-1, 48, 48)
    pd.testing.assert_frame_equal(_norm_frame(fr, tmp_path / "r"), _norm_frame(fp, tmp_path / "p"),
                                  check_exact=True)
    masked_any = 0
    for img, a, b in zip(imgs, outr, outp):
        filt, hi, lo = _gold_mask_reference(img, 1.0, 4.0, 12.0, 4.0)
        close = np.isclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(filt).max())
        near = (np.abs(filt - hi) <= 1e-5 * abs(hi)) | (np.abs(filt - lo) <= 1e-5 * abs(lo))
        assert (close | near).all()
        masked_any += int((~np.isclose(a, filt, atol=1e-5 * np.abs(filt).max())).sum())
    assert masked_any > 0


@pytest.mark.parametrize("param,dtype", [
    ("<RUN>/s.mrcs:rescale2size=48:float16=0", np.float32),
    ("<RUN>/s.mrcs:rescale2size=16", np.float16),
    ("<RUN>/s.mrcs:rescale2size=24:float16=0", np.float32),
])
def test_create_stack_sizes(param, dtype, tmp_path):
    """Padding (48 > 32), a float16 crop (16) and a float32 crop (24) from
    two source stacks in the rows' order, with the optics table updated."""
    g = np.random.default_rng(3)
    write_mrc(tmp_path / "a.mrcs", g.normal(size=(5, 32, 32)).astype(np.float32), apix=1.5)
    write_mrc(tmp_path / "b.mrcs", g.normal(size=(4, 32, 32)).astype(np.float32), apix=1.5)
    names = [f"{i:06d}@{tmp_path}/{f}" for f, i in
             [("b.mrcs", 2), ("a.mrcs", 5), ("a.mrcs", 1), ("b.mrcs", 4), ("a.mrcs", 3)]]
    df = pd.DataFrame({"rlnImageName": names, "rlnOpticsGroup": 1})
    df.attrs["optics"] = pd.DataFrame({"rlnOpticsGroup": [1], "rlnImagePixelSize": [1.5],
                                       "rlnImageSize": [32]})
    fr, fp = _both("createStack", df, param, tmp_path)
    for f in (fr, fp):
        f["rlnImageName"] = f["rlnImageName"].str.replace(str(tmp_path), "", regex=False)
        f["rlnImageName"] = f["rlnImageName"].str.replace("/r/", "/").str.replace("/p/", "/")
    pd.testing.assert_frame_equal(fr, fp, check_exact=True)
    pd.testing.assert_frame_equal(fr.attrs["optics"], fp.attrs["optics"], check_exact=True)
    a, _ = read_mrc(tmp_path / "r" / "s.mrcs")
    b, _ = read_mrc(tmp_path / "p" / "s.mrcs")
    assert a.dtype == b.dtype == dtype and a.shape == b.shape
    _compare_mrc(tmp_path / "r" / "s.mrcs", tmp_path / "p" / "s.mrcs", "createStack", "s")


def test_create_stack_chunks(tmp_path, monkeypatch):
    """A stack larger than one chunk writes what one chunk would."""
    from helicon_tpu_torch.ops.images2star import stacks

    write_mrc(tmp_path / "a.mrcs", _gold_images(7, 32), apix=1.0)
    df = _particles(7, tmp_path / "a.mrcs")
    outs = []
    for pixels in (1 << 24, 3 * 32 * 32):
        monkeypatch.setattr(stacks, "STACK_CHUNK_PIXELS", pixels)
        port_plug.dispatch("createStack", df.copy(), _args(device="cpu"),
                           collections.defaultdict(int),
                           f"{tmp_path}/c{pixels}.mrcs:rescale2size=16:float16=0")
        outs.append(read_mrc(tmp_path / f"c{pixels}.mrcs")[0])
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-6 * np.abs(outs[0]).max())


def test_create_stack_more_stacks_than_open_maps(tmp_path, monkeypatch):
    """Six source stacks read in a shuffled row order with at most two memory
    maps open: never more than two maps alive, and the reference's stack
    and frame."""
    import weakref

    from helicon_tpu_torch.io import mrc as port_mrc
    from helicon_tpu_torch.ops.images2star import stacks

    g = np.random.default_rng(5)
    for k in range(6):
        write_mrc(tmp_path / f"s{k}.mrcs", g.normal(size=(3, 16, 16)).astype(np.float32),
                  apix=1.0)
    names = [f"{i:06d}@{tmp_path}/s{k}.mrcs" for k in range(6) for i in (1, 2, 3)]
    df = pd.DataFrame({"rlnImageName": [names[i] for i in g.permutation(len(names))]})
    live, real = [], port_mrc.read_mrc

    def counted(path, mmap=False):
        out = real(path, mmap=mmap)
        live.append(weakref.ref(out[0]))
        alive.append(sum(r() is not None for r in live))
        return out

    alive = []
    monkeypatch.setattr(stacks, "STACK_OPEN_MAPS", 2)
    monkeypatch.setattr(port_mrc, "read_mrc", counted)
    fr, fp = _both("createStack", df, "<RUN>/s.mrcs:float16=0", tmp_path)
    assert len(live) > 6 and max(alive) == 2
    for f in (fr, fp):
        f["rlnImageName"] = f["rlnImageName"].str.replace("/r/", "/").str.replace("/p/", "/")
    pd.testing.assert_frame_equal(fr, fp, check_exact=True)
    _compare_mrc(tmp_path / "r" / "s.mrcs", tmp_path / "p" / "s.mrcs", "createStack", "s")


def _ring_images(n, size, apix_true, apix_nominal, res, seed=0):
    g = np.random.default_rng(seed)
    f = 1.0 / (res * apix_nominal / apix_true)
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    img = sum(np.cos(2 * np.pi * f * (x * np.cos(t) + y * np.sin(t)))
              for t in np.linspace(0, np.pi, 8, endpoint=False))
    return np.stack([img + 0.2 * g.normal(size=(size, size)) for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("standard,res,chunk", [("gold", 2.355, None), ("ice", 3.661, 1)])
def test_calibrate_pixel_size_matches(standard, res, chunk, tmp_path, monkeypatch):
    """The same apix_new (and so the same frame) on a planted ring, with the
    images in one chunk and one image a chunk."""
    from helicon_tpu_torch.ops.images2star import heavy

    if chunk is not None:
        monkeypatch.setattr(heavy, "CALIBRATE_CHUNK_SAMPLES", chunk)
    write_mrc(tmp_path / "d.mrcs", _ring_images(3, 128, 1.02, 1.0, res), apix=1.0)
    df = _particles(3, tmp_path / "d.mrcs")
    df["rlnImagePixelSize"] = 1.0
    df["rlnDefocusU"] = df["rlnDefocusV"] = 10000.0
    fr, fp = _both("calibratePixelSize", df, standard, tmp_path)
    pd.testing.assert_frame_equal(fr, fp, check_exact=True)
    assert fp["rlnImagePixelSize"].iloc[0] == pytest.approx(1.02, abs=0.01)


def test_denoise_curvelet_micrograph_seam(tmp_path, monkeypatch):
    """The micrograph route calls curvelet_denoise_batch_<transform> through
    the port's module attribute once, with every unique micrograph on the
    host and the command's device (the batch takes them there one at a
    time)."""
    from helicon_tpu_torch.core import curvelet

    g = np.random.default_rng(0)
    for k in range(2):
        write_mrc(tmp_path / f"m{k}.mrc", g.normal(size=(32, 32)).astype(np.float32), apix=1.0)
    df = pd.DataFrame({"rlnMicrographName": [str(tmp_path / f"m{k}.mrc") for k in (0, 1, 0)]})
    seen = []

    def fake(imgs, threshold_sigma, **kw):
        seen.append((len(imgs), threshold_sigma, kw, {type(img) for img in imgs}))
        return [np.full((32, 32), i, np.float32) for i in range(len(imgs))]

    monkeypatch.setattr(curvelet, "curvelet_denoise_batch_mct", fake)
    out = port_plug.dispatch("denoiseCurvelet", df, _args(device="cpu"),
                             collections.defaultdict(int),
                             f"sigma=2:numScales=3:outdir={tmp_path}/dn")[0]
    assert seen == [(2, 2.0, {"n_scales": 3, "device": torch.device("cpu")}, {np.ndarray})]
    assert read_mrc(tmp_path / "dn" / "m1.mrc")[0].max() == 1
    assert list(out["rlnMicrographName"]) == [str(tmp_path / "dn" / f"m{k}.mrc") for k in (0, 1, 0)]


@pytest.mark.parametrize("param", ["transform=udct:tileSize=24:overlap=8", "sigma=0",
                                   "transform=mct:numScales=3"])
def test_denoise_curvelet_particles_matches(param, tmp_path):
    """Tiled, elbow-threshold and mct particle stacks within 1e-5 of each
    image's peak."""
    g = np.random.default_rng(2)
    clean = np.zeros((3, 40, 40), np.float32)
    clean[:, 14:26, 6:34] = 1.0
    write_mrc(tmp_path / "p.mrcs", clean + 0.5 * g.normal(size=clean.shape).astype(np.float32),
              apix=1.0)
    df = _particles(3, tmp_path / "p.mrcs")
    _both("denoiseCurvelet", df, param + ":outdir=<RUN>/dn", tmp_path)
    _compare_mrc(tmp_path / "r" / "dn" / "p.mrcs", tmp_path / "p" / "dn" / "p.mrcs",
                 "denoiseCurvelet", "p")


@pytest.mark.parametrize("param,match", [
    ("transform=mct:gpu=1", "MCT does not support GPU"),
    ("transform=curv", "unknown transform 'curv'"),
])
def test_denoise_curvelet_errors_match(param, match, tmp_path):
    df = _particles(1, tmp_path / "none.mrcs")
    msgs = []
    for pkg, kw in ((ref_plug, {}), (port_plug, {"device": "cpu"})):
        with pytest.raises(Exception, match=match) as e:
            pkg.dispatch("denoiseCurvelet", df.copy(), _args(**kw),
                         collections.defaultdict(int), param)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]


def test_extract_helices_two_micrographs(tmp_path):
    """Strips of two micrographs (uploaded once each), the longest helices
    first by micrograph, within 1e-5."""
    from helicon_tpu.io.star import write_star

    g = np.random.default_rng(4)
    rows = []
    for k in range(2):
        mic = g.normal(size=(64, 80)).astype(np.float32)
        write_mrc(tmp_path / f"mic{k}.mrc", mic, apix=1.5)
        coords = pd.DataFrame({"rlnCoordinateX": [8.0, 60.0, 10.0, 70.5 - k],
                               "rlnCoordinateY": [10.0, 50.0, 40.0, 12.25]})
        write_star(tmp_path / f"mic{k}.star", coords)
        rows.append({"rlnMicrographName": str(tmp_path / f"mic{k}.mrc"),
                     "rlnCoordinateFileName": str(tmp_path / f"mic{k}.star")})
    fr, fp = _both("extractHelices", pd.DataFrame(rows), "width=12:outPath=<RUN>/h", tmp_path)
    assert len(fr) == len(fp) == 4
    for i in range(4):
        _compare_mrc(tmp_path / "r" / "h" / f"helix_{i:05d}.mrc",
                     tmp_path / "p" / "h" / f"helix_{i:05d}.mrc", "extractHelices", str(i))


@pytest.mark.parametrize("option,param", [
    ("createStack", "s.mrcs:float16=0"),
    ("calibratePixelSize", "gold"),
    ("maskGold", "value_sigma=4"),
    ("denoiseCurvelet", "sigma=3"),
    ("extractHelices", "width=16"),
])
def test_pixel_options_raise_without_card(option, param, tmp_path, monkeypatch):
    """Asked for the card where there is none, an option raises and moves
    nothing to the CPU."""
    from helicon_tpu.io.star import write_star

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_mrc(tmp_path / "p.mrcs", _ring_images(2, 64, 1.0, 1.0, 2.355), apix=1.0)
    write_star(tmp_path / "c.star", pd.DataFrame({"rlnCoordinateX": [4.0, 40.0],
                                                  "rlnCoordinateY": [8.0, 8.0]}))
    df = _particles(2, tmp_path / "p.mrcs")
    df["rlnImagePixelSize"] = 1.0
    df["rlnMicrographName"] = str(tmp_path / "p.mrcs")
    df["rlnCoordinateFileName"] = str(tmp_path / "c.star")
    with pytest.raises(HeliconError, match="no CUDA device"):
        port_plug.dispatch(option, df, _args(device="cuda"), collections.defaultdict(int), param)
