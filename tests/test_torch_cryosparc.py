"""The port's cryosparc command and its option plugins (ops/cryosparc/)
against the JAX package's, on tests/test_proc3d_cryosparc_ops.py's
``cs_df``.

Each exposure option gives an equal frame, title and slots.
extractParticles' boxes lie within 1e-5 of each particle's peak of the
reference's (the float16 output within that plus one float16 ulp), under
both fill modes, both signs, normalise on and off; its frames are equal.
The command writes an equal .cs file, and server mode raises without
cryosparc-tools. The port runs here with ``device="cpu"``.
"""

import argparse
import collections
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.io.mrc import read_mrc, write_mrc
from helicon_tpu.ops import cryosparc as ref_ops
from helicon_tpu_torch.ops import cryosparc as port_ops
from helicon_tpu_torch.ops.cryosparc import extract as port_extract

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_proc3d_cryosparc_ops import EPU_CS_MICROS, cs_df  # noqa: E402,F401


def _dispatch(ops, option, data, param, device=None):
    args = argparse.Namespace(verbose=0)
    if device:
        args.device = device
    out = ops.dispatch(option, data, args, collections.defaultdict(int), param, "title",
                       set(), "ctf/exp_group_id", "location/micrograph_path", [1])
    return out[0], out[1], sorted(out[2])


def _both(option, df, param):
    want = _dispatch(ref_ops, option, df.copy(), param)
    got = _dispatch(port_ops, option, df.copy(), param, device="cpu")
    pd.testing.assert_frame_equal(got[0], want[0])
    assert got[1:] == want[1:]
    return got[0]


def test_plugin_names_match_reference():
    assert sorted(port_ops._plugins) == sorted(ref_ops._plugins)
    ref_parser, port_parser = argparse.ArgumentParser(), argparse.ArgumentParser()
    ref_ops.add_plugin_args(ref_parser)
    port_ops.add_plugin_args(port_parser)
    assert ([a.dest for a in port_parser._actions] == [a.dest for a in ref_parser._actions])


EXPOSURE = [
    ("changePixelSize", 2.4, False),
    ("assignExposureGroupPerMicrograph", 1, False),
    ("resetExposureGroups", 1, False),
    ("resetExposureGroups", 0, False),
    ("splitByMicrograph", 1, False),
    ("assignExposureGroupByBeamShiftLabel", "EPU", True),
    ("assignExposureGroupByBeamShiftLabel", "0", False),
    ("assignExposureGroupByBeamShiftLabel", None, False),
    ("assignExposureGroupByTime", 1, True),
    ("assignExposureGroupByTime", 3, True),
]


@pytest.mark.parametrize("option,param,epu", EXPOSURE)
def test_exposure_options_match_reference(cs_df, option, param, epu):
    df = cs_df.copy()
    if epu:
        df["location/micrograph_path"] = np.repeat(EPU_CS_MICROS, 4)
    if option == "resetExposureGroups":
        df["ctf/exp_group_id"] = np.repeat([1, 2, 3], 4)
    _both(option, df, param)


def test_beamshift_xy_matches_reference(cs_df, monkeypatch):
    import helicon_tpu.io.epu as ref_epu
    import helicon_tpu.io.metadata as ref_md
    import helicon_tpu_torch.io.epu as port_epu
    import helicon_tpu_torch.io.metadata as port_md

    shifts = {m: (float(i % 2), float(i)) for i, m in enumerate(["m1.mrc", "m2.mrc", "m3.mrc"])}
    for epu, md in ((ref_epu, ref_md), (port_epu, port_md)):
        monkeypatch.setattr(epu, "check_foilhole_xml_files", lambda m, f: None)
        monkeypatch.setattr(epu, "EPU_micrograph_path_2_movie_xml_path",
                            lambda micrograph_path, xml_folder: str(micrograph_path))
        monkeypatch.setattr(epu, "EPU_xml_2_beamshift", lambda xml_file: shifts[xml_file])
        monkeypatch.setattr(md, "assign_beamshifts_to_cluster",
                            lambda beamshifts, **kw: (beamshifts[:, 0] > 0.5).astype(int))
    df = cs_df.copy()
    df["mscope_params/beam_shift"] = [np.zeros(2)] * len(df)
    _both("assignExposureGroupByBeamShiftXY", df, "1")


def test_copy_assignments_and_parameters_match_reference(cs_df, tmp_path):
    from helicon_tpu.io.cs import write_cs
    from helicon_tpu.io.star import write_star

    for names, groups in ((["movies/m1.tiff", "movies/m2.tiff", "movies/m3.tiff"], [5, 6, 7]),
                          (["movies/m1.tiff"], [4])):
        write_star(tmp_path / "src.star", pd.DataFrame(
            {"rlnMicrographMovieName": names, "rlnOpticsGroup": groups}))
        _both("copyExposureGroupAssignments", cs_df, str(tmp_path / "src.star"))
    src = np.zeros(6, dtype=[("uid", "<u8"), ("location/micrograph_uid", "<u8"),
                             ("ctf/exp_group_id", "<u4"), ("ctf/tilt_A", "<f4")])
    src["uid"] = np.arange(6) + 900
    src["location/micrograph_uid"] = [1, 1, 2, 2, 3, 3]
    src["ctf/exp_group_id"] = [5, 5, 5, 5, 6, 6]
    src["ctf/tilt_A"] = [10.0, 20.0, 30.0, 40.0, 100.0, 200.0]
    write_cs(tmp_path / "src.cs", src)
    df = cs_df.copy()
    df["ctf/tilt_A"] = 0.0
    _both("copyExposureGroupParameters", df, f"source_cs_file={tmp_path / 'src.cs'}")
    for ops in (ref_ops, port_ops):
        with pytest.raises(Exception, match="source"):
            _dispatch(ops, "copyExposureGroupParameters", cs_df.copy(), "beam_tilt=1")
        with pytest.raises(Exception):
            _dispatch(ops, "changePixelSize", cs_df.drop(columns=["blob/psize_A"]), 2.0)


def _mic(path, shape=(512, 512), seed=0):
    mic = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    mic += np.linspace(-2, 2, shape[1], dtype=np.float32)[None, :]
    write_mrc(path, mic, apix=1.0)


def _particles(n=30, seed=1):
    """30 particles of one 512^2 micrograph, 6 of them crossing an edge."""
    rng = np.random.default_rng(seed)
    xs, ys = rng.uniform(0.1, 0.9, n), rng.uniform(0.1, 0.9, n)
    xs[:3] = [0.01, 0.99, 0.05]
    ys[3:6] = [0.02, 0.97, 0.995]
    return pd.DataFrame({
        "uid": np.arange(n, dtype=np.uint64) + 1,
        "location/micrograph_path": ["m1.mrc"] * n,
        "location/micrograph_psize_A": 1.0,
        "location/micrograph_shape": [(512, 512)] * n,
        "location/center_x_frac": xs,
        "location/center_y_frac": ys,
    })


@pytest.mark.parametrize("kw", [dict(), dict(fill_mode="mean"), dict(fill_mode=""),
                                dict(sign=1), dict(normalize=False), dict(fp16=True),
                                dict(fp16=True, sign=1, fill_mode="mean"),
                                dict(fft_crop_size=64)])
def test_extract_one_micrograph_matches_reference(tmp_path, kw):
    from helicon_tpu.ops.cryosparc import extract as ref_extract

    _mic(tmp_path / "m1.mrc")
    df = _particles()
    kw = dict(kw)
    crop = kw.pop("fft_crop_size", 32)
    want = ref_extract.extract_one_micrograph(df, 64, crop, tmp_path, tmp_path, "ref",
                                              force=True, **kw)
    got = port_extract.extract_one_micrograph(df, 64, crop, tmp_path, tmp_path, "port",
                                              force=True, device="cpu", **kw)
    pd.testing.assert_frame_equal(got.drop(columns="blob/path"), want.drop(columns="blob/path"))
    a, aa = read_mrc(tmp_path / "ref" / "m1.mrcs")
    b, ba = read_mrc(tmp_path / "port" / "m1.mrcs")
    assert a.dtype == b.dtype and a.shape == b.shape == (30, crop, crop) and aa == ba
    a, b = a.astype(np.float64), b.astype(np.float64)
    tol = 1e-5 * np.abs(a).max(axis=(1, 2), keepdims=True)
    if kw.get("fp16"):
        tol = tol + np.spacing(np.abs(a).astype(np.float16)).astype(np.float64)
    assert (np.abs(a - b) <= tol).all()
    # a second call finds the stack and skips the work
    again = port_extract.extract_one_micrograph(df, 64, crop, tmp_path, tmp_path, "port",
                                                device="cpu", **kw)
    pd.testing.assert_frame_equal(again, got)


def test_extract_particles_in_chunks_match_reference(tmp_path, monkeypatch):
    from helicon_tpu.ops.cryosparc import extract as ref_extract

    _mic(tmp_path / "m1.mrc", shape=(96, 80), seed=3)
    df = _particles(n=12)
    df["location/micrograph_shape"] = [(96, 80)] * 12
    df.loc[0, "location/center_x_frac"] = 0.0  # half the box off the micrograph
    monkeypatch.setattr(port_extract, "EXTRACT_CHUNK_BYTES_CPU", 32 * 32 * 16 * 5)
    ref_extract.extract_one_micrograph(df, 32, 16, tmp_path, tmp_path, "ref", force=True)
    port_extract.extract_one_micrograph(df, 32, 16, tmp_path, tmp_path, "port", force=True,
                                        device="cpu")
    a = read_mrc(tmp_path / "ref" / "m1.mrcs")[0]
    b = read_mrc(tmp_path / "port" / "m1.mrcs")[0]
    assert (np.abs(a - b) <= 1e-5 * np.abs(a).max(axis=(1, 2), keepdims=True) + 1e-12).all()


@pytest.mark.parametrize("param", ["box_size=16:fft_crop_size=8:fp16=0",
                                   "box_size=16:fp16=0:recenter=1",
                                   "box_size=16:fp16=0:flip_y=1:recenter=0:n_micrographs=2"])
def test_extract_option_matches_reference(tmp_path, cs_df, monkeypatch, param):
    monkeypatch.chdir(tmp_path)
    _mic(tmp_path / "m1.mrc", shape=(64, 64))
    for m in ("m2.mrc", "m3.mrc"):
        _mic(tmp_path / m, shape=(64, 64), seed=len(m))
    df = cs_df.copy()
    df["location/micrograph_psize_A"] = 1.0
    df["location/micrograph_shape"] = [(64, 64)] * len(df)
    df["location/center_x_frac"] = np.tile([0.25, 0.5, 0.75, 0.9], 3)
    df["location/center_y_frac"] = 0.5
    df["alignments3D/shift"] = [np.array([4.0, -2.0], np.float32)] * len(df)
    df["alignments3D/psize_A"] = 1.0
    want = _dispatch(ref_ops, "extractParticles", df.copy(), param)
    (tmp_path / "extract").rename(tmp_path / "extract_ref")
    got = _dispatch(port_ops, "extractParticles", df.copy(), param, device="cpu")
    assert got[1:] == want[1:]
    assert list(got[0].columns) == list(want[0].columns)
    for c in want[0].columns:
        if c == "alignments3D/shift":
            np.testing.assert_array_equal(np.stack(got[0][c]), np.stack(want[0][c]))
        else:
            pd.testing.assert_series_equal(got[0][c], want[0][c])
    for f in sorted((tmp_path / "extract_ref").iterdir()):
        a, b = read_mrc(f)[0], read_mrc(tmp_path / "extract" / f.name)[0]
        assert (np.abs(a - b) <= 1e-5 * np.abs(a).max(axis=(1, 2), keepdims=True)).all()


def _cs_files(tmp_path):
    from helicon_tpu.io.cs import write_cs

    _mic(tmp_path / "m1.mrc", shape=(128, 128))
    n = 10
    arr = np.zeros(n, dtype=[("uid", "<u8"), ("blob/path", "S20"), ("blob/idx", "<u4"),
                             ("blob/psize_A", "<f4"), ("ctf/df1_A", "<f4"),
                             ("ctf/exp_group_id", "<u4"),
                             ("location/micrograph_uid", "<u8"),
                             ("location/micrograph_path", "S20"),
                             ("location/micrograph_psize_A", "<f4"),
                             ("location/micrograph_shape", "<u4", (2,)),
                             ("location/center_x_frac", "<f4"),
                             ("location/center_y_frac", "<f4")])
    arr["uid"] = np.arange(n) + 50
    arr["blob/path"] = b"old/m1.mrcs"
    arr["blob/idx"] = np.arange(n)
    arr["blob/psize_A"] = 1.0
    arr["ctf/df1_A"] = 15000.0
    arr["ctf/exp_group_id"] = 1
    arr["location/micrograph_uid"] = 1
    arr["location/micrograph_path"] = b"m1.mrc"
    arr["location/micrograph_psize_A"] = 1.0
    arr["location/micrograph_shape"] = (128, 128)
    arr["location/center_x_frac"] = np.linspace(0.05, 0.95, n)
    arr["location/center_y_frac"] = np.linspace(0.9, 0.1, n)
    write_cs(tmp_path / "J3_particles.cs", arr)


@pytest.mark.parametrize("options", [["--extractParticles", "box_size=32:fft_crop_size=16"],
                                     ["--changePixelSize", "2.0",
                                      "--assignExposureGroupPerMicrograph", "1",
                                      "--splitByMicrograph", "1"]])
def test_command_writes_equal_cs(tmp_path, monkeypatch, options):
    from helicon_tpu.commands import cryosparc as ref_cmd
    from helicon_tpu_torch.commands import cryosparc as port_cmd

    monkeypatch.chdir(tmp_path)
    _cs_files(tmp_path)
    outs = {}
    for name, mod, extra in (("ref", ref_cmd, []), ("port", port_cmd, ["--device", "cpu"])):
        argv = ["--csFile", "J3_particles.cs", "--output_csFile", f"{name}.cs",
                "--verbose", "0"] + options + extra
        parser = argparse.ArgumentParser()
        mod.add_args(parser)
        args = parser.parse_args(argv)
        monkeypatch.setattr(sys, "argv", ["cryosparc"] + argv)
        mod.main(mod.check_args(args, parser))
        outs[name] = (tmp_path / f"{name}.cs").read_bytes()
        if (tmp_path / "extract").exists():
            (tmp_path / "extract").rename(tmp_path / f"extract_{name}")
    assert outs["port"] == outs["ref"]
    if (tmp_path / "extract_ref").exists():
        a = read_mrc(tmp_path / "extract_ref" / "m1.mrcs")[0].astype(np.float64)
        b = read_mrc(tmp_path / "extract_port" / "m1.mrcs")[0].astype(np.float64)
        tol = 1e-5 * np.abs(a).max(axis=(1, 2), keepdims=True)
        assert (np.abs(a - b) <= tol + np.spacing(np.abs(a).astype(np.float16))).all()


def test_command_argv_plan_and_checks(tmp_path):
    from helicon_tpu_torch.commands import cryosparc as port_cmd
    from helicon_tpu_torch.utils.exceptions import HeliconValidationError

    parser = argparse.ArgumentParser()
    port_cmd.add_args(parser)
    argv = ["--csFile", "a.cs", "--changePix", "2", "--device", "cpu", "--splitByMicrograph",
            "1"]
    args = port_cmd.check_args(parser.parse_args(argv), parser, argv)
    assert args.all_options == ["changePixelSize", "splitByMicrograph"]
    assert parser.parse_args(["--csFile", "a.cs"]).device == "cuda"
    for bad in (["--csFile", "a.cs", "-p", "P1", "-j", "J1"], []):
        with pytest.raises(HeliconValidationError):
            port_cmd.check_args(parser.parse_args(bad), parser, bad)


def test_server_mode_raises_without_cryosparc_tools(monkeypatch):
    from helicon_tpu_torch.commands import cryosparc as port_cmd
    from helicon_tpu_torch.utils.exceptions import HeliconDependencyError

    monkeypatch.setitem(sys.modules, "cryosparc", None)
    parser = argparse.ArgumentParser()
    port_cmd.add_args(parser)
    argv = ["-p", "P1", "-j", "J2", "--device", "cpu"]
    args = port_cmd.check_args(parser.parse_args(argv), parser, argv)
    with pytest.raises(HeliconDependencyError, match="cryosparc-tools"):
        port_cmd.main(args)


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    from helicon_tpu_torch.commands import cryosparc as port_cmd
    from helicon_tpu_torch.utils.exceptions import HeliconError

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    _cs_files(tmp_path)
    parser = argparse.ArgumentParser()
    port_cmd.add_args(parser)
    argv = ["--csFile", "J3_particles.cs", "--extractParticles", "box_size=32"]
    with pytest.raises(HeliconError, match="no CUDA device"):
        port_cmd.main(port_cmd.check_args(parser.parse_args(argv), parser, argv))
