"""The proc3d command of the PyTorch port (``helicon-torch proc3d ...
--device cpu``, through commands/helicon.main) against the JAX package's
proc3d command (eagerly where helical_sym resamples, ROADMAP C6), both run
in this process on an .mrc written to tmp_path:
each option (1e-5 relative to the reference's peak; helical_sym at
tests/test_torch_core_web.py's gate, also 1e-5; denoiseCurvelet with
its parameters, "" at its defaults), a chained command, an abbreviated
option, the reference's error cases with the same messages (the fdct
transform of denoiseCurvelet among them), --device cuda raising without a
card, and the pins of the utils/system.py and ops/registry.py copies."""

import argparse
import contextlib
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import helicon_tpu.ops.proc3d as ref_ops
from helicon_tpu.commands import proc3d as ref_proc3d
from helicon_tpu.io.mrc import read_mrc, write_mrc
from helicon_tpu.ops import registry as ref_registry
from helicon_tpu.utils import system as ref_system
from helicon_tpu_torch.commands import helicon
from helicon_tpu_torch.commands import proc3d
from helicon_tpu_torch.ops import proc3d as ops_proc3d
from helicon_tpu_torch.ops import registry
from helicon_tpu_torch.utils import system
from helicon_tpu_torch.utils.exceptions import HeliconError


def _map(shape, seed=0):
    g = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n) - n // 2 for n in shape), indexing="ij")
    v = np.zeros(shape)
    for c in g.uniform(-5, 5, size=(5, 3)):
        r2 = (x - c[2]) ** 2 + (y - c[1]) ** 2
        v += np.exp(-r2 / 6.0) * (1 + 0.5 * np.cos(2 * np.pi * (z - c[0]) / 4.75))
    return (v + 0.05 * g.normal(size=shape)).astype(np.float32)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_mrc(tmp_path / "in.mrc", _map((24, 24, 24)), apix=1.5)
    write_mrc(tmp_path / "odd.mrc", _map((25, 23, 27), 1), apix=1.25)
    return tmp_path


def _run_ref(argv, monkeypatch):
    """The reference's command; eagerly where helical_sym resamples: jitted,
    XLA fuses the multiply-adds of apply_helical_symmetry's coordinates and
    moves samples that land on a voxel edge (ROADMAP C6; at new_apix / apix
    = 4/3 the jitted map is 0.11 of its peak from its own eager run, which
    the port follows)."""
    parser = argparse.ArgumentParser()
    ref_proc3d.add_args(parser)
    monkeypatch.setattr(sys, "argv", ["proc3d", *argv])
    args = ref_proc3d.check_args(parser.parse_args(argv), parser)
    eager = "new_apix" in args.helical_sym
    with jax.disable_jit() if eager else contextlib.nullcontext():
        ref_proc3d.main(args)


def _run_port(argv):
    """The port's command run as its own module's parser runs it: errors
    raise (the dispatcher turns them into exit code 1)."""
    parser = argparse.ArgumentParser()
    proc3d.add_args(parser)
    args = proc3d.check_args(parser.parse_args(argv), parser, argv)
    proc3d.main(args)


def _compare(src, opts, monkeypatch, tol=1e-5):
    _run_ref([src, "ref.mrc", *opts, "--verbose", "0"], monkeypatch)
    helicon.main(["proc3d", src, "port.mrc", *opts, "--verbose", "0", "--device", "cpu"])
    want, apix_want = read_mrc("ref.mrc")
    got, apix_got = read_mrc("port.mrc")
    assert got.shape == want.shape and apix_got == pytest.approx(apix_want)
    err = float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
    assert err < tol, err
    return got


OPTIONS = dict(
    apix=["--apix", "2.5"],
    clip=["--clip", "new_nx=20:new_ny=22:new_nz=18:center_x=14"],
    clip_pad=["--clip", "new_nx=30:new_ny=28:new_nz=32:center_z=10"],
    fft_resample_down=["--fft_resample", "new_nx=20:new_ny=20:new_nz=20"],
    fft_resample_up=["--fft_resample", "new_nx=30:new_ny=30:new_nz=30"],
    fft_resample_nonuniform=["--fft_resample", "new_nx=18:new_ny=21:new_nz=26"],
    flip_hand_x=["--flip_hand", "x"],
    flip_hand_y=["--flip_hand", "Y"],
    flip_hand_z=["--flip_hand", "z"],
    helical_sym_fraction=["--helical_sym", "twist=-1.2:rise=4.75:center_fraction=0.5"],
    helical_sym_len=["--helical_sym", "twist=30:rise=6:csym=2:center_len=12:new_apix=2"],
    helical_sym_n_rise=["--helical_sym",
                        "twist=-1.2:rise=4.75:center_n_rise=3:new_nz=20:new_nxy=18"],
    z_moving_average_length=["--z_moving_average", "length=4.75"],
    z_moving_average_n_pixel=["--z_moving_average", "n_pixel=4"],
    chain=["--fft_resample", "new_nx=20:new_ny=20:new_nz=20", "--helical_sym",
           "twist=-1.2:rise=4.75:center_fraction=0.5", "--flip_hand", "z", "--clip",
           "new_nx=16:new_ny=16:new_nz=16", "--z_moving_average", "length=4.75",
           "--apix", "2"],
    abbreviated=["--fft", "new_nx=20:new_ny=20:new_nz=20", "--z_mov", "n_pixel=3"],
    denoiseCurvelet_sigma=["--denoiseCurvelet", "sigma=3"],
    denoiseCurvelet_elbow=["--denoiseCurvelet", "threshold_sigma=0"],
    denoiseCurvelet_radial=["--denoiseCurvelet", "nDirs=0:numScales=3:transform=udct"],
    denoiseCurvelet_defaults=["--denoiseCurvelet", ""],
    denoiseCurvelet_chain=["--clip", "new_nx=20:new_ny=22:new_nz=18", "--denoiseCurvelet",
                           "sigma=2:n_dirs=3:n_scales=3", "--flip_hand", "z"],
)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_matches_reference(name, workdir, monkeypatch):
    _compare("in.mrc", OPTIONS[name], monkeypatch)


@pytest.mark.parametrize("name", ["fft_resample_down", "helical_sym_fraction", "chain"])
def test_option_matches_reference_odd_map(name, workdir, monkeypatch):
    _compare("odd.mrc", OPTIONS[name], monkeypatch)


ERRORS = dict(
    clip_zero=(["--clip", "new_nx=0"], "new_nx/new_ny/new_nz must be > 0"),
    fft_resample_zero=(["--fft_resample", "new_nz=0"], "new_nx/new_ny/new_nz must be > 0"),
    flip_hand_axis=(["--flip_hand", "w"], "invalid axis: w"),
    helical_sym_rise=(["--helical_sym", "twist=1:center_fraction=0.5"],
                      "rise (>0) must be specified"),
    helical_sym_csym=(["--helical_sym", "twist=1:rise=4.75:csym=0:center_fraction=0.5"],
                      "csym (>0) must be specified"),
    helical_sym_center=(["--helical_sym", "twist=1:rise=4.75"], "exactly one of"),
    helical_sym_center_len=(["--helical_sym", "twist=1:rise=4.75:center_len=3"],
                            "center_len must be > rise (= 4.75 A)"),
    z_moving_average_none=(["--z_moving_average", "length=0"],
                           "length (>0) or n_pixel (>0) must be specified"),
    z_moving_average_both=(["--z_moving_average", "length=4:n_pixel=2"],
                           "specify either length or n_pixel, not both"),
    z_moving_average_long=(["--z_moving_average", "n_pixel=40"],
                           "z_moving_average window of 40 pixels"),
    denoiseCurvelet_fdct=(["--denoiseCurvelet", "sigma=3:transform=fdct"],
                          "unknown transform 'fdct' for --denoiseCurvelet"),
)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_matches_reference(name, workdir, monkeypatch):
    opts, msg = ERRORS[name]
    with pytest.raises(Exception) as want:
        _run_ref(["in.mrc", "ref.mrc", *opts, "--verbose", "0"], monkeypatch)
    with pytest.raises(HeliconError) as got:
        _run_port(["in.mrc", "port.mrc", *opts, "--verbose", "0", "--device", "cpu"])
    assert msg in str(want.value)
    assert str(got.value) == str(want.value)
    assert type(want.value).__name__ == type(got.value).__name__


def test_existing_output_needs_force(workdir, monkeypatch):
    with pytest.raises(Exception) as want:
        _run_ref(["in.mrc", "odd.mrc", "--flip_hand", "x"], monkeypatch)
    with pytest.raises(HeliconError) as got:
        _run_port(["in.mrc", "odd.mrc", "--flip_hand", "x", "--device", "cpu"])
    assert str(got.value) == str(want.value)
    _run_port(["in.mrc", "--outputMapFile", "odd.mrc", "--force", "1", "--flip_hand", "x",
               "--device", "cpu", "--verbose", "0"])
    np.testing.assert_array_equal(read_mrc("odd.mrc")[0], read_mrc("in.mrc")[0][:, :, ::-1])


def test_default_output_name(workdir):
    helicon.main(["proc3d", "in.mrc", "--flip_hand", "z", "--device", "cpu", "--verbose", "0"])
    np.testing.assert_array_equal(read_mrc("in.proc3d.mrc")[0], read_mrc("in.mrc")[0][::-1])


def test_denoise_curvelet_raises(workdir, monkeypatch):
    """denoiseCurvelet's one error, transform=fdct (fdct is 2D-only): the
    reference's message, and exit code 1 with no output through the
    dispatcher."""
    opts = ["--denoiseCurvelet", "transform=fdct"]
    with pytest.raises(Exception) as want:
        _run_ref(["in.mrc", "ref.mrc", *opts], monkeypatch)
    with pytest.raises(HeliconError) as got:
        _run_port(["in.mrc", "port.mrc", *opts, "--device", "cpu"])
    assert str(got.value) == str(want.value) and "Use 'udct' or 'mct'" in str(got.value)
    with pytest.raises(SystemExit) as e:
        helicon.main(["proc3d", "in.mrc", "port.mrc", *opts, "--device", "cpu"])
    assert e.value.code == 1 and not (workdir / "port.mrc").exists()


def test_device_cuda_without_a_card_raises(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HeliconError, match="no CUDA device"):
        _run_port(["in.mrc", "port.mrc", "--flip_hand", "x"])
    with pytest.raises(SystemExit) as e:
        helicon.main(["proc3d", "in.mrc", "port.mrc", "--flip_hand", "x"])
    assert e.value.code == 1 and not (workdir / "port.mrc").exists()


def test_option_plan_matches_reference(monkeypatch):
    """The plan: the options in command-line order, abbreviations resolved,
    the command's own flags (--device too) left out."""
    argv_ref = ["in.mrc", "out.mrc", "--fft", "new_nx=8", "--verbose", "0", "--flip_hand", "x",
                "--cpu", "2", "--z_mov", "n_pixel=2", "--outputMapFile", "o.mrc"]
    argv = [*argv_ref, "--device", "cpu"]
    ref_parser = argparse.ArgumentParser()
    ref_proc3d.add_args(ref_parser)
    monkeypatch.setattr(sys, "argv", ["proc3d", *argv_ref])
    want = ref_proc3d.check_args(ref_parser.parse_args(argv_ref), ref_parser)
    parser = argparse.ArgumentParser()
    proc3d.add_args(parser)
    got = proc3d.check_args(parser.parse_args(argv), parser, argv)
    assert got.all_options == want.all_options == ["fft_resample", "flip_hand",
                                                   "z_moving_average"]
    assert sorted(ops_proc3d._plugins) == sorted(ref_ops._plugins)


PARAMS = ["twist=-1.2:rise=4.75:csym=2", "name:a=true:b=False:c=3:d=2.5:e=\"q\":f=x",
          "a=1:junk:b=2", "", "x=1e-3:y=-4"]


@pytest.mark.parametrize("param", PARAMS)
def test_system_copy_matches_reference(param):
    assert system.parse_param_str(param) == ref_system.parse_param_str(param)
    _, d = system.parse_param_str(param)
    ref_d = dict(twist=0.0, rise=0.0, csym=1, a=0, c=1.0, e="", y=0)
    assert system.validate_param_dict(d, ref_d) == ref_system.validate_param_dict(d, ref_d)
    argv = ["sub", "in.mrc", "--clip", param, "--fft=3", "-v", "--z_mov", "2"]
    assert system.get_option_list(argv) == ref_system.get_option_list(argv)
    known = ["clip", "fft_resample", "flip_hand", "z_moving_average", "apix"]
    opts = ["clip", "fft", "f", "z_mov", "zz", "ap"]
    assert (system.resolve_option_abbreviations(opts, known)
            == ref_system.resolve_option_abbreviations(opts, known))
    for v in ("true", "FALSE", "7", "-2.5e3", '"s"', "word", '""'):
        assert system._coerce_value(v) == ref_system._coerce_value(v)


def test_registry_copy_matches_reference():
    def handle(data, args, index_d, param):
        return data + param, index_d

    for mod in (registry, ref_registry):
        p = mod.plugin("opt", lambda parser: parser.add_argument("--opt"))(handle)
        assert p == mod.Plugin("opt", p.add_args, handle)
        assert mod.dispatch({"opt": p}, "opt", 1, None, {}, 2) == (3, {})
        with pytest.raises(ValueError, match="Unknown option: nope"):
            mod.dispatch({"opt": p}, "nope", 1, None, {}, 2)
        parser = argparse.ArgumentParser()
        mod.add_plugin_args({"opt": p, "alias": p}, parser)
        assert parser.parse_args(["--opt", "v"]).opt == "v"
    found = registry.discover_plugins("helicon_tpu_torch.ops.proc3d", ops_proc3d.__path__)
    want = ref_registry.discover_plugins("helicon_tpu.ops.proc3d", ref_ops.__path__)
    assert list(found) == list(want)
    parsers = []
    for add in (ops_proc3d.add_plugin_args, ref_ops.add_plugin_args):
        parser = argparse.ArgumentParser()
        add(parser)
        parsers.append(sorted((a.dest, a.default, a.metavar) for a in parser._actions))
    assert parsers[0] == parsers[1]
