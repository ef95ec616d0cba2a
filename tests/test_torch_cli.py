"""The port's batch CLI (helicon_tpu_torch/commands/denovo3d_cli.py) with
``--device cpu`` against the JAX package's (helicon_tpu/commands/
denovo3d_cli.py), both called in process on the same .mrcs stack (the
small helix of tests/_mh_worker.py twice), a 12-candidate grid, linear
interpolation, few solver iterations; the JAX CLI's searches on one device,
as the other parity tests run them.

Each command runs once per module in each package, in its own directory
(where helicon.log lands). The JAX CLI runs the plain command eagerly
(jax.disable_jit()): jitted, XLA's fused multiply-adds move this grid's
scores by up to 3.5e-3 (samples at the volume's edges and half-way ties,
ROADMAP C6), linear interpolation too, where the eager reference and the
port agree to 6e-5. Held against it: the ranked .csv (the same order,
scores within 1e-4), the .json, the .best.mrc (relative 1e-4, the same
apix), and the checkpoint's scores. The other commands run the JAX CLI
jitted and hold what those moves leave alone: the refined pose within
5e-3 (the engine's bounds), the summaries' candidate, and the file names;
and a resume that recomputes nothing, and the 1-based index error.
"""

import argparse
import contextlib
import functools
import json
import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from _mh_worker import tiny_workload
from helicon_tpu.commands import denovo3d_cli as ref_cli
from helicon_tpu.io.mrc import read_mrc
from helicon_tpu_torch.commands import denovo3d_cli as port_cli
from helicon_tpu_torch.io.mrc import write_mrc

# --horizontalize 0: the two packages' Nelder-Mead searches stop apart
# within their xtol, which moves the best volume by 1.8e-4 relative
# (tests/test_torch_grid.py's horizontalize case holds the prep)
BASE = ("stack.mrcs out --twist 25 33 4 --rise 4.25 5.15 0.3 --targetApix2d 4 "
        "--tubeDiameter 110 --cgIters 4 --fistaIters 4 --interpolation linear "
        "--horizontalize 0 --verbose 0")
COMMANDS = dict(
    base="",
    refine="--refineTiltPsiDy 4 2 1",
    batch="--imageIndex 0",
    checkpoint="--checkpoint 5",
)
CLIS = dict(ref=(ref_cli, ""), port=(port_cli, " --device cpu"))


@contextlib.contextmanager
def _one_device(mp):
    """The JAX CLI's searches on one device (tests/conftest.py fakes 8)."""
    import helicon_tpu.denovo3d as d

    for name in ("reconstruct_grid", "reconstruct_grid_checkpointed"):
        mp.setattr(d, name, functools.partial(getattr(d, name), devices=jax.devices()[:1]))
    yield


def _args(cli, line):
    return cli.add_args(argparse.ArgumentParser()).parse_args(line.split())


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Two images at 2 A/px: the helix twice."""
    image = np.asarray(tiny_workload()[0], np.float32).reshape(64, 128)
    path = tmp_path_factory.mktemp("stack") / "stack.mrcs"
    write_mrc(path, np.stack([image, image]), apix=2.0)
    return path


@pytest.fixture(scope="module")
def runs(stack, tmp_path_factory):
    """{command: {package: its output directory}}, each command run once in
    each package, on demand."""
    done = {}
    native = tmp_path_factory.mktemp("native")

    def get(name):
        if name not in done:
            done[name] = {}
            for pkg, (cli, extra) in CLIS.items():
                d = tmp_path_factory.mktemp(f"{name}_{pkg}")
                (d / "stack.mrcs").symlink_to(stack)
                with pytest.MonkeyPatch.context() as mp:
                    mp.chdir(d)
                    mp.setenv("HELICON_NATIVE_CACHE", str(native))
                    eager = pkg == "ref" and name == "base"
                    with (_one_device(mp) if pkg == "ref" else contextlib.nullcontext()), (
                            jax.disable_jit() if eager else contextlib.nullcontext()):
                        cli.main(_args(cli, f"{BASE} {COMMANDS[name]}{extra}"))
                done[name][pkg] = d
        return done[name]

    return get


def _csv(path):
    rows = [line.split(",") for line in path.read_text().splitlines()[1:]]
    return [(r[0], r[1]) for r in rows], np.float64([r[2] for r in rows])


def _same_csv(port, ref):
    (order, s), (order_ref, s_ref) = _csv(port), _csv(ref)
    assert order == order_ref
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-4)


def _same_candidate(port, ref):
    assert set(port) == set(ref)
    for key in ("image_index", "best_twist", "best_rise", "n_candidates"):
        assert port[key] == ref[key], key


def _json(d, name):
    return json.loads((d / name).read_text())


def _same_volume(port, ref):
    (v, apix), (v_ref, apix_ref) = read_mrc(port), read_mrc(ref)
    assert v.shape == v_ref.shape and apix == apix_ref
    assert np.abs(v - v_ref).max() / np.abs(v_ref).max() < 1e-4


def test_outputs_match_reference(runs):
    d = runs("base")
    assert sorted(p.name for p in d["port"].iterdir()) == sorted(
        p.name for p in d["ref"].iterdir())
    _same_csv(d["port"] / "out.csv", d["ref"] / "out.csv")
    port, ref = _json(d["port"], "out.json"), _json(d["ref"], "out.json")
    _same_candidate(port, ref)
    assert abs(port["best_score"] - ref["best_score"]) <= 1e-4
    assert port["n_candidates"] == 12
    _same_volume(d["port"] / "out.best.mrc", d["ref"] / "out.best.mrc")
    # the command line audit lands in the working directory, one line a run
    assert len((d["port"] / "helicon.log").read_text().splitlines()) == 1


def test_refined_pose_matches_reference(runs):
    d = runs("refine")
    port, ref = _json(d["port"], "out.json"), _json(d["ref"], "out.json")
    _same_candidate(port, ref)
    pose = [port[k] for k in ("refined_tilt", "refined_psi", "refined_dy_pixel")]
    pose_ref = [ref[k] for k in ("refined_tilt", "refined_psi", "refined_dy_pixel")]
    np.testing.assert_allclose(pose, pose_ref, rtol=0, atol=5e-3)
    assert np.abs(pose).max() > 0.01  # the pose moved


def test_batch_mode_matches_reference(runs):
    """--imageIndex 0: every image of the stack, per-image outputs and the
    batch summary; the two images are the plain command's image, so each
    row is its summary."""
    d = runs("batch")
    assert sorted(p.name for p in d["port"].iterdir()) == sorted(
        p.name for p in d["ref"].iterdir())
    port, ref = _json(d["port"], "out.batch.json"), _json(d["ref"], "out.batch.json")
    assert [s["image_index"] for s in port] == [s["image_index"] for s in ref] == [1, 2]
    base = _json(runs("base")["ref"], "out.json")
    for p, r in zip(port, ref):
        _same_candidate(p, r)
        assert abs(p["best_score"] - base["best_score"]) <= 1e-4
        assert p == dict(_json(d["port"], f"out_{p['image_index']:03d}.json"))


def test_checkpoint_and_resume(runs, caplog, monkeypatch):
    """--checkpoint N writes <prefix>.ckpt.npz as the JAX CLI does, its
    scores the one-shot search's; the same command again resumes it and
    scores no candidate (the one call left is the winner's volume), with
    the same outputs."""
    from helicon_tpu_torch.denovo3d import grid

    d = runs("checkpoint")
    assert sorted(p.name for p in d["port"].iterdir()) == sorted(
        p.name for p in d["ref"].iterdir())
    port_ck, ref_ck = (np.load(d[k] / "out.ckpt.npz") for k in ("port", "ref"))
    assert sorted(port_ck.files) == sorted(ref_ck.files)
    np.testing.assert_array_equal(port_ck["twists"], ref_ck["twists"])
    np.testing.assert_array_equal(port_ck["rises"], ref_ck["rises"])
    base = runs("base")["ref"] / "out.csv"
    _same_csv(d["port"] / "out.csv", base)
    first = (d["port"] / "out.csv").read_text()
    calls = []
    inner = grid.reconstruct_grid

    def spy(image, apix, twists, rises, **kw):
        calls.append((len(twists), kw.get("return_best_volume")))
        return inner(image, apix, twists, rises, **kw)

    monkeypatch.setattr(grid, "reconstruct_grid", spy)
    monkeypatch.chdir(d["port"])
    with caplog.at_level(logging.INFO):
        port_cli.main(_args(port_cli, f"{BASE} {COMMANDS['checkpoint']} --device cpu "
                                      "--verbose 1"))
    assert calls == [(1, True)]
    assert (d["port"] / "out.csv").read_text() == first
    (line,) = [m for m in caplog.messages if m.startswith("effective: ")]
    eff = json.loads(line[len("effective: "):])
    assert eff["launches"]["group_solve"] == 0 and eff["wall_s"] > 0


@pytest.mark.parametrize("index", ["-1", "0 1", "2 -3"])
def test_one_based_index_error(stack, tmp_path, monkeypatch, index):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "stack.mrcs").symlink_to(stack)
    errors = []
    for cli, extra in CLIS.values():
        with pytest.raises(SystemExit) as e:
            cli.main(_args(cli, f"{BASE} --imageIndex {index}{extra}"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "1-based" in errors[0]


def test_flags_and_defaults_match_reference():
    """The reference's flags with its defaults, and --device (the card)."""
    argv = ["in.mrcs", "out"]
    port, ref = vars(_args(port_cli, " ".join(argv))), vars(_args(ref_cli, " ".join(argv)))
    assert port.pop("device") == "cuda"
    assert port == ref


def test_dispatcher_runs_the_subcommand(capsys):
    from helicon_tpu_torch.commands import helicon

    with pytest.raises(SystemExit) as e:
        helicon.main(["denovo3d_cli", "--help"])
    assert e.value.code == 0 and "--refineTiltPsiDy" in capsys.readouterr().out
