"""The images2star command of the PyTorch port (``python -m
helicon_tpu_torch.commands.helicon images2star ... --device cpu``) against
the JAX package's (``python -m helicon_tpu.commands.helicon images2star``
with HELICON_PLATFORM=cpu, as tests/test_cli.py runs it), both as
subprocesses on the same in.star: the STAR files they write must be equal
byte for byte, for the option chain of tests/test_cli.py's pipeline test
extended by the ETL options of bench.py and a createStack (the stack's
voxels within 1e-6 of each image's peak), and for a split chain like
tests/test_cli.py's split test, by micrograph. Without a card, the port's
default --device cuda exits 1 (in this process).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helicon_tpu.io.metadata import dataframe2file
from helicon_tpu.io.mrc import read_mrc, write_mrc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, HELICON_PLATFORM="cpu",
           PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p))


def _run(pkg, argv, cwd, device=("--device", "cpu")):
    extra = list(device) if pkg == "helicon_tpu_torch" else []
    return subprocess.run([sys.executable, "-m", f"{pkg}.commands.helicon", "images2star",
                           *argv, *extra], capture_output=True, text=True, env=ENV, cwd=cwd,
                          timeout=600)


def _input(tmp_path, relion_df, with_stack=False):
    df = relion_df.copy()
    df.attrs["convention"] = "relion"
    df["rlnClassNumber"] = np.arange(len(df)) % 3 + 1
    names = df["rlnImageName"].str.split("@").str[-1].unique()
    g = np.random.default_rng(0)
    for f in names:
        if with_stack:
            write_mrc(tmp_path / f, g.normal(size=(16, 32, 32)).astype(np.float32), apix=1.2)
        else:
            (tmp_path / f).touch()
    dataframe2file(df, str(tmp_path / "in.star"))
    return df


def _both(tmp_path, argv, outputs):
    """Run both commands in tmp_path on its in.star (the reference first,
    its outputs then moved aside) and return each one's outputs' bytes."""
    got = []
    for pkg in ("helicon_tpu", "helicon_tpu_torch"):
        r = _run(pkg, argv, tmp_path)
        assert r.returncode == 0, (pkg, r.stderr[-3000:])
        got.append([(tmp_path / o).read_bytes() for o in outputs])
        for o in outputs:
            (tmp_path / o).rename(tmp_path / f"{pkg}.{o}")
    return got


def test_cli_chain_writes_identical_star(tmp_path, relion_df):
    """tests/test_cli.py's pipeline chain, bench.py's ETL options and a
    createStack: the same STAR file, and the stack within 1e-6 of each
    image's peak."""
    _input(tmp_path, relion_df, with_stack=True)
    argv = ["in.star", "out.star", "--select", "rlnHelicalTubeID", "1",
            "--addParm", "rlnDefocusU", "100", "--multParm", "rlnDefocusV", "1.5",
            "--sortby", "rlnMicrographName", "rlnHelicalTubeID",
            "--breakFilaments", "maxSegments=2", "--removeDuplicates", "rlnImageName",
            "--createStack", "particles.mrcs:rescale2size=16:float16=0", "--verbose", "0"]
    ref, port = _both(tmp_path, argv, ["out.star", "particles.mrcs"])
    assert ref[0] == port[0]
    a, apix_a = read_mrc(tmp_path / "helicon_tpu.particles.mrcs")
    b, apix_b = read_mrc(tmp_path / "helicon_tpu_torch.particles.mrcs")
    assert apix_a == apix_b and a.shape == b.shape == (8, 16, 16) and a.dtype == b.dtype
    for x, y in zip(a, b):
        assert np.abs(x - y).max() <= 1e-6 * np.abs(x).max()


def test_cli_split_writes_identical_star(tmp_path, relion_df):
    """tests/test_cli.py's split chain, by micrograph."""
    _input(tmp_path, relion_df)
    argv = ["in.star", "out.star", "--select", "rlnClassNumber", "1,2",
            "--splitNumSets", "2", "--splitMode", "micrograph", "--verbose", "0"]
    ref, port = _both(tmp_path, argv, ["out.subset-0.star", "out.subset-1.star"])
    assert ref == port


def test_cli_default_device_needs_a_card(tmp_path, relion_df, monkeypatch):
    from helicon_tpu_torch.commands import helicon

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _input(tmp_path, relion_df)
    with pytest.raises(SystemExit) as e:
        helicon.main(["images2star", "in.star", "out.star", "--verbose", "0"])
    assert e.value.code == 1
    assert not (tmp_path / "out.star").exists()
