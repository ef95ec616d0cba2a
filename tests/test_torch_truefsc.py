"""The trueFSC command of the PyTorch port (``helicon-torch trueFSC ...
--device cpu``, through commands/helicon.main) against the JAX package's
trueFSC command, both run whole in this process (the plot included) on two
half maps written to tmp_path, with numpy's global generator seeded the
same before each, so that both draw the same random phases: the five .txt
curves within 1e-4 absolute, the written masks equal inside and outside
(their cosine edges within 1e-6), the printed
resolution equal to two decimals. Five configurations: the defaults
(refineMask 1, oneMask 1), refineMask 0, oneMask 0, one user mask and two."""

import argparse
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.commands import trueFSC as ref_truefsc
from helicon_tpu.io.mrc import read_mrc, write_mrc
from helicon_tpu_torch.commands import helicon
from helicon_tpu_torch.commands import trueFSC
from helicon_tpu_torch.utils.exceptions import HeliconError

CURVES = ("unmasked", "randomized-unmasked", "masked", "randomized-masked", "true")


def _half_maps(n, seed):
    """Gaussian blobs on a helix (rise 4.75 A at 1.5 A/px), plus independent
    white noise in each half map: every curve crosses 0.143 inside the box."""
    g = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n) - n // 2,) * 3, indexing="ij")
    base = np.zeros((n, n, n))
    for k in range(-8, 9):
        zc, phi = k * 4.75 / 1.5, np.deg2rad(-25.0 * k)
        yc, xc = 5 * np.sin(phi), 5 * np.cos(phi)
        base += np.exp(-((z - zc) ** 2 + (y - yc) ** 2 + (x - xc) ** 2) / 3.0)
    halves = [base + 0.3 * g.normal(size=base.shape) for _ in range(2)]
    return [h.astype(np.float32) for h in halves]


CASES = dict(
    defaults=[],
    refine0=["--refineMask", "0"],
    onemask0=["--oneMask", "0"],
    user_mask=["--maskFile", "mask1.mrc"],
    user_masks=["--maskFile", "mask1.mrc", "mask2.mrc"],
)


N = 25  # one odd box for every configuration: the reference compiles once a shape


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("truefsc")
    h1, h2 = _half_maps(N, N)
    write_mrc(d / "h1.mrc", h1, apix=1.5)
    write_mrc(d / "h2.mrc", h2, apix=1.5)
    z, y, x = np.meshgrid(*(np.arange(N) - N // 2,) * 3, indexing="ij")
    r = np.sqrt(y**2 + x**2)
    write_mrc(d / "mask1.mrc", np.clip((10 - r) / 3, 0, 1).astype(np.float32), apix=1.5)
    write_mrc(d / "mask2.mrc", np.clip((11 - r) / 4, 0, 1).astype(np.float32), apix=1.5)
    return d


def _run_ref(argv, capsys):
    parser = argparse.ArgumentParser()
    ref_truefsc.add_args(parser)
    np.random.seed(1234)
    try:
        ref_truefsc.main(parser.parse_args(argv))
    finally:
        for h in list(ref_truefsc.logger.handlers):
            ref_truefsc.logger.removeHandler(h)
            h.close()
    return capsys.readouterr().out


def _run_port(argv, capsys):
    np.random.seed(1234)
    helicon.main(["trueFSC", *argv, "--device", "cpu"])
    return capsys.readouterr().out


def _resolution(stdout: str) -> str:
    line = [s for s in stdout.splitlines() if s.startswith("trueFSC resolution")]
    assert len(line) == 1, stdout
    return line[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_truefsc_matches_reference(case, maps, monkeypatch, capsys):
    d = maps
    monkeypatch.chdir(d)
    monkeypatch.setattr(sys, "argv", ["trueFSC"])
    opts = ["--verbose", "0", *CASES[case]]
    for who in ("ref", "port"):
        (d / who / case).mkdir(parents=True)
    want = _resolution(_run_ref(["h1.mrc", "h2.mrc", f"ref/{case}/fsc.png", *opts], capsys))
    got = _resolution(_run_port(["h1.mrc", "h2.mrc", f"port/{case}/fsc.png", *opts], capsys))
    assert got == want and "999.00" not in got
    for c in CURVES + ("true.fit",):
        a = np.loadtxt(d / "ref" / case / f"fsc.{c}.txt")
        b = np.loadtxt(d / "port" / case / f"fsc.{c}.txt")
        assert a.shape == b.shape, c
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=c)
    assert (d / "port" / case / "fsc.png").stat().st_size > 0
    log = (d / "port" / case / "fsc.log").read_text()
    assert log.count("Resolution at FSC=0.143") == 3
    masks = sorted(p.name for p in (d / "ref" / case).glob("*.mrc"))
    assert masks == sorted(p.name for p in (d / "port" / case).glob("*.mrc"))
    assert masks == ([] if case.startswith("user") else
                     ["h1.mask.mrc", "h2.mask.mrc"] if case == "onemask0" else
                     ["h1_h2.common_mask.mrc"])
    for m in masks:
        want_m, apix = read_mrc(d / "ref" / case / m)
        got_m, apix_got = read_mrc(d / "port" / case / m)
        assert apix_got == pytest.approx(apix)
        # inside and outside equal; the cosine edge to float32 rounding
        # (XLA's and torch's float32 cos differ by an ulp on some angles)
        np.testing.assert_array_equal(got_m == 1, want_m == 1)
        np.testing.assert_array_equal(got_m == 0, want_m == 0)
        np.testing.assert_allclose(got_m, want_m, atol=1e-6, rtol=0)


def test_truefsc_device_cuda_without_a_card_raises(maps, monkeypatch):
    monkeypatch.chdir(maps)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        helicon.main(["trueFSC", "h1.mrc", "h2.mrc", "nocard.png"])
    assert e.value.code == 1
    parser = argparse.ArgumentParser()
    trueFSC.add_args(parser)
    with pytest.raises(HeliconError, match="no CUDA device"):
        trueFSC.main(parser.parse_args(["h1.mrc", "h2.mrc", "nocard.png"]))
    assert not (maps / "nocard.unmasked.txt").exists()
