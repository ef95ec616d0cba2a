"""The port's copies of numpy-only host code against their originals:
helicon_tpu_torch/io/mrc.py against helicon_tpu.io.mrc in both directions
(each reads what the other writes: a float32 volume, a 2D stack, int16
mode, the header's apix and nz), and helicon_tpu_torch/utils/logging.py
against helicon_tpu.utils.logging.
"""

import dataclasses
import logging
import sys

import numpy as np
import pytest

from helicon_tpu.io import mrc as ref_mrc
from helicon_tpu.utils import logging as ref_logging
from helicon_tpu_torch.io import mrc
from helicon_tpu_torch.utils import logging as port_logging

PACKAGES = dict(port=mrc, ref=ref_mrc)


def _data(kind):
    rng = np.random.default_rng(3)
    if kind == "volume":
        return "map.mrc", rng.normal(size=(6, 10, 12)).astype(np.float32), 1.37
    if kind == "stack":
        return "stack.mrcs", rng.normal(size=(3, 16, 24)).astype(np.float32), 2.0
    return "int16.mrc", rng.integers(-300, 300, size=(4, 8, 8)).astype(np.int16), 0.9


@pytest.mark.parametrize("kind", ["volume", "stack", "int16"])
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_mrc_round_trip_across_packages(tmp_path, kind, writer, reader):
    name, data, apix = _data(kind)
    path = tmp_path / name
    PACKAGES[writer].write_mrc(path, data, apix=apix)
    r = PACKAGES[reader]
    h = r.mrc_header(path)
    assert (h.nz, h.ny, h.nx) == data.shape
    assert h.mode == (1 if kind == "int16" else 2)
    assert h.apix == pytest.approx(apix, rel=1e-6)
    for i in range(data.shape[0]):
        np.testing.assert_array_equal(r.read_image_2d(path, i), data[i].astype(np.float32))
    got, got_apix = ref_mrc.read_mrc(path)
    np.testing.assert_array_equal(got, data)
    assert got_apix == h.apix


@pytest.mark.parametrize("kind", ["volume", "stack", "int16"])
def test_mrc_files_and_headers_identical(tmp_path, kind):
    """The two writers write the same bytes, the two parsers read the same
    header fields, and an image past the stack raises."""
    name, data, apix = _data(kind)
    a, b = tmp_path / ("port_" + name), tmp_path / ("ref_" + name)
    mrc.write_mrc(a, data, apix=apix)
    ref_mrc.write_mrc(b, data, apix=apix)
    assert a.read_bytes() == b.read_bytes()
    assert dataclasses.asdict(mrc.mrc_header(a)) == dataclasses.asdict(ref_mrc.mrc_header(b))
    with pytest.raises(IndexError):
        mrc.read_image_2d(a, data.shape[0])


def test_mrc_2d_image_and_other_dtypes(tmp_path):
    """A 2D array is written as one section; a float64 array as float32."""
    img = np.arange(12, dtype=np.float64).reshape(3, 4)
    mrc.write_mrc(tmp_path / "a.mrc", img, apix=1.5)
    ref_mrc.write_mrc(tmp_path / "b.mrc", img, apix=1.5)
    assert (tmp_path / "a.mrc").read_bytes() == (tmp_path / "b.mrc").read_bytes()
    np.testing.assert_array_equal(mrc.read_image_2d(tmp_path / "b.mrc", 0), img)


@pytest.mark.parametrize("seconds", [0.04, 3.25, 61.0, 3725.5, 90061.0])
@pytest.mark.parametrize("verbose", [1, 2, 4])
def test_timedelta2string_matches_reference(seconds, verbose):
    assert (port_logging.timedelta2string(seconds, verbose)
            == ref_logging.timedelta2string(seconds, verbose))


def test_log_command_line_and_timer(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["denovo3d_cli", "in.mrcs", "out"])
    port_logging.log_command_line()
    ref_logging.log_command_line("ref.log")
    port_line, ref_line = ((tmp_path / f).read_text().split("\t") for f in ("helicon.log", "ref.log"))
    assert port_line[1:] == ref_line[1:] == [str(tmp_path), "denovo3d_cli in.mrcs out\n"]
    with caplog.at_level(logging.INFO, logger="helicon"):
        with port_logging.Timer("stage") as t:
            pass
    assert t.elapsed == t.interval >= 0 and t.end >= t.start
    assert caplog.messages == [f"stage: {port_logging.timedelta2string(t.elapsed)}"]
