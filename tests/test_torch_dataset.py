"""The port's io/dataset.py (EMDB access) and core/analysis.is_amyloid
against the JAX package's, with the network mocked as tests/test_io_aux.py
does: entries, curated table, amyloid atlas and downloads are faked.
"""

import gzip

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)

import helicon_tpu.io.dataset as ref_ds
import helicon_tpu_torch.io.dataset as port_ds
from helicon_tpu.core import analysis as ref_analysis
from helicon_tpu.io.mrc import write_mrc
from helicon_tpu_torch.core import analysis as port_analysis

ENTRIES = pd.DataFrame(dict(
    emdb_id=["EMD-101", "EMD-102", "EMD-1234"], title=["a", "b", "c"],
    method=["helical", "singleParticle", "helical"], resolution=[3.0, 4.0, 2.5],
    pdb=["1abc", "", "2xyz"], rise=[4.75, None, 4.8], twist=[-1.2, None, 179.4],
    csym=["C1", None, "C2"]))
ENTRIES["emd_id"] = ENTRIES["emdb_id"].str.split("-").str[-1]


@pytest.fixture()
def mocked(tmp_path, monkeypatch):
    """Both packages' EMDB layers on faked entries and downloads (a 4^3
    map of apix 1.1, gzipped); the singletons reset around the test."""

    def fake_download(url, target_file_name=None, return_filename=False, **k):
        raw = tmp_path / "tmp.map"
        write_mrc(raw, np.arange(64, dtype=np.float32).reshape(4, 4, 4), apix=1.1)
        with open(raw, "rb") as f_in, gzip.open(target_file_name, "wb") as f_out:
            f_out.write(f_in.read())
        return target_file_name if return_filename else None

    for ds in (ref_ds, port_ds):
        monkeypatch.setattr(ds, "get_emd_entries", lambda fields: ENTRIES.copy())
        monkeypatch.setattr(ds, "update_helical_parameters_from_curated_table", lambda df: df)
        monkeypatch.setattr(ds, "get_amyloid_atlas", lambda *a, **k: pd.DataFrame(
            {"emd_id": ["EMD-1234", "EMD-9999", "EMD-101"]}))
        ds.EMDB._instance = None
    monkeypatch.setattr(ref_ds, "download_file_from_url", fake_download)
    # the port's downloads go through utils.path_utils' module attribute
    monkeypatch.setattr(port_ds.path_utils, "download_file_from_url", fake_download)
    yield
    for ds in (ref_ds, port_ds):
        ds.EMDB._instance = None


def test_emdb_matches_reference(tmp_path, mocked):
    a = ref_ds.EMDB(cache_dir=tmp_path / "ref")
    b = port_ds.EMDB(cache_dir=tmp_path / "port")
    assert b is port_ds.EMDB(cache_dir=tmp_path / "other")
    assert len(a) == len(b) == 3 and a.emd_ids == b.emd_ids
    assert a.helical_structure_ids() == b.helical_structure_ids()
    assert a.amyloid_atlas_ids() == b.amyloid_atlas_ids() == ["1234", "101"]
    pd.testing.assert_series_equal(a.get_info("EMD-101"), b.get_info("EMD-101"))
    assert b.get_info("555") is None
    for emd in ("EMD-101", "emd_1234", 102):
        (da, pa), (db, pb) = a(emd), b(emd)
        np.testing.assert_array_equal(da, db)
        assert pa == pb
    assert a.get_emdb_map_url("101") == b.get_emdb_map_url("101")
    assert a.get_emdb_xml_url("EMD-101") == b.get_emdb_xml_url("EMD-101")
    with pytest.raises(AssertionError):
        b._validate_emd_id("EMD-x1")


def test_is_amyloid_matches_reference(mocked, monkeypatch, tmp_path):
    monkeypatch.setenv("HELICON_CACHE_DIR", str(tmp_path / "cache"))
    for emd in ("EMD-1234", "emd_101", "EMD-102", 1234, None):
        assert port_analysis.is_amyloid(emd) == ref_analysis.is_amyloid(emd)


def test_entries_fail_to_an_empty_list(tmp_path, monkeypatch):
    def no_network(fields):
        raise OSError("no network")

    for ds in (ref_ds, port_ds):
        monkeypatch.setattr(ds, "get_emd_entries", no_network)
        ds.EMDB._instance = None
    try:
        a = ref_ds.EMDB(cache_dir=tmp_path / "ref")
        b = port_ds.EMDB(cache_dir=tmp_path / "port")
        assert a.emd_ids == b.emd_ids == [] and a.meta is b.meta is None
        assert b.get_info("101") is None
    finally:
        for ds in (ref_ds, port_ds):
            ds.EMDB._instance = None


def test_download_failure_raises(tmp_path, mocked, monkeypatch):
    monkeypatch.setattr(port_ds.path_utils, "download_file_from_url",
                        lambda *a, **k: None)
    b = port_ds.EMDB(cache_dir=tmp_path / "port")
    with pytest.raises(port_ds.HeliconIOError):
        b.get_emdb_map_file("102")


def test_curated_table_overlay_matches_reference(monkeypatch):
    curated = pd.DataFrame({"emdb_id": ["EMD-101", "EMD-777"],
                            "twist_validated (°)": [-1.23456, 5.0],
                            "rise_validated (Å)": [4.7512, 1.0],
                            "csym_validated": ["C2", "C1"]})
    out = {}
    for name, ds in (("ref", ref_ds), ("port", port_ds)):
        monkeypatch.setattr(ds.pd, "read_csv", lambda url: curated.copy())
        out[name] = ds.update_helical_parameters_from_curated_table(
            ENTRIES.drop(columns="emd_id"), url="x")
    pd.testing.assert_frame_equal(out["port"], out["ref"])


def test_emdb_map_axis_order_normalized(tmp_path, monkeypatch):
    import struct

    vol = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    f = tmp_path / "emd_999.map"
    write_mrc(f, vol, apix=1.0)
    raw = bytearray(f.read_bytes())
    raw[64:76] = struct.pack("<3i", 2, 1, 3)
    f.write_bytes(bytes(raw))
    got = []
    for ds in (ref_ds, port_ds):
        emdb = ds.EMDB.__new__(ds.EMDB)
        monkeypatch.setattr(emdb, "get_emdb_map_file", lambda emd_id: str(f))
        monkeypatch.setattr(emdb, "_validate_emd_id", lambda emd_id: emd_id)
        got.append(ds.EMDB.read_emdb_map(emdb, "999"))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    assert got[0][1] == got[1][1] and got[1][0].shape == (2, 4, 3)
