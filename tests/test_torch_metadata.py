"""The port's host copies under images2star (io/star.py, io/cs.py,
io/csdat.py, io/epu.py, io/groups.py, io/metadata.py, the rest of io/mrc.py,
utils/collections.py, utils/path_utils.py, utils/system.py's seams and the
tube metadata functions of core/analysis.py) against the JAX package's
originals, on the inputs of tests/test_io.py, tests/test_io_aux.py and
tests/test_utils.py.

Each case calls the original and the copy on deep copies of the same
arguments and requires equal results: numpy arrays equal in dtype and value,
frames equal under ``assert_frame_equal`` (exact) with equal ``.attrs``,
the arguments a function changes in place equal afterwards, and an error of
the same class name with the same message. Files written by the two (STAR,
CS, CSDAT, CSV, MRC) must be equal byte for byte once the directory they were
written to is written the same.
"""

import copy
import importlib
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.io.mrc import write_mrc

PAIRS = {
    "io.star": ("helicon_tpu.io.star", "helicon_tpu_torch.io.star"),
    "io.cs": ("helicon_tpu.io.cs", "helicon_tpu_torch.io.cs"),
    "io.csdat": ("helicon_tpu.io.csdat", "helicon_tpu_torch.io.csdat"),
    "io.epu": ("helicon_tpu.io.epu", "helicon_tpu_torch.io.epu"),
    "io.groups": ("helicon_tpu.io.groups", "helicon_tpu_torch.io.groups"),
    "io.metadata": ("helicon_tpu.io.metadata", "helicon_tpu_torch.io.metadata"),
    "io.mrc": ("helicon_tpu.io.mrc", "helicon_tpu_torch.io.mrc"),
    "utils.collections": ("helicon_tpu.utils.collections", "helicon_tpu_torch.utils.collections"),
    "utils.path_utils": ("helicon_tpu.utils.path_utils", "helicon_tpu_torch.utils.path_utils"),
    "utils.system": ("helicon_tpu.utils.system", "helicon_tpu_torch.utils.system"),
    "core.analysis": ("helicon_tpu.core.analysis", "helicon_tpu_torch.core.analysis"),
}
MODS = {k: tuple(importlib.import_module(m) for m in v) for k, v in PAIRS.items()}

EPU_NAME = "FoilHole_28788144_Data_28764755_46_20240328_192116_fractions.tiff"
EPU_OLD_NAME = "FoilHole_1464933_Data_427288_427290_20250502_213110_Fractions.mrc"
BEAMSHIFT_XML = """<?xml version="1.0"?>
<MicroscopeImage xmlns:a="http://schemas.datacontract.org/2004/07/Fei.Types">
  <microscopeData><optics><BeamShift>
    <a:_x>0.012</a:_x><a:_y>-0.034</a:_y>
  </BeamShift></optics></microscopeData>
</MicroscopeImage>"""


def _relion_df():
    rows = []
    pid = 1
    for mic in ["mic1.mrc", "mic2.mrc"]:
        for tube in [1, 2]:
            for seg in range(4):
                rows.append(dict(
                    rlnImageName=f"{pid:06d}@stack_{mic}s", rlnMicrographName=mic,
                    rlnHelicalTubeID=tube, rlnCoordinateX=100.0 + 47.5 * seg + 300 * tube,
                    rlnCoordinateY=200.0 + 3.0 * seg * tube,
                    rlnHelicalTrackLengthAngst=47.5 * seg, rlnAnglePsi=5.0 * seg,
                    rlnDefocusU=12000.0, rlnDefocusV=11000.0, rlnDefocusAngle=30.0))
                pid += 1
    df = pd.DataFrame(rows)
    df.attrs["convention"] = "relion"
    return df


def _make_cs_array(n=4):
    dt = np.dtype([("uid", "<u8"), ("blob/idx", "<u4"), ("blob/path", "S30"),
                   ("blob/psize_A", "<f4"), ("ctf/accel_kv", "<f4"), ("ctf/cs_mm", "<f4"),
                   ("ctf/amp_contrast", "<f4"), ("ctf/df1_A", "<f4"), ("ctf/df2_A", "<f4"),
                   ("ctf/df_angle_rad", "<f4")])
    arr = np.zeros(n, dt)
    arr["uid"] = np.arange(n) + 1000
    arr["blob/idx"] = np.arange(n)
    arr["blob/path"] = b"J1/extract/stack.mrcs"
    arr["blob/psize_A"] = 1.3
    arr["ctf/accel_kv"] = 300
    arr["ctf/cs_mm"] = 2.7
    arr["ctf/amp_contrast"] = 0.1
    arr["ctf/df1_A"] = 12000 + np.arange(n)
    arr["ctf/df2_A"] = 11000 + np.arange(n)
    arr["ctf/df_angle_rad"] = 0.5
    return arr


def _deepcopy(x):
    if isinstance(x, pd.DataFrame):
        y = x.copy(deep=True)
        y.attrs = {k: _deepcopy(v) for k, v in x.attrs.items()}
        return y
    return copy.deepcopy(x)


def _assert_same(a, b, where="result"):
    assert type(a).__name__ == type(b).__name__, (where, type(a), type(b))
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
        assert set(a.attrs) == set(b.attrs), where
        for k in a.attrs:
            _assert_same(a.attrs[k], b.attrs[k], f"{where}.attrs[{k}]")
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b, check_exact=True)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    elif type(a).__name__ == "Match":
        assert (a.span(), a.groups()) == (b.span(), b.groups()), where
    else:
        assert a == b, (where, a, b)


def _call_both(key, name, *args, **kwargs):
    """(ref result or exception, port result or exception, ref args, port
    args) after one call of each on its own deep copy of the arguments."""
    outs = []
    for mod in MODS[key]:
        a, kw = _deepcopy(list(args)), _deepcopy(kwargs)
        try:
            r = getattr(mod, name)(*a, **kw)
        except Exception as e:  # noqa: BLE001 (the error is the result)
            r = ("raised", type(e).__name__, str(e))
        outs.append((r, a))
    return outs


def _same(key, name, *args, **kwargs):
    (r, ra), (p, pa) = _call_both(key, name, *args, **kwargs)
    _assert_same(r, p)
    _assert_same(ra, pa, "arguments after the call")
    return r


# ---------------------------------------------------------------------------
# every public name of the originals has its copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [k for k in PAIRS if k not in ("utils.system", "core.analysis")])
def test_copy_has_every_public_name(key):
    ref, port = MODS[key]
    names = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items()
        if not n.startswith("_") and callable(v) and getattr(v, "__module__", "") == ref.__name__]
    missing = [n for n in names if not hasattr(port, n)]
    assert missing == []


# ---------------------------------------------------------------------------
# STAR
# ---------------------------------------------------------------------------

STAR_TEXTS = {
    "optics": """
data_optics

loop_
_rlnOpticsGroup #1
_rlnVoltage #2
_rlnImagePixelSize #3
1 300.0 1.2

data_particles

loop_
_rlnImageName #1
_rlnOpticsGroup #2
000001@s.mrcs 1
000002@s.mrcs 1
""",
    "key_value": "data_general\n\n_rlnImageSize 128\n_rlnFinalResolution 3.5\n_rlnName abc\n",
    "inf_value": "data_x\n_rlnValue inf\n_rlnOther nan\n",
    "quoted": "data_\nloop_\n_rlnImageName\n_rlnComment\n1@a.mrcs 'two words'\n2@a.mrcs \"x y\"\n",
    "two_loops": "data_a\nloop_\n_rlnX\n1\n2\nloop_\n_rlnY\n3.5\n",
    "empty_loop": "data_a\nloop_\n_rlnX\n_rlnY\n",
    "big_int": "data_\nloop_\n_uid\n_rlnX\n18446744073709551615 1\n9007199254740993 2\n",
    "malformed": "data_\nloop_\n_rlnA\n_rlnB\n1 2\n3\n",
    "comments": "# c\ndata_\n\nloop_ \n_rlnA #1\n# row comment\n 1.5\n\n2.5\n",
}


@pytest.mark.parametrize("name", list(STAR_TEXTS))
def test_read_star_matches(name, tmp_path):
    (tmp_path / "f.star").write_text(STAR_TEXTS[name])
    _same("io.star", "read_star", tmp_path / "f.star")


def _frames():
    g = np.random.default_rng(0)
    df = _relion_df()
    big = pd.DataFrame({
        "rlnImageName": [f"{i:06d}@Extract/job012/mic{i % 7}.mrcs" for i in range(1, 2001)],
        "rlnCoordinateX": g.uniform(0, 4096, 2000), "rlnClassNumber": g.integers(1, 50, 2000),
        "rlnHuge": g.uniform(-1, 1, 2000) * 1e16, "rlnNan": np.where(g.random(2000) < .1, np.nan, 1.0),
        "uid": np.arange(2000, dtype=np.uint64) + np.uint64(2**63 + 5)})
    return {"relion": df, "big": big,
            "blocks": {"optics": pd.DataFrame({"rlnOpticsGroup": [1, 2], "rlnVoltage": [300.0, 200.0]}),
                       "general": {"rlnImageSize": 64, "rlnPixel": 1.05}, "particles": df},
            "empty_columns": pd.DataFrame({"a": []}), "no_columns": pd.DataFrame()}


@pytest.mark.parametrize("name", list(_frames()))
def test_write_star_byte_identical(name, tmp_path):
    blocks = _frames()[name]
    for key, mod in zip("rp", MODS["io.star"]):
        mod.write_star(tmp_path / f"{key}.star", _deepcopy(blocks))
    assert (tmp_path / "r.star").read_bytes() == (tmp_path / "p.star").read_bytes()
    _same("io.star", "read_star", tmp_path / "r.star")


# ---------------------------------------------------------------------------
# CS and CSDAT
# ---------------------------------------------------------------------------


def test_cs_roundtrip_matches(tmp_path):
    arr = _make_cs_array()
    for key, mod in zip("rp", MODS["io.cs"]):
        mod.write_cs(tmp_path / f"{key}.cs", arr)
    assert (tmp_path / "r.cs").read_bytes() == (tmp_path / "p.cs").read_bytes()
    _same("io.cs", "read_cs", tmp_path / "r.cs")
    _same("io.cs", "write_cs", tmp_path / "x.cs", np.arange(3))  # not structured: raises


@pytest.mark.parametrize("content", [b"not numpy at all", "npz"])
def test_read_cs_errors_match(content, tmp_path):
    path = tmp_path / "bad.cs"
    if content == "npz":
        np.savez(tmp_path / "z.npz", a=np.arange(3))
        (tmp_path / "z.npz").rename(path)
    else:
        path.write_bytes(content)
    r = _same("io.cs", "read_cs", path)
    assert r[0] == "raised"


def test_csdat_matches(tmp_path):
    arr = _make_cs_array(50)
    for key, mod in zip("rp", MODS["io.csdat"]):
        mod.write_csdat(tmp_path / f"{key}.cs", arr)
    assert (tmp_path / "r.cs").read_bytes() == (tmp_path / "p.cs").read_bytes()
    _same("io.csdat", "read_csdat", tmp_path / "r.cs")
    _same("io.cs", "read_cs", tmp_path / "r.cs")
    payload = bytes(range(256)) * 8 + b"abc" * 300
    _same("io.csdat", "lz4_block_compress", payload)
    _same("io.csdat", "lz4_block_decompress", MODS["io.csdat"][0].lz4_block_compress(payload),
          len(payload))
    _same("io.csdat", "lz4_block_decompress", b"\xff\xff", 10)


def test_find_passthrough_file_matches(tmp_path):
    for f in ("J9_particles.cs", "J9_passthrough_particles.cs", "J3_passthrough_exposures.cs"):
        (tmp_path / f).write_bytes(b"")
    _same("io.cs", "find_passthrough_file", tmp_path / "J9_particles.cs")
    _same("io.cs", "find_passthrough_file", tmp_path / "J4_particles.cs")


# ---------------------------------------------------------------------------
# images2dataframe / dataframe2file on STAR, CS and MRCS inputs
# ---------------------------------------------------------------------------


def _inputs(tmp_path):
    g = np.random.default_rng(1)
    write_mrc(tmp_path / "stack.mrcs", g.normal(size=(6, 16, 16)).astype(np.float32), apix=1.3)
    MODS["io.cs"][0].write_cs(tmp_path / "particles_sel.cs", _make_cs_array())
    (tmp_path / "optics.star").write_text(STAR_TEXTS["optics"])
    df = _relion_df()
    df["rlnVoltage"] = 300.0
    df["rlnImagePixelSize"] = 1.1
    MODS["io.metadata"][0].dataframe2star(df, str(tmp_path / "v3.star"), format="v3")
    return {"star": "optics.star", "star_v3": "v3.star", "cs": "particles_sel.cs",
            "mrcs": "stack.mrcs", "two": ["v3.star", "optics.star"]}


@pytest.mark.parametrize("kind", ["star", "star_v3", "cs", "mrcs", "two"])
@pytest.mark.parametrize("convention", [None, "relion"])
def test_images2dataframe_matches(kind, convention, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    f = _inputs(tmp_path)[kind]
    df = _same("io.metadata", "images2dataframe", f, ignore_bad_particle_path=2,
               target_convention=convention)
    for suffix in (".star", ".cs", ".csv"):
        if isinstance(df, tuple) or (suffix == ".cs" and df.attrs.get("convention") != "cryosparc"
                                     and kind != "cs"):
            continue
        for key, mod in zip("rp", MODS["io.metadata"]):
            try:
                mod.dataframe2file(_deepcopy(df), str(tmp_path / f"out_{key}{suffix}"))
            except Exception as e:  # noqa: BLE001
                (tmp_path / f"out_{key}{suffix}").write_text(f"{type(e).__name__}: {e}")
        assert (tmp_path / f"out_r{suffix}").read_bytes() == (tmp_path / f"out_p{suffix}").read_bytes()


def test_star2dataframe_and_dataframe2star_matches(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _inputs(tmp_path)
    _same("io.metadata", "star2dataframe", tmp_path / "optics.star", ignore_bad_particle_path=2)
    df = _relion_df()
    df["rlnVoltage"] = 300.0
    df["rlnImagePixelSize"] = 1.1
    for fmt in ("v3", "v2"):
        for key, mod in zip("rp", MODS["io.metadata"]):
            mod.dataframe2star(_deepcopy(df), str(tmp_path / f"{fmt}_{key}.star"), format=fmt)
        assert (tmp_path / f"{fmt}_r.star").read_bytes() == (tmp_path / f"{fmt}_p.star").read_bytes()
    _same("io.metadata", "star_to_dataframe", str(tmp_path / "v3_r.star"))


def test_cistem_matches(tmp_path):
    import sqlite3

    db = tmp_path / "p.db"
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE REFINEMENT_RESULT_1_1 (POSITION_IN_STACK INTEGER, PSI REAL, "
                "THETA REAL, PHI REAL, XSHIFT REAL, YSHIFT REAL, DEFOCUS1 REAL, DEFOCUS2 REAL, "
                "DEFOCUS_ANGLE REAL, PHASE_SHIFT REAL, SCORE REAL)")
    con.executemany("INSERT INTO REFINEMENT_RESULT_1_1 VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                    [(i + 1, 10.0 * i, 90.0, 5.0, 1.5, -2.0, 12000.0, 11000.0, 30.0, 0.1, 0.5)
                     for i in range(4)])
    con.commit()
    con.close()
    _same("io.metadata", "cistem2dataframe", str(db))


# ---------------------------------------------------------------------------
# metadata helpers
# ---------------------------------------------------------------------------


def _optics_df():
    df = _relion_df()
    df["rlnVoltage"] = 300.0
    df["rlnImagePixelSize"] = 1.5
    return df


@pytest.mark.parametrize("name,args,kwargs", [
    ("_electron_wavelength", (300,), {}),
    ("_electron_wavelength", (200,), {}),
    ("clean_cs_micrograph_path",
     ("J5/motioncorrected/123456789012345_mic_patch_aligned_doseweighted.mrc",), {}),
    ("clean_cs_micrograph_path", ("plain.mrc",), {}),
    ("getPixelSize", ("optics",), {}),
    ("getPixelSize", ("optics",), {"return_pixelSize_source": True}),
    ("setPixelSize", ("optics", 2.0), {"update_defocus": True}),
    ("star_build_opticsgroup", ("optics",), {}),
    ("dataframe_relion_to_cryosparc", ("optics",), {}),
    ("dataframe_convert", ("optics",), {"target": "cryosparc"}),
    ("get_dataframe_convention", ("optics",), {}),
    ("reorder_dataframe_columns", ("optics",), {}),
    ("dataframe_guess_data_type", ("optics",), {}),
    ("relion_astigmatism_to_eman", (12000.0, 11000.0, 30.0), {}),
    ("eman_astigmatism_to_relion", (1.2, 0.1, 30.0), {}),
    ("guess_data_type", ("1.5",), {}),
    ("guess_data_type", ("abc",), {}),
    ("pixelSizeAttrForImageAttr", ("rlnMicrographName",), {}),
    ("preferred_relion_star_column_order", (), {}),
    ("get_relion_project_folder", ("/nonexistent/Refine3D/job001/run_data.star",), {}),
])
def test_metadata_helpers_match(name, args, kwargs):
    args = tuple(_optics_df() if a == "optics" else a for a in args)
    _same("io.metadata", name, *args, **kwargs)


def test_optics_roundtrip_and_conversion_match():
    df = _optics_df()
    r, p = (_deepcopy(df) for _ in range(2))
    MODS["io.metadata"][0].star_build_opticsgroup(r)
    MODS["io.metadata"][1].star_build_opticsgroup(p)
    _assert_same(r, p)
    _same("io.metadata", "star_dissolve_opticsgroup", r)
    cs = MODS["io.metadata"][0].dataframe_relion_to_cryosparc(_deepcopy(df))
    _same("io.metadata", "dataframe_cryosparc_to_relion", cs)


def test_get_relion_project_folder_matches(tmp_path):
    proj = tmp_path / "proj"
    (proj / "Refine3D" / "job001").mkdir(parents=True)
    (proj / "default_pipeline.star").write_text("data_\n")
    _same("io.metadata", "get_relion_project_folder", str(proj / "Refine3D/job001/run_data.star"))


def test_mrc2mrcs_and_normalize_filename_match(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_mrc(tmp_path / "m.mrc", np.zeros((2, 8, 8), np.float32), apix=1.0)
    df = pd.DataFrame({"rlnImageName": [f"00000{i}@{tmp_path}/m.mrc" for i in (1, 2)]})
    _same("io.metadata", "mrc2mrcs", df)
    _same("io.metadata", "dataframe_normalize_filename", df, "rlnImageName")


def test_assign_beamshifts_to_cluster_matches():
    g = np.random.default_rng(0)
    xy = np.concatenate([g.normal(0, 0.001, (6, 2)), g.normal(0.05, 0.001, (6, 2))])
    pytest.importorskip("sklearn")
    ref_md, port_md = MODS["io.metadata"]
    _assert_same(ref_md.assign_beamshifts_to_cluster(xy.copy(), 2),
                 port_md.assign_beamshifts_to_cluster(xy.copy(), 2, device="cpu"))


def test_connect_cryosparc_without_package_matches(monkeypatch):
    monkeypatch.setitem(sys.modules, "cryosparc", None)
    monkeypatch.setitem(sys.modules, "cryosparc.tools", None)
    r = _same("io.metadata", "connect_cryosparc")
    assert r[0] == "raised"


def test_sklearn_absent_raises_like_reference(monkeypatch):
    """Without scikit-learn the reference raises; the port's clustering
    needs none and runs (on the CPU here), with the same labels the
    reference gives where scikit-learn is present."""
    xy = np.array([[0.0, 0.0], [0.001, 0.0], [1.0, 1.0], [1.0, 1.001]])
    want = MODS["io.metadata"][0].assign_beamshifts_to_cluster(xy, 2)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    monkeypatch.setitem(sys.modules, "sklearn.metrics", None)
    with pytest.raises(ImportError):
        MODS["io.metadata"][0].assign_beamshifts_to_cluster(xy, 2)
    got = MODS["io.metadata"][1].assign_beamshifts_to_cluster(xy, 2, device="cpu")
    _assert_same(want, got)


# ---------------------------------------------------------------------------
# EPU and groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args,kwargs", [
    ("guess_data_collection_software", (EPU_NAME,), {}),
    ("guess_data_collection_software", (EPU_OLD_NAME,), {}),
    ("guess_data_collection_software", ("random_name.mrc",), {}),
    ("extract_beamshift", (EPU_NAME,), {}),
    ("extract_data_collection_time", (EPU_NAME,), {}),
    ("extract_data_collection_time", (EPU_OLD_NAME,), {}),
    ("movie_filename_patterns", (), {}),
    ("verify_data_collection_software", (EPU_NAME, "EPU"), {}),
    ("assign_beamshift_groups",
     ([f"FoilHole_28788144_Data_28764755_{bs}_20240328_192116_fractions.tiff"
       for bs in (3, 7, 3, 12)],), {"software": "EPU"}),
    ("assign_beamshift_groups", (["nonconforming.tiff"],), {"software": "EPU"}),
])
def test_epu_matches(name, args, kwargs):
    _same("io.epu", name, *args, **kwargs)


def test_epu_xml_matches(tmp_path):
    (tmp_path / "FoilHole_1.xml").write_text(BEAMSHIFT_XML)
    _same("io.epu", "EPU_xml_2_beamshift", tmp_path / "FoilHole_1.xml")
    _same("io.epu", "check_foilhole_xml_files", [EPU_NAME], str(tmp_path))


MICS = [f"FoilHole_28788144_Data_28764755_{i}_20240328_1921{i:02d}_fractions.tiff"
        for i in range(6)]


@pytest.mark.parametrize("name,args,kwargs", [
    ("combine_groups", ([1, 1, 1, 1, 2, 2, 2, 2], [1, 1, 2, 2, 1, 1, 2, 2]), {}),
    ("combine_groups", ([10, 10, 20, 20], [1, 2, 1, 2]), {}),
    ("combine_groups", (np.array([], int), np.array([], int)), {}),
    ("per_micrograph_ids", (np.array(["z", "y", "x", "z", "y", "w"]),), {"start_id": 5}),
    ("per_micrograph_mapping", (["c.mrc", "a.mrc", "b.mrc"],), {}),
    ("extract_timestamps", ([EPU_NAME, MICS[1]], "EPU"), {}),
    ("extract_timestamps", (["250123_SF0431_00592_1-14_patch_aligned_doseweighted.mrc"],
                            "serialEM_embl_heidelberg"), {}),
    ("extract_timestamps", (["unknown_file.mrc"], "nonexistent"), {}),
    ("assign_time_groups", (np.repeat(MICS, 2), np.array([1]), np.ones(12, int)),
     {"time_group_size": 3}),
])
def test_groups_match(name, args, kwargs):
    _same("io.groups", name, *args, **kwargs)


def test_group_columns_match():
    df = pd.DataFrame({"exp_group_id": [1, 1, 2, 2], "mic/exp_group_id": [0, 0, 0, 0],
                       "ctf/exp_group_id": [9, 9, 9, 9], "other": [5, 6, 7, 8],
                       "ctf/df1_A": [1.0, 2.0, 3.0, 5.0], "ctf/cs_mm": [2.7, 2.7, 2.6, 2.8]})
    _same("io.groups", "sync_group_columns", df, "exp_group_id")
    _same("io.groups", "propagate_ctf_median", df, "exp_group_id")


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args,kwargs", [
    ("unique", ([3, 1, 3, 2, 1],), {}),
    ("flatten", ([1, [2, (3, 4)], [[5]]],), {}),
    ("split_array", ([5, 3, 2, 2, 1],), {}),
    ("assign_to_groups", ([1, 2, 3, 4, 5, 6, 7], 3), {}),
    ("order_by_unique_counts", ([3, 3, 1, -1, 2, 2, 2],), {}),
    ("unique_attr_name", ("relion", "rlnImageName"), {}),
    ("first_matched_attr", ("relion", ["x", "rlnMicrographName", "rlnImageName"]), {}),
    ("all_matched_attrs", ("relion", "rlnDefocus"), {}),
])
def test_collections_match(name, args, kwargs):
    args = tuple(_relion_df() if a == "relion" else a for a in args)
    _same("utils.collections", name, *args, **kwargs)


def test_dotdict_matches():
    d = [mod.DotDict(a=1, b=dict(c=2)) for mod in MODS["utils.collections"]]
    assert dict(d[0]) == dict(d[1]) and d[0].a == d[1].a == 1


@pytest.mark.parametrize("to", ["abs", "real", "relative", "current", "shortest"])
def test_convert_dataframe_file_path_matches(to, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "sub").mkdir()
    df = pd.DataFrame({"rlnImageName": ["000001@sub/a.mrcs", "000002@../b.mrcs", f"3@{tmp_path}/c"],
                       "rlnMicrographName": ["sub/m.mrc", "m2.mrc", "/abs/m3.mrc"]})
    for attr in ("rlnImageName", "rlnMicrographName"):
        _same("utils.path_utils", "convert_dataframe_file_path", df, attr, to=to,
              relpath_start=str(tmp_path / "sub"))


@pytest.mark.parametrize("name,args,kwargs", [
    ("get_direct_url", ("https://drive.google.com/file/d/abc123/view?usp=sharing",), {}),
    ("get_direct_url", ("https://www.dropbox.com/s/x/file.mrc?dl=0",), {}),
    ("get_direct_url", ("https://1drv.ms/u/s!abc",), {}),
    ("get_emdb_id", ("emd_12345.map",), {}),
    ("get_emdb_id", ("EMD-0001",), {}),
    ("get_emdb_id", ("nothing",), {}),
    ("which", ("python3",), {}),
    ("which", ("surely-not-a-program",), {}),
    ("check_required_columns", ("relion", ["rlnImageName"]), {}),
    ("check_required_columns", ("relion", ["rlnMissing"]), {}),
])
def test_path_utils_match(name, args, kwargs):
    args = tuple(_relion_df() if a == "relion" else a for a in args)
    _same("utils.path_utils", name, *args, **kwargs)


def test_file_checks_match(tmp_path):
    (tmp_path / "f.txt").write_text("x" * 10)
    for name, args in (("file_ready", ([str(tmp_path / "f.txt")],)),
                       ("file_ready", ([str(tmp_path / "none")],)),
                       ("is_file_readable", (tmp_path / "f.txt",)),
                       ("is_file_writable", (tmp_path / "new.txt",)),
                       ("find_relion_project_folders", (str(tmp_path),))):
        _same("utils.path_utils", name, *args)


@pytest.mark.parametrize("n", [-1, 0, 0.5, 1, 7, 10, 11, 999, 1000, 1001])
def test_ceil_power_of_10_matches(n):
    _same("utils.system", "ceil_power_of_10", n)


def test_compat_seams_never_return_the_jax_namespace(monkeypatch):
    """The port's seams are its own module attributes: a patch of
    io.metadata.image2dataframe intercepts images2dataframe, and the same
    name patched on the JAX package's compatibility layer is never seen."""
    import helicon  # the JAX package's compatibility layer
    from helicon_tpu_torch.io import metadata

    frame = pd.DataFrame({"rlnImageName": ["000001@a.mrcs"]})

    def refuse(*args, **kw):
        raise AssertionError("the JAX package's namespace reached the port")

    monkeypatch.setattr(helicon, "image2dataframe", refuse, raising=False)
    monkeypatch.setattr(metadata, "image2dataframe", lambda f, *args: frame.assign(src=f))
    out = metadata.images2dataframe(["x.star", "y.star"])
    assert list(out["src"]) == ["x.star", "y.star"]
    assert metadata.images2dataframe("z.star")["src"].iloc[0] == "z.star"


# ---------------------------------------------------------------------------
# io/mrc.py's rest and the tube metadata functions
# ---------------------------------------------------------------------------


def test_mrc_rest_matches(tmp_path):
    data = np.random.default_rng(0).normal(size=(3, 8, 10)).astype(np.float32)
    for key, mod in zip("rp", MODS["io.mrc"]):
        mm = mod.create_mrc_memmap(tmp_path / f"{key}.mrcs", data.shape, np.float16, apix=1.7)
        mm[:] = data
        mm.flush()
        del mm
    assert (tmp_path / "r.mrcs").read_bytes() == (tmp_path / "p.mrcs").read_bytes()
    for mmap in (False, True):
        (r, ra), (p, pa) = (mod.read_mrc(tmp_path / "r.mrcs", mmap=mmap) for mod in MODS["io.mrc"])
        assert ra == pa and type(r) is type(p)
        np.testing.assert_array_equal(r, p)
    _same("io.mrc", "get_image_number", tmp_path / "r.mrcs")
    _same("io.mrc", "get_image_size", tmp_path / "r.mrcs")
    _same("io.mrc", "change_map_axes_order", data, "xzy")
    for order in ((2, 1, 3), (3, 1, 2), (1, 2, 3)):
        hdrs = [mod.mrc_header(tmp_path / "r.mrcs") for mod in MODS["io.mrc"]]
        hdrs = [type(h)(**{**h.__dict__, "mapc": order[0], "mapr": order[1], "maps": order[2]})
                for h in hdrs]
        outs = [mod.change_map_axes_order(data, h, new_axes=["x", "y", "z"])
                for mod, h in zip(MODS["io.mrc"], hdrs)]
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        assert outs[0][1].__dict__ == outs[1][1].__dict__


def test_tube_metadata_matches():
    df = _relion_df()
    _same("core.analysis", "estimate_inter_segment_distance", df)
    _same("core.analysis", "estimate_helicalTube_length", df)
    no_track = df.drop(columns=["rlnHelicalTrackLengthAngst"])
    no_track["rlnImagePixelSize"] = 1.1
    _same("core.analysis", "estimate_helicalTube_length", no_track)
    for new in (30.0, 47.5, 60.0):
        _same("core.analysis", "reset_inter_segment_distance", df, new, 1.0)
