"""The port's HOM_containerC and symmetry_mismatch commands against the JAX
package's, on the inputs of tests/test_hom_symmismatch.py.

The slope grid of many helices at once must pick the reference's slope
index, with b and the SSE within 1e-12 relative and |err| within 1e-9;
HelicalSegmentConsistency's frames and stats agree to those tolerances
(the rounded error column equal); the commands write equal files. Under
one ``np.random.seed`` both packages take the same seeds, the same angle
and the same unfolded angles. The port runs here with ``device="cpu"``.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.commands import HOM_containerC as ref_hom
from helicon_tpu.commands import symmetry_mismatch as ref_sm
from helicon_tpu_torch.commands import HOM_containerC as hom
from helicon_tpu_torch.commands import symmetry_mismatch as sm

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_hom_symmismatch import _segments  # noqa: E402

P = 360.0


def _helix_set(n=50, seed=0):
    """Helices of 3-40 segments with a random slope and intercept, noise
    and 5 % of segments off by 20-90 degrees."""
    rng = np.random.default_rng(seed)
    xs, os_ = [], []
    for _ in range(n):
        k = int(rng.integers(3, 41))
        x = np.round(np.sort(rng.uniform(0, 2000, k)), 2)
        o = (rng.uniform(-1, 1) / 4.75 * x + rng.uniform(0, 360) + rng.normal(0, 2, k)) % P
        off = rng.random(k) < 0.05
        o[off] = (o[off] + rng.uniform(20, 90, off.sum())) % P
        xs.append(x)
        os_.append(o)
    return xs, os_


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("seed,csym", [(0, 1), (1, 2), (2, 6)])
def test_slope_grid_batch_matches_reference(seed, csym, monkeypatch):
    Pc = P / csym
    xs, os_ = _helix_set(seed=seed)
    os_ = [o % Pc for o in os_]
    lo, hi = -5 / 4.75, 5 / 4.75
    # chunks of a few helices, padded to their longest
    monkeypatch.setattr(hom, "GRID_CHUNK_BYTES_CPU", 501 * 8 * 8 * 40 * 6)
    idx, m, b, s, err = hom.fit_line_wrapped_by_m_grid_batch(xs, os_, Pc, lo, hi, device="cpu")
    for h in range(len(xs)):
        mr, br, sr, (mg, bg, sg) = ref_hom.fit_line_wrapped_by_m_grid(xs[h], os_[h], Pc, lo, hi)
        assert idx[h] == int(np.argmin(sg)) and m[h] == mr
        assert _rel(b[h], br) <= 1e-12 and _rel(s[h], sr) <= 1e-12
        _, ae = ref_hom.get_angular_errors(xs[h], os_[h], mr, br, Pc)
        np.testing.assert_allclose(err[h], ae, rtol=0, atol=1e-9)


def test_one_helix_grid_matches_reference():
    x = np.arange(12, dtype=float)
    y = (5.0 + 1.7 * x) % 180.0
    want = ref_hom.fit_line_wrapped_by_m_grid(x, y, 180.0, 0.0, 5.0)
    got = hom.fit_line_wrapped_by_m_grid(x, y, 180.0, 0.0, 5.0, device="cpu")
    assert got[0] == want[0] and _rel(got[1], want[1]) <= 1e-12
    assert abs(got[2] - want[2]) <= 1e-12 * max(want[2], 1.0)
    np.testing.assert_array_equal(got[3][0], want[3][0])
    np.testing.assert_allclose(got[3][1], want[3][1], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[3][2], want[3][2], rtol=1e-12, atol=1e-12)


def test_host_copies_match_reference():
    rng = np.random.default_rng(0)
    v = rng.normal(0, 50, 40)
    np.testing.assert_array_equal(hom.wrap_sym(v, 180.0), ref_hom.wrap_sym(v, 180.0))
    np.testing.assert_array_equal(hom.unwrap_sequence(v, 180.0),
                                  ref_hom.unwrap_sequence(v, 180.0))
    x = np.arange(20) * 47.5
    for k in (3, 4, 11, 50):
        a, b = hom.l1_core_average(v, k), ref_hom.l1_core_average(v, k)
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
    for m_true in (0.04, -0.04):
        o = (m_true * x + 33.0 + rng.normal(0, 1, x.size)) % 360
        for fixed in (False, True):
            assert (hom.fit_line_wrapped_by_m_known(x, o, 360.0, 0.04, fixed=fixed)
                    == ref_hom.fit_line_wrapped_by_m_known(x, o, 360.0, 0.04, fixed=fixed))
        assert (hom.solve_b_given_m_wrapped(x, o, 360.0, m_true)
                == ref_hom.solve_b_given_m_wrapped(x, o, 360.0, m_true))
    errs = np.abs(rng.normal(0, 5, 300))
    a, b = hom.fit_error_distribution(errs, 360.0), ref_hom.fit_error_distribution(errs, 360.0)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(hom.G_model(x, 1.0, 5.0, 360.0),
                                  ref_hom.G_model(x, 1.0, 5.0, 360.0))


def _assert_frames_close(got, want):
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_index_equal(got.index, want.index)
    for c in want.columns:
        if c in ("rlnHelicalTubeAndMicIDGood", "rlnHelicalTubeAndMicIDGoodSegValue"):
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(), rtol=0, atol=1e-9)
            assert got[c].dtype == want[c].dtype
        else:
            pd.testing.assert_series_equal(got[c], want[c])


def _assert_stats_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "median_sse":
            assert _rel(got[k], v) <= 1e-12
        elif isinstance(v, float) and k.startswith("error_fit"):
            assert got[k] == pytest.approx(v, rel=1e-9, abs=1e-12)
        else:
            assert got[k] == v, k


CASES = dict(
    noisy=(dict(n_tubes=3, n_seg=8, noise=0.5), {}),
    outliers=(dict(n_tubes=6, n_seg=12, noise=0.2, outliers=7, seed=1), {}),
    error_fit=(dict(n_tubes=8, n_seg=24, noise=3.0, seed=1), {}),
    refit=(dict(n_tubes=4, n_seg=12, twist=2.0, noise=0.3, outliers=3), dict(
        refit_known_slope=True)),
    refit_fixed=(dict(n_tubes=5, n_seg=15, twist=-1.2, noise=1.0, outliers=4, seed=4), dict(
        refit_known_slope=True, fixed_intercept=True)),
    csym2=(dict(n_tubes=4, n_seg=10, noise=0.5, seed=5), dict(csym=2, rise=4.75,
                                                                twist_range=(-3.0, 4.0))),
    param=(dict(n_tubes=3, n_seg=9, noise=0.5, seed=6), dict(
        param="csym=3:rise=2.4:twist_min=-4:twist_max=4:max_error_deg=10")),
)


@pytest.mark.parametrize("name", sorted(CASES))
def test_consistency_frames_and_stats_match_reference(name):
    seg_kw, kw = CASES[name]
    df = _segments(**seg_kw)
    want, wstats = ref_hom.HelicalSegmentConsistency(df, **kw)
    got, gstats = hom.HelicalSegmentConsistency(df, device="cpu", **kw)
    _assert_frames_close(got, want)
    _assert_stats_close(gstats, wstats)


def test_consistency_short_and_tube_only_groups():
    df = _segments(n_tubes=2, n_seg=12, noise=0.1, seed=3)
    short = pd.DataFrame(dict(
        rlnImageName=["900001@s.mrcs", "900002@s.mrcs"], rlnMicrographName=["mShort.mrc"] * 2,
        rlnHelicalTubeID=[9, 9], rlnHelicalTrackLengthAngst=[0.0, 47.5],
        rlnAngleRot=[10.0, 250.0]))
    both = pd.concat([df, short], ignore_index=True)
    want, ws = ref_hom.HelicalSegmentConsistency(both)
    got, gs = hom.HelicalSegmentConsistency(both, device="cpu")
    _assert_frames_close(got, want)
    _assert_stats_close(gs, ws)
    rng = np.random.default_rng(0)
    tube = pd.DataFrame({"rlnHelicalTubeID": [1] * 12 + [2] * 12,
                         "rlnAngleRot": rng.uniform(0, 360, 24),
                         "rlnHelicalTrackLengthAngst": np.tile(np.arange(12) * 50.0, 2)})
    want, ws = ref_hom.HelicalSegmentConsistency(tube)
    got, gs = hom.HelicalSegmentConsistency(tube, device="cpu")
    _assert_frames_close(got, want)
    for mod in (ref_hom, hom):
        with pytest.raises(ValueError):
            mod.HelicalSegmentConsistency(_segments().head(0))


def test_report_pages_match_reference(tmp_path):
    df = _segments(n_tubes=6, n_seg=10, noise=1.0)
    _, ws = ref_hom.HelicalSegmentConsistency(df, report_prefix=str(tmp_path / "ref"))
    _, gs = hom.HelicalSegmentConsistency(df, report_prefix=str(tmp_path / "port"),
                                          device="cpu")
    assert len(gs["report_pages"]) == len(ws["report_pages"])
    assert Path(gs["report_pdf"]).stat().st_size > 1000
    with pytest.raises(ValueError):
        hom.jpgs_to_pdf([], "out.pdf")


def _run_hom(mod, tmp_path, sub, extra):
    from helicon_tpu.io.metadata import dataframe2star

    d = tmp_path / sub
    d.mkdir()
    df = _segments(n_tubes=5, n_seg=12, noise=0.2, outliers=4, seed=2)
    for f in df["rlnImageName"].str.split("@").str[-1].unique():
        (d / f).touch()
    dataframe2star(df, d / "in.star")
    parser = argparse.ArgumentParser()
    mod.add_args(parser)
    args = parser.parse_args([str(d / "in.star"), str(d / "out.star"), "--verbose", "0"]
                             + extra)
    mod.main(mod.check_args(args, parser))
    return (d / "out.star").read_text()


@pytest.mark.parametrize("extra", [["--filterBad", "1"],
                                   ["--refitKnownSlope", "1", "--csym", "2"]])
def test_main_writes_equal_star(tmp_path, monkeypatch, extra):
    monkeypatch.chdir(tmp_path)
    want = _run_hom(ref_hom, tmp_path, "ref", extra)
    got = _run_hom(hom, tmp_path, "port", extra + ["--device", "cpu"])
    assert got.replace("/port/", "/ref/") == want


def test_hom_args_match_reference(tmp_path):
    out = tmp_path / "out.star"
    out.write_text("")
    for mod in (ref_hom, hom):
        parser = argparse.ArgumentParser()
        mod.add_args(parser)
        args = parser.parse_args([str(tmp_path / "in.star"), str(out)])
        with pytest.raises(FileExistsError):
            mod.check_args(args, parser)
        args = parser.parse_args([str(tmp_path / "in.star"), str(out), "--force", "1"])
        mod.check_args(args, parser)
    parser = argparse.ArgumentParser()
    hom.add_args(parser)
    assert parser.parse_args(["a", "b"]).device == "cuda"


def _planted(sym1, sym2, n, seed):
    rng = np.random.default_rng(seed)
    planted = rng.uniform(0, ref_sm.relative_angle_range(sym1, sym2))
    true = rng.uniform(0, 360, n)
    rot1 = (true + rng.integers(0, sym1, n) * 360 / sym1 + rng.normal(0, 1, n)) % (360 / sym1)
    rot2 = (true + planted + rng.integers(0, sym2, n) * 360 / sym2
            + rng.normal(0, 1, n)) % (360 / sym2)
    return planted, rot1, rot2


@pytest.mark.parametrize("sym1,sym2,n,seeds", [(5, 12, 1500, 10), (3, 4, 400, 10),
                                               (6, 1, 40, 10), (5, 12, 30, 50)])
def test_solve_symmetry_mismatch_matches_reference(sym1, sym2, n, seeds, monkeypatch):
    planted, rot1, rot2 = _planted(sym1, sym2, n, seed=sym1 + sym2)
    np.random.seed(11)
    want = ref_sm.solve_symmetry_mismatch(rot1, rot2, sym1, sym2, num_seed_samples=seeds)
    monkeypatch.setattr(sm, "SEED_CHUNK_BYTES_CPU", n * sym1 * sym2 * 8 * 3 * 7)
    np.random.seed(11)
    got = sm.solve_symmetry_mismatch(rot1, rot2, sym1, sym2, num_seed_samples=seeds,
                                     device="cpu", return_seeds=True)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if n > 100:
        assert abs(got[0] - planted) < 1.0
    # the seeds' errors against the reference's own sum, seed by seed
    seeds_v, errs, best = got[3]
    cands = np.fmod((rot2[:, None, None] + np.arange(sym2)[None, None, :] * 360 / sym2)
                    - (rot1[:, None, None] + np.arange(sym1)[None, :, None] * 360 / sym1)
                    + 360.0, 360.0).reshape(n, -1)
    for cand, err in zip(seeds_v[:20], errs[:20]):
        assert _rel(err, np.sum(np.min(ref_sm.angular_distance(cands, cand), axis=1))) <= 1e-12


def test_symmetry_mismatch_helpers_match_reference():
    assert sm.relative_angle_range(6, 1) == ref_sm.relative_angle_range(6, 1)
    assert sm.relative_angle_range(5, 12) == ref_sm.relative_angle_range(5, 12)
    assert sm.angular_distance(350.0, 10.0) == ref_sm.angular_distance(350.0, 10.0)
    e = np.random.default_rng(0).uniform(-180, 180, (6, 3))
    np.testing.assert_array_equal(sm.convert_euler_angles_to_cryosparc_pose(e),
                                  ref_sm.convert_euler_angles_to_cryosparc_pose(e))
    p = sm.convert_euler_angles_to_cryosparc_pose(e)
    np.testing.assert_array_equal(sm.convert_cryosparc_pose_to_scipy_Rotation(p).as_quat(),
                                  ref_sm.convert_cryosparc_pose_to_scipy_Rotation(p).as_quat())


def _datasets(n=60, shared_uids=True, seed=0):
    rng = np.random.default_rng(seed)
    e1 = np.stack([rng.uniform(0, 360, n), rng.uniform(5, 175, n),
                   rng.uniform(0, 360, n)], axis=1)
    e2 = e1.copy()
    e2[:, 0] = (e1[:, 0] + 17.0 + rng.integers(0, 12, n) * 30.0) % 360
    common = dict(
        **{"location/micrograph_uid": np.repeat(np.arange(n // 10) + 7, 10).astype(np.uint64),
           "location/center_x_frac": rng.uniform(0, 1, n),
           "location/center_y_frac": rng.uniform(0, 1, n),
           "location/micrograph_psize_A": np.full(n, 1.1),
           "location/micrograph_shape": np.tile([4096, 4096], (n, 1))})
    d1 = dict(uid=np.arange(n, dtype=np.uint64) + 1000, **common)
    d2 = dict(uid=(np.arange(n, dtype=np.uint64) + (1000 if shared_uids else 5000)),
              **{k: v.copy() for k, v in common.items()})
    d1["alignments3D/pose"] = ref_sm.convert_euler_angles_to_cryosparc_pose(e1)
    d2["alignments3D/pose"] = ref_sm.convert_euler_angles_to_cryosparc_pose(e2)
    return d1, d2


@pytest.mark.parametrize("shared,dist_tol,axis_tol", [(True, 20.0, 10.0), (True, 20.0, None),
                                                      (False, 5.0, 0), (False, 5.0, 10.0)])
def test_find_particle_correspondence_matches_reference(shared, dist_tol, axis_tol):
    d1, d2 = _datasets(shared_uids=shared)
    want = ref_sm.find_particle_correspondence(d1, d2, dist_tol=dist_tol, axis_tol=axis_tol)
    got = sm.find_particle_correspondence(d1, d2, dist_tol=dist_tol, axis_tol=axis_tol)
    np.testing.assert_array_equal(got, want)


def _write_cs(path, d):
    from helicon_tpu.io.cs import write_cs

    n = len(d["uid"])
    arr = np.zeros(n, dtype=[("uid", "<u8"), ("location/micrograph_uid", "<u8"),
                             ("location/center_x_frac", "<f4"),
                             ("location/center_y_frac", "<f4"),
                             ("alignments3D/pose", "<f4", (3,))])
    for k in arr.dtype.names:
        arr[k] = d[k]
    write_cs(path, arr)


def test_symmetry_mismatch_main_writes_equal_cs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    d1, d2 = _datasets(n=80)
    _write_cs(tmp_path / "J1_particles.cs", d1)
    _write_cs(tmp_path / "J2_particles.cs", d2)
    outs = {}
    for name, mod, extra in (("ref", ref_sm, []), ("port", sm, ["--device", "cpu"])):
        parser = argparse.ArgumentParser()
        mod.add_args(parser)
        args = parser.parse_args(["-i1", "J1_particles.cs", "-s1", "C1", "-i2",
                                  "J2_particles.cs", "-s2", "C12", "-of2", f"{name}2.cs",
                                  "-of1", f"{name}1.cs", "-v", "0"] + extra)
        np.random.seed(5)
        mod.main(mod.check_args(args, parser))
        outs[name] = [(tmp_path / f"{name}{i}.cs").read_bytes() for i in (1, 2)]
    assert outs["port"] == outs["ref"]


@pytest.mark.parametrize("argv", [[], ["--input1", "a.cs", "--input2", "b.cs", "--sym2", "c1"],
                                  ["--input1", "a.cs", "--sym1", "c6", "--input2", "b.cs",
                                   "--sym2", "c1", "-of2", "out.xyz"],
                                  ["--input1", "a.cs", "--sym1", "c6", "--input2", "b.cs",
                                   "--sym2", "c1", "--dist-tol", "-1"],
                                  ["--input1", "a.cs", "--sym1", "c6", "--input2", "b.cs",
                                   "--sym2", "c1", "--axis-tol", "0"],
                                  ["--input1", "a.cs", "--sym1", "c6", "--input2", "b.cs",
                                   "--sym2", "c1", "-of2", "out.cs"]])
def test_symmetry_mismatch_args_match_reference(argv):
    results = []
    for mod in (ref_sm, sm):
        parser = argparse.ArgumentParser()
        mod.add_args(parser)
        args = parser.parse_args(argv)
        try:
            mod.check_args(args, parser)
            results.append("ok")
        except SystemExit as e:
            results.append(e.code)
    assert results[0] == results[1]


def test_symmetry_mismatch_missing_passthrough_raises(tmp_path):
    from helicon_tpu.io.cs import write_cs
    from helicon_tpu_torch.utils.exceptions import HeliconError

    arr = np.zeros(2, dtype=[("uid", "<u8"), ("blob/path", "S20")])
    write_cs(tmp_path / "J9_particles.cs", arr)
    with pytest.raises(HeliconError, match="does not exist"):
        sm._load(str(tmp_path / "J9_particles.cs"), pass_through=str(tmp_path / "typo.cs"))
