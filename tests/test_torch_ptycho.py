"""4D-STEM ptychography in the PyTorch port against the JAX package: the
h5 loader on both layouts, the calibration helpers, the parallax defocus
estimate, the batched ePIE engine and reconstruct_ptychography, on the
reference's synthetic fixture at its smallest (tests/test_aux_modules.py:
a 12 x 12 scan, a 32^2 detector).

ePIE takes the phase of each exit wave's Fourier coefficients. With the
fixture's aperture-limited probe (a hard disk), the first batch's
coefficients outside the disk are rounding noise (~1e-9 of the peak), so
two FFT libraries take unrelated phases there and the objects differ by
tenths of a radian after a few epochs. So the engine and the whole call are held
on a vacuum probe with a 1 % floor (no zero in the probe's spectrum),
within the tolerance measured there; on the plain fixture the inputs of
the engine are held and the phase is held to the truth.
"""

import h5py
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: F401  (keeps the reference on the CPU, tests/conftest.py)

from helicon_tpu.core import ptycho as ref
from helicon_tpu_torch.core import ptycho as port
from test_aux_modules import _make_ptycho_fixture


def _h5(path, floor: float = 0.0):
    V, pad_gen = _make_ptycho_fixture(path)
    if floor:
        with h5py.File(path, "a") as h:
            v = np.asarray(h["vacuumProbe"])
            del h["vacuumProbe"]
            h.create_dataset("vacuumProbe", data=v + np.float32(floor) * v.max())
    return V, pad_gen


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    f = tmp_path_factory.mktemp("ptycho") / "scan4d.h5"
    return str(f), _h5(f)


@pytest.fixture(scope="module")
def floored(tmp_path_factory):
    f = tmp_path_factory.mktemp("ptycho") / "scan4d_floor.h5"
    _h5(f, floor=0.01)
    return str(f)


def test_h5_loader_reference_layout(tmp_path):
    f = tmp_path / "scan.h5"
    rng = np.random.default_rng(0)
    with h5py.File(f, "w") as h:
        d = h.create_dataset("data", data=rng.random((3, 4, 8, 8)))
        d.attrs["Acceleration voltage [kV]"] = 300.0
        d.attrs["Convergence semi-angle [mrad]"] = 5.0
        d.attrs["STEM step-size [A]"] = 20.0
        h.create_dataset("vacuumProbe", data=rng.random((8, 8)))
    got, want = port.load_h5_file(str(f)), ref.load_h5_file(str(f))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_h5_loader_generic_layout(tmp_path):
    f = tmp_path / "scan.h5"
    rng = np.random.default_rng(0)
    with h5py.File(f, "w") as h:
        h.attrs["semiconv_mrad"] = 4.0
        g = h.create_group("datacube")
        g.attrs["pixel_size"] = 0.7
        d = g.create_dataset("cube", data=rng.random((3, 4, 8, 8)))
        d.attrs["energy"] = 200.0
        d.attrs["pixel_size"] = 0.5
    got, want = port.load_h5_file(str(f)), ref.load_h5_file(str(f))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] is None and want[1] is None
    assert got[2:] == want[2:] == (200e3, 4.0, 0.5)


def test_h5_loader_errors(tmp_path):
    f = tmp_path / "bad.h5"
    with h5py.File(f, "w") as h:
        h.create_dataset("img", data=np.zeros((4, 4)))
    for path in (str(f), str(tmp_path / "scan.mrc")):
        with pytest.raises(ValueError) as want:
            ref.load_h5_file(path)
        with pytest.raises(ValueError) as got:
            port.load_h5_file(path)
        assert str(got.value) == str(want.value)


def test_calibration_helpers_match_reference(plain):
    data = ref.load_h5_file(plain[0])[0]
    for v in (200e3, 300e3):
        assert port.electron_wavelength_angstrom(v) == ref.electron_wavelength_angstrom(v)
    dp = np.asarray(data, np.float32).mean(axis=(0, 1))
    for thresh in (0.5, 0.3):
        assert port.get_probe_size(dp, thresh) == ref.get_probe_size(dp, thresh)
    args = ((32, 32), 8.0, (16.2, 15.9), 0.0197, 0.6, -600.0)
    vac = np.asarray(ref.load_h5_file(plain[0])[1])
    for vacuum in (None, vac):
        np.testing.assert_array_equal(port._build_probe(vacuum, *args),
                                      ref._build_probe(vacuum, *args))


def test_phase_cross_correlation_shift_matches_reference():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((24, 20))
    for s in ((3, -2), (0, 5), (-7, 0)):
        b = np.roll(a, s, axis=(0, 1)) + 0.05 * rng.standard_normal(a.shape)
        want = ref._phase_cross_correlation_shift(a, b)
        np.testing.assert_array_equal(port._phase_cross_correlation_shift(a, b), want)
        np.testing.assert_array_equal(want, -np.asarray(s, np.float64))


@pytest.mark.parametrize("center", [(16.0, 16.0), (16.03, 15.91), (15.8, 16.2)])
def test_parallax_defocus_matches_reference(plain, center):
    data, _, acc_v, semi, r_pix = ref.load_h5_file(plain[0])
    lam = ref.electron_wavelength_angstrom(acc_v)
    args = (lam, semi / 8.0, r_pix, 8.0, center)
    want = ref.estimate_defocus_parallax(np.asarray(data), *args)
    got = port.estimate_defocus_parallax(torch.as_tensor(np.asarray(data)), *args)
    assert got == pytest.approx(want, rel=1e-9)
    assert want == pytest.approx(-600.0, rel=0.4)


def _engine_inputs(seed=0, n=30, det=16, span=12):
    """Seeded amplitudes, positions and a complex random probe (no zero in
    its spectrum)."""
    rng = np.random.default_rng(seed)
    amps = (rng.random((n, det, det)) * 4).astype(np.float32)
    probe = ((rng.standard_normal((det, det)) + 1j * rng.standard_normal((det, det))) / det
             ).astype(np.complex64)
    pos = rng.integers(0, span, (n, 2)).astype(np.int32)
    return amps, probe, pos, (span + det, span + det)


@pytest.mark.parametrize("num_iter,batch,fix", [(1, 30, True), (3, 1, True), (2, 7, False)])
def test_epie_engine_matches_reference(num_iter, batch, fix):
    """Object and probe within 5e-5: measured 1.3e-5 at batch 1 over three
    epochs (90 nonlinear steps amplify float32 rounding), 7e-7 at two
    epochs of batch 7."""
    amps, probe, pos, shape = _engine_inputs()
    kw = dict(num_iter=num_iter, step_size=0.5, batch_size=batch, fix_probe_aperture=fix)
    o_want, p_want = ref._epie_reconstruct(amps, probe, pos, shape, **kw)
    o_got, p_got = port._epie_reconstruct(torch.from_numpy(amps), probe, pos, shape, **kw)
    assert np.abs(o_got.numpy() - o_want).max() <= 5e-5
    assert np.abs(p_got.numpy() - p_want).max() <= 5e-5


def test_overlap_sum_is_exact_and_order_free():
    """The fixed-point overlap sum: within one float32 rounding of the
    float64 sum, and the same bits in any order of the patches."""
    rng = np.random.default_rng(2)
    B, p, n_pix = 24, 8, 20 * 20
    upd = torch.from_numpy((rng.standard_normal((B, p, p)) + 1j * rng.standard_normal((B, p, p)))
                           .astype(np.complex64) * 1e-3)
    flat = torch.from_numpy(rng.integers(0, n_pix, (B, p, p)))
    got = port._overlap_sum(upd, flat, n_pix)
    exact = torch.zeros(n_pix, dtype=torch.complex128)
    exact.index_add_(0, flat.reshape(-1), upd.reshape(-1).to(torch.complex128))
    assert torch.equal(got, exact.to(torch.complex64))
    perm = torch.from_numpy(rng.permutation(B))
    assert torch.equal(port._overlap_sum(upd[perm], flat[perm], n_pix), got)


@pytest.mark.parametrize("kw", [dict(num_iter=2, batch_size=16, step_size=0.5),
                                dict(num_iter=3, batch_size=1, step_size=1.0)])
def test_reconstruct_matches_reference(floored, kw):
    """The whole call on the floored vacuum probe: the phase within 2e-5
    rad (measured 5.7e-6 at batch 1, three epochs)."""
    want = ref.reconstruct_ptychography(floored, com_rotation_force=0.0, crop_margin=4, **kw)
    got = port.reconstruct_ptychography(floored, com_rotation_force=0.0, crop_margin=4,
                                        device="cpu", **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-5


def test_reconstruct_plain_fixture(plain, monkeypatch):
    """On the aperture-limited probe: the engine's inputs as the
    reference's (amplitudes 1e-6 relative, probe and positions equal), and
    the phase correlates with the truth as well as the reference's (within
    0.05; the module docstring says why not closer)."""
    path, (V, pad_gen) = plain
    seen = {}
    for name, mod in (("ref", ref), ("port", port)):
        real = mod._epie_reconstruct

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] = (a, kw)
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "_epie_reconstruct", spy)
    kw = dict(com_rotation_force=0.0, crop_margin=0, num_iter=5, batch_size=4, step_size=1.0)
    want = ref.reconstruct_ptychography(path, **kw)
    got = port.reconstruct_ptychography(path, device="cpu", **kw)
    (ra, rk), (pa, pk) = seen["ref"], seen["port"]
    amps_r = np.asarray(ra[0], np.float32)
    assert np.abs(pa[0].numpy() - amps_r).max() <= 1e-6 * amps_r.max()
    np.testing.assert_array_equal(pa[1], ra[1])
    np.testing.assert_array_equal(pa[2], ra[2])
    assert pa[3] == ra[3] and pk == rk

    def corr(pot):
        tru = np.zeros_like(pot)
        oy, ox = V.shape
        tru[16 - pad_gen : 16 - pad_gen + oy, 16 - pad_gen : 16 - pad_gen + ox] = V
        span = 11 * 2 + 32
        r = pot[26 : 16 + span - 10, 26 : 16 + span - 10]
        t = tru[26 : 16 + span - 10, 26 : 16 + span - 10]
        r, t = r - r.mean(), t - t.mean()
        return float((r * t).sum() / np.sqrt((r * r).sum() * (t * t).sum()))

    assert np.isfinite(got).all()
    assert corr(got) >= corr(want) - 0.05


def test_reconstruct_validates_inputs(tmp_path):
    for bad in ("", str(tmp_path / "missing.h5")):
        with pytest.raises(ValueError):
            port.reconstruct_ptychography(bad, device="cpu")
    with pytest.raises(ValueError):
        port.reconstruct_ptychography(str(tmp_path), num_iter=0, device="cpu")
