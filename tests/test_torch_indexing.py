"""Helical indexing from power spectra, the CTF, the batched
cross-correlation, and the helical lattice and pitch in the PyTorch port,
against the JAX package on the same seeded numpy inputs.

The reference's normalize_percentile runs under jax.disable_jit(): jitted,
its jnp.percentile(100) is not the array's maximum (6.76893 against
6.76989 on the twist-30 image), which rescales every spectrum by
~1.4e-4; eager, it is, as the port's exact min / max. Tolerances are
stated at each test.
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import helicon_tpu as ht
from helicon_tpu.core import ctf as ref_ctf
from helicon_tpu.core import filters as ref_filters
from helicon_tpu.core import transforms as ref_tf
from helicon_tpu.core import xcorr as ref_xcorr
from helicon_tpu.helix import indexing as ref_ix
from helicon_tpu.helix import lattice as ref_lattice
from helicon_tpu.helix import pitch as ref_pitch
from helicon_tpu_torch import helix as port_helix
from helicon_tpu_torch.core import ctf, transforms, xcorr
from helicon_tpu_torch.helix import indexing, lattice, pitch

APIX = 1.5


def _sim(twist, rise, ball_radius, seed=0):
    """A 256 x 128 projection, the filament axis vertical (the reference's
    test_helix_indexing images)."""
    imgs = ht.simulate_helical_projection(
        n=1, twist=twist, rise=rise, csym=1, helical_diameter=80, ball_radius=ball_radius,
        polymer=0, planarity=1, ny=128, nx=256, apix=APIX, rng=seed)
    return np.ascontiguousarray(np.squeeze(np.asarray(imgs)).T)


GEOMETRIES = [(30, 8, 3), (65, 4.75, 2.5), (30, 6, 6), (22, 5, 3)]


@pytest.fixture(scope="module")
def images():
    return {g: _sim(*g) for g in GEOMETRIES}


@pytest.fixture(autouse=True)
def _eager_percentile(monkeypatch):
    """The reference's normalize_percentile under jax.disable_jit() (see
    the module docstring); the rest of the reference as it runs."""
    real = ref_filters.normalize_percentile

    def eager(*a, **kw):
        with jax.disable_jit():
            return real(*a, **kw)

    monkeypatch.setattr(ref_filters, "normalize_percentile", eager)


def _ref_spectra(img, **kw):
    pwr, phase = ref_tf.compute_power_spectra(img, apix=APIX, **kw)
    return np.array(pwr), np.array(phase)


def _phase_err(a, b) -> float:
    """Largest phase difference, wrapped (a phase near +-pi may land on
    either side)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.abs((d + np.pi) % (2 * np.pi) - np.pi).max())


def _lines(ls):
    return [(l.Z, l.meridional, l.bessel_order, l.r_peak) for l in ls]


def _same_lines(got, want):
    """Equal lines; intensities within 1e-6 (spectra in [0, 1] agree to a
    few float32 ulps)."""
    assert _lines(got) == _lines(want)
    for a, b in zip(got, want):
        assert abs(a.intensity - b.intensity) <= 1e-6


# ---------------------------------------------------------------- power spectra


@pytest.mark.parametrize("kw", [dict(), dict(cutoff_res=(4.0, 5.0)),
                                dict(low_pass_fraction=0.4, high_pass_fraction=0.02),
                                dict(log=False)])
def test_compute_power_spectra_matches_reference(images, kw):
    """pwr within 1e-5 of its [0, 1] range, the phase within 1e-3 rad
    wrapped (atan2 of coefficients near zero)."""
    img = images[(30, 8, 3)]
    want_pwr, want_phase = _ref_spectra(img, **kw)
    pwr, phase = transforms.compute_power_spectra(img, apix=APIX, device="cpu", **kw)
    assert pwr.shape == want_pwr.shape and pwr.dtype == torch.float32
    assert np.abs(pwr.numpy() - want_pwr).max() <= 1e-5
    big = np.abs(np.asarray(ref_tf.fft_rescale(img, apix=APIX, **{
        k: v for k, v in kw.items() if k in ("output_size", "cutoff_res")})))
    live = np.fft.fftshift(big) > 1e-3 * big.max()
    assert _phase_err(phase.numpy()[live], want_phase[live]) <= 1e-3


def test_compute_power_spectra_map_matches_reference():
    """A 3D map takes the map path (the reference's fft_rescale in 3D)."""
    vol = np.random.default_rng(3).standard_normal((20, 22, 24)).astype(np.float32)
    want, _ = _ref_spectra(vol)
    got, _ = transforms.compute_power_spectra(vol, apix=APIX, device="cpu")
    assert np.abs(got.numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("kw", [dict(), dict(output_size=(32, 36), cutoff_res=(5.0, 4.0)),
                                dict(low_pass_fraction=0.3), dict(log=False)])
@pytest.mark.parametrize("shape", [(5, 48, 40), (3, 37, 52)])
def test_power_spectra_batch_equals_each_image(kw, shape):
    """The batched form: every image bit for bit its own call's."""
    imgs = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    pwr, phase = transforms.compute_power_spectra_batch(imgs, apix=APIX, device="cpu", **kw)
    for i in range(shape[0]):
        p1, ph1 = transforms.compute_power_spectra(imgs[i], apix=APIX, device="cpu", **kw)
        assert torch.equal(pwr[i], p1) and torch.equal(phase[i], ph1)


def test_power_spectra_batch_matches_reference_vmap(images):
    """Against the reference's bench form (jit of vmap) the stack agrees
    within 2e-4: the jitted jnp.percentile(100) (see the module docstring)."""
    imgs = np.stack([images[g] for g in GEOMETRIES])
    want = np.asarray(jax.jit(jax.vmap(lambda im: ref_tf.compute_power_spectra(im, apix=APIX)[0]))(
        jnp.asarray(imgs)))
    got, _ = transforms.compute_power_spectra_batch(imgs, apix=APIX, device="cpu")
    assert np.abs(got.numpy() - want).max() <= 2e-4


# ---------------------------------------------------------------- indexing


def test_bessel_helpers_match_reference():
    for n in range(0, 12):
        assert indexing.bessel_first_peak_x(n) == ref_ix.bessel_first_peak_x(n)
    for r_peak in np.linspace(0.0, 0.2, 41):
        assert indexing.estimate_bessel_order(r_peak, 40.0) == ref_ix.estimate_bessel_order(
            r_peak, 40.0)
    lines = [indexing.LayerLine(Z=z, intensity=i, r_peak=0.01)
             for z, i in ((0.01, 100.0), (0.2, 5.0), (0.305, 2.0), (0.41, 1.0))]
    ref_lines = [ref_ix.LayerLine(Z=l.Z, intensity=l.intensity, r_peak=l.r_peak) for l in lines]
    for p in (10.0, 9.8, 20.0):
        assert indexing._harmonic_support(p, lines) == ref_ix._harmonic_support(p, ref_lines)


def test_layer_line_profiles_match_reference(images):
    pwrs = np.stack([_ref_spectra(images[g])[0] for g in GEOMETRIES])
    want = [np.asarray(v) for v in ref_ix.layer_line_profiles(pwrs)]
    got = [v.numpy() for v in indexing.layer_line_profiles(torch.from_numpy(pwrs))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("radius", [40.0, None])
def test_detect_layer_lines_matches_reference(images, geometry, radius):
    """On the reference's own spectrum the lines are equal exactly."""
    pwr, _ = _ref_spectra(images[geometry])
    want = ref_ix.detect_layer_lines(pwr, apix=APIX, radius=radius)
    got = indexing.detect_layer_lines(torch.from_numpy(pwr), apix=APIX, radius=radius)
    assert _lines(got) == _lines(want)
    assert [l.intensity for l in got] == [l.intensity for l in want]


def test_detect_layer_lines_batch_matches_reference(images):
    pwrs = np.stack([_ref_spectra(images[g])[0] for g in GEOMETRIES])
    want = ref_ix.detect_layer_lines_batch(pwrs, apix=APIX, radius=40.0)
    got = indexing.detect_layer_lines_batch(pwrs, apix=APIX, radius=40.0, device="cpu")
    assert len(got) == len(want) == len(GEOMETRIES)
    for a, b in zip(got, want):
        _same_lines(a, b)


def test_noise_spectrum_lines_match_reference():
    img = np.random.default_rng(0).normal(0, 1, (256, 128)).astype(np.float32)
    pwr, _ = _ref_spectra(img)
    for prom in (3.0, 6.0):
        want = ref_ix.detect_layer_lines(pwr, apix=APIX, min_prominence=prom)
        got = indexing.detect_layer_lines(torch.from_numpy(pwr), apix=APIX, min_prominence=prom)
        _same_lines(got, want)


def _same_candidates(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if isinstance(b[k], float) and math.isnan(b[k]):
                assert math.isnan(a[k])
            elif k == "support":
                assert abs(a[k] - b[k]) <= 1e-5
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_estimate_helical_parameters_matches_reference(images, geometry):
    """Image -> candidates: the port's spectrum (1 ulp from the eager
    reference's) gives the same lines and candidates, supports within
    1e-5."""
    img = images[geometry]
    want = ref_ix.estimate_helical_parameters(img, apix=APIX, diameter=80.0, radius_factor=1.0)
    got = indexing.estimate_helical_parameters(img, apix=APIX, diameter=80.0, radius_factor=1.0,
                                               device="cpu")
    _same_lines(got["layer_lines"], want["layer_lines"])
    _same_candidates(got["candidates"], want["candidates"])


def test_estimate_helical_parameters_pwr_paths():
    """The precomputed-spectrum path, the rise-only NaN twist and the
    missing-input error, as the reference."""
    ny = nx = 64
    pwr = np.random.default_rng(0).random((ny, nx)) * 0.01 + 1.0
    sy = np.fft.fftshift(np.fft.fftfreq(ny, d=1.0))
    p = int(np.argmin(np.abs(sy - 0.25)))
    pwr[p, nx // 2] = pwr[ny - p, nx // 2] = 50.0
    want = ref_ix.estimate_helical_parameters(pwr=pwr, apix=1.0)
    got = indexing.estimate_helical_parameters(pwr=pwr, apix=1.0, device="cpu")
    _same_lines(got["layer_lines"], want["layer_lines"])
    _same_candidates(got["candidates"], want["candidates"])
    assert math.isnan(got["candidates"][0]["twist"])
    with pytest.raises(ValueError):
        indexing.estimate_helical_parameters(apix=1.5, device="cpu")


def test_entry_points_take_device():
    """An array goes to ``device`` (the card by default); a tensor keeps
    its own."""
    import inspect

    for fn in (indexing.estimate_helical_parameters, indexing.detect_layer_lines_batch,
               xcorr.batched_cross_correlation):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    pwrs = torch.rand(2, 16, 16)
    assert len(indexing.detect_layer_lines_batch(pwrs, apix=1.0, device="meta")) == 2
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            indexing.detect_layer_lines_batch(pwrs.numpy(), apix=1.0)


# ---------------------------------------------------------------- ctf


def test_electron_wavelength_and_ctf_1d_match_reference():
    for kv in (100, 200, 300):
        assert ctf.electron_wavelength(kv) == ref_ctf.electron_wavelength(kv)
    s = np.linspace(0, 0.5, 500)
    for kw in (dict(), dict(defocus_um=3.0, bfactor=50.0, phase_shift_deg=30.0),
               dict(defocus_um=0.5, voltage_kv=200.0, amp_contrast=0.1)):
        np.testing.assert_allclose(ctf.ctf_1d(s, device="cpu", **kw).numpy(),
                                   np.asarray(ref_ctf.ctf_1d(s, **kw)), atol=2e-7)


def _gamma_ulps(shape, apix, defocus_A) -> float:
    """3 float32 ulps of the largest CTF phase: gamma (hundreds of radians
    at these defoci) rounds differently in two float32 evaluations, and
    |dCTF/dgamma| <= 1."""
    s2 = 2 * (0.5 / apix) ** 2
    lam = ref_ctf.electron_wavelength(300.0)
    g = math.pi * lam * s2 * defocus_A
    return 3 * float(np.spacing(np.float32(g)))


@pytest.mark.parametrize("shape,kw", [
    ((64, 64), dict(defocus_u_A=20000.0, defocus_v_A=10000.0)),
    ((96, 80), dict(defocus_u_A=15000.0, defocus_v_A=14000.0, astig_angle_deg=12.0,
                    phase_shift_deg=90.0, bfactor=80.0, amp_contrast=0.1)),
    ((128, 128), dict(defocus_u_A=20000.0, defocus_v_A=18000.0, astig_angle_deg=30.0)),
])
def test_ctf_2d_matches_reference(shape, kw):
    want = np.asarray(ref_ctf.ctf_2d(shape, apix=1.0, **kw))
    got = ctf.ctf_2d(shape, apix=1.0, device="cpu", **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= _gamma_ulps(shape, 1.0, kw["defocus_u_A"])


def test_ctf_2d_stack_matches_reference_vmap():
    """A stack of defoci in one call, as the reference's vmap."""
    d = np.array([10000.0, 15000.0, 20000.0], np.float32)
    want = np.asarray(jax.vmap(lambda u: ref_ctf.ctf_2d(
        (128, 128), apix=1.3, defocus_u_A=u, defocus_v_A=u * 0.9, astig_angle_deg=30.0))(
        jnp.asarray(d)))
    got = ctf.ctf_2d((128, 128), 1.3, defocus_u_A=d, defocus_v_A=d * np.float32(0.9), device="cpu",
                     astig_angle_deg=30.0)
    assert got.shape == (3, 128, 128)
    assert np.abs(got.numpy() - want).max() <= _gamma_ulps((128, 128), 1.3, 20000.0)
    one = ctf.ctf_2d((128, 128), 1.3, defocus_u_A=float(d[1]),
                     defocus_v_A=float(d[1] * np.float32(0.9)), astig_angle_deg=30.0,
                     device="cpu")
    assert torch.equal(got[1], one)


@pytest.mark.parametrize("twist,rise,csym,n", [(30.0, 5.0, 1, 5), (30.0, 5.0, 2, 5),
                                              (180.0, 4.75, 1, 5), (-1.2, 4.75, 1, 10),
                                              (0.0, 4.75, 3, 4)])
def test_layer_line_math_matches_reference(twist, rise, csym, n):
    assert ctf.layer_line_positions(twist, rise, csym, n) == ref_ctf.layer_line_positions(
        twist, rise, csym, n)
    assert ctf.layer_line_bessel_orders(twist, rise, csym, n) == \
        ref_ctf.layer_line_bessel_orders(twist, rise, csym, n)
    np.testing.assert_array_equal(
        ctf.simulate_helix_power_spectrum((64, 48), 2.0, twist, rise, csym, n_lines=n),
        ref_ctf.simulate_helix_power_spectrum((64, 48), 2.0, twist, rise, csym, n_lines=n))


# ---------------------------------------------------------------- xcorr


def _xcorr_inputs(C=6, S=40, n=32, seed=0):
    rng = np.random.default_rng(seed)
    cl = rng.standard_normal((C, n, n)).astype(np.float32)
    sg = rng.standard_normal((S, n, n)).astype(np.float32)
    sg[3] = np.roll(cl[1], (4, -3), axis=(0, 1))
    sg[7] = np.roll(cl[2], (n // 2, -(n // 2) + 1), axis=(0, 1)) + 0.1 * sg[7]
    return cl, sg


def _hold_xcorr(got, want, cl, sg):
    """Peaks within 1e-5 relative; where a shift differs, the reference's
    map at both shifts within 1e-5 relative of the peak (two near-equal
    maxima that float32 rounding orders apart)."""
    peak, shift = (t.numpy() for t in got)
    wpeak, wshift = (np.asarray(t) for t in want)
    assert peak.shape == wpeak.shape and shift.shape == wshift.shape
    assert np.abs(peak - wpeak).max() <= 1e-5 * np.abs(wpeak).max()
    for c, s in zip(*np.nonzero((shift != wshift).any(-1))):
        m = np.asarray(ref_xcorr.cross_correlation_map(cl[c], sg[s]))
        assert abs(m[tuple(shift[c, s])] - m[tuple(wshift[c, s])]) <= 1e-5 * abs(wpeak[c, s])


@pytest.mark.parametrize("shape", [(6, 40, 32), (3, 17, 24)])
def test_batched_cross_correlation_matches_reference(shape):
    cl, sg = _xcorr_inputs(*shape)
    want = ref_xcorr.batched_cross_correlation(cl, sg)
    got = xcorr.batched_cross_correlation(cl, sg, device="cpu")
    _hold_xcorr(got, want, cl, sg)
    assert tuple(got[1][1, 3].tolist()) == (-4, 3)
    assert got[0][1, 3] > 0.999


def test_batched_cross_correlation_chunks_and_shift_rule():
    """Any chunk gives the same bits; a shift of exactly n/2 wraps to +n/2
    (the reference's > n // 2 rule)."""
    cl, sg = _xcorr_inputs()
    whole = xcorr.batched_cross_correlation(cl, sg, device="cpu")
    for chunk in (1, 7, 40):
        part = xcorr.batched_cross_correlation(cl, sg, chunk=chunk, device="cpu")
        assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])
    assert tuple(whole[1][2, 7].tolist()) == (16, 15)
    assert xcorr.segment_chunk(100, 20000, 128, 128, "cpu") == 2**29 // (100 * 128 * 128 * 4)


def test_cross_correlation_map_matches_reference():
    cl, sg = _xcorr_inputs()
    want = np.asarray(ref_xcorr.cross_correlation_map(cl[1], sg[3]))
    got = xcorr.cross_correlation_map(cl[1], sg[3], device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-6


# ---------------------------------------------------------------- lattice and pitch


@pytest.mark.parametrize("tw,ri,cs", [(29.4, 4.75, 1), (-50.0, 2.4, 3), (179.4, 2.35, 1)])
def test_lattice_matches_reference(tw, ri, cs):
    v = lattice.lattice_vectors_from_parameters(tw, ri, radius=50.0, csym=cs)
    np.testing.assert_array_equal(v, ref_lattice.lattice_vectors_from_parameters(
        tw, ri, radius=50.0, csym=cs))
    assert lattice.parameters_from_lattice_vectors(v[0], v[1], 50.0) == \
        ref_lattice.parameters_from_lattice_vectors(v[0], v[1], 50.0)
    for kw in (dict(length=50.0), dict(n_units=4), dict()):
        np.testing.assert_array_equal(
            lattice.helical_lattice_points(tw, ri, radius=50.0, csym=cs, **kw),
            ref_lattice.helical_lattice_points(tw, ri, radius=50.0, csym=cs, **kw))


def test_lattice_errors_match_reference():
    from helicon_tpu_torch.utils.exceptions import HeliconValueError

    with pytest.raises(HeliconValueError, match="degenerate"):
        lattice.helical_lattice_points(twist=30.0, rise=0.0, radius=50.0, length=100.0)
    circ = 2 * np.pi * 50.0
    for v1, v2 in (([10.0, 4.75], [circ / 2.37, 0.0]), ([10.0, 4.75], [circ, 1.0]),
                   ([10.0, 0.0], [circ, 0.0])):
        with pytest.raises(ValueError) as want:
            ref_lattice.parameters_from_lattice_vectors(v1, v2, 50.0)
        with pytest.raises(ValueError) as got:
            lattice.parameters_from_lattice_vectors(v1, v2, 50.0)
        assert str(got.value) == str(want.value)


def _distances(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([k * 180.0 + rng.normal(0, 3.0, 200) for k in (1, 2, 3)])


@pytest.mark.parametrize("args,kw", [((_distances(0),), dict(bins=120)),
                                     ((90.0 + np.random.default_rng(1).normal(0, 2.0, 300),),
                                      dict(csym=2, rise=4.75)),
                                     ((_distances(5),), dict(max_pair_dist=400.0)),
                                     (([100.0, 200.0],), dict())])
def test_pitch_from_distances_matches_reference(args, kw):
    want = ref_pitch.estimate_pitch_from_pair_distances(*args, **kw)
    got = pitch.estimate_pitch_from_pair_distances(*args, **kw)
    assert set(got) == set(want)
    for k in ("pitch", "twist", "peak_dist", "harmonics"):
        assert got[k] == want[k]
    for a, b in zip(got["histogram"], want["histogram"]):
        np.testing.assert_array_equal(a, b)


def test_pitch_from_class2d_raises_naming_its_item():
    # ported since the pair distances of whereIsMyClass's compute came:
    # without params it raises as the reference does, with params it
    # equals the reference (tests/test_torch_whereismyclass.py has more)
    import pandas as pd

    for fn in (ref_pitch.estimate_pitch_from_class2d, pitch.estimate_pitch_from_class2d):
        with pytest.raises(TypeError):
            fn(None)
    rng = np.random.default_rng(2)
    n = 60
    params = pd.DataFrame(dict(
        rlnMicrographName=np.repeat(["m1.mrc", "m2.mrc"], n // 2),
        rlnHelicalTubeID=np.tile(np.repeat([1, 2, 3], n // 6), 2),
        rlnHelicalTrackLengthAngst=np.round(rng.uniform(0, 2000, n), 2),
        rlnClassNumber=rng.integers(1, 3, n), rlnAnglePsi=rng.choice([5.0, 185.0], n)))
    want = ref_pitch.estimate_pitch_from_class2d(params, csym=2, rise=4.75)
    got = pitch.estimate_pitch_from_class2d(params, csym=2, rise=4.75, device="cpu")
    for k in ("pitch", "twist", "peak_dist", "harmonics"):
        assert got[k] == want[k]


def test_helix_exports_match_reference():
    import helicon_tpu.helix as ref_helix

    names = [n for n in dir(ref_helix) if not n.startswith("_") and callable(getattr(ref_helix, n))]
    assert sorted(n for n in names if hasattr(port_helix, n)) == sorted(names)
    assert port_helix.estimate_helical_parameters is indexing.estimate_helical_parameters
