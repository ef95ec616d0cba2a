"""The volume library of the 3D-map commands in the PyTorch port, against
the JAX package on the same seeded numpy inputs (maps of 24-40 voxels a
side, some odd): the clips, fft_crop, fft_rescale and flip_hand (1e-5
relative to the reference's peak), the FSC / FRC family (1e-5 absolute),
and the phase randomization (the draw bit for bit, the output 1e-5
relative)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.core import analysis as ref_an
from helicon_tpu.core import filters as ref_filters
from helicon_tpu.core import transforms as ref_tf
from helicon_tpu_torch import _jax_random
from helicon_tpu_torch.core import analysis, filters, transforms


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _vol(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(n, seed=0, noise=0.5):
    """Two half maps: one smooth blob map plus independent noise."""
    r = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n) - n / 2,) * 3, indexing="ij")
    base = np.zeros((n, n, n))
    for c in r.uniform(-n / 4, n / 4, size=(6, 3)):
        base += np.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) / 8.0)
    return [(base + noise * r.normal(size=base.shape)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("args", [(-3, 2, 10, 12), (4, 5, 8, 8), (0, 0, 16, 14), (10, -6, 9, 40)])
def test_get_clip_matches_reference(args):
    img = _vol((16, 14))
    np.testing.assert_array_equal(transforms.get_clip(img, *args, device="cpu").numpy(),
                                  ref_tf.get_clip(img, *args))


@pytest.mark.parametrize("args", [(-3, 2, 1, 10, 12, 9), (4, 5, 0, 8, 8, 8),
                                  (0, 0, 0, 24, 25, 27), (20, -6, 3, 9, 40, 5)])
def test_get_clip3d_matches_reference(args):
    vol = _vol((24, 25, 27))
    np.testing.assert_array_equal(transforms.get_clip3d(vol, *args, device="cpu").numpy(),
                                  ref_tf.get_clip3d(vol, *args))


@pytest.mark.parametrize("shape,out", [((32, 32, 32), (24, 24, 24)), ((28, 32, 36), (20, 24, 16)),
                                       ((32, 40), (24, 20))])
def test_fft_crop_matches_reference(shape, out):
    vol = _vol(shape, 1)
    want = np.asarray(ref_tf.fft_crop(vol, out))
    got = transforms.fft_crop(vol, out, device="cpu")
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("shape,out,apix", [((32, 32, 32), (24, 24, 24), 1.0),
                                            ((25, 27, 29), (31, 30, 33), 1.3),
                                            ((30, 28), (24, 26), 2.0)])
def test_fft_rescale_matches_reference(shape, out, apix):
    vol = _vol(shape, 2)
    cut = tuple(2 * apix * n / m for n, m in zip(shape, out))
    want = np.asarray(ref_tf.fft_rescale(vol, apix=apix, cutoff_res=cut, output_size=out))
    got = transforms.fft_rescale(vol, apix=apix, cutoff_res=cut, output_size=out, device="cpu")
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_flip_hand_matches_reference(axis):
    vol = _vol((24, 25, 27), 3)
    np.testing.assert_array_equal(transforms.flip_hand(vol, axis, device="cpu").numpy(),
                                  np.asarray(ref_tf.flip_hand(vol, axis)))
    with pytest.raises(ValueError):
        transforms.flip_hand(vol, "w", device="cpu")


@pytest.mark.parametrize("n", [24, 33])
def test_calc_fsc_matches_reference(n):
    a, b = _pair(n, n)
    want = ref_an.calc_fsc(a, b, 1.2)
    got = analysis.calc_fsc(torch.as_tensor(a), torch.as_tensor(b), 1.2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # from precomputed spectra and with the caller's shells
    F1, F2 = (np.array(jnp.fft.rfftn(jnp.asarray(v))) for v in (a, b))
    shell = ref_an._shell_labels_3d(n)
    np.testing.assert_array_equal(analysis._shell_labels_3d(n).numpy(), shell)
    got = analysis.calc_fsc(None, None, 1.2, F1=torch.as_tensor(F1), F2=torch.as_tensor(F2),
                            shell_flat=torch.as_tensor(shell.ravel()), n=n)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(analysis.calc_fsc_from_fft(torch.as_tensor(F1),
                                                          torch.as_tensor(F2), n, 1.2),
                               ref_an.calc_fsc_from_fft(F1, F2, n, 1.2), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [24, 33])
def test_calc_fsc_per_shell_matches_reference(n):
    a, b = _pair(n, n + 1)
    mask = np.random.default_rng(n).uniform(size=(n, n, n))
    want = ref_an.calc_fsc_per_shell(a * mask, b * mask, 1.0)
    got = analysis.calc_fsc_per_shell(torch.as_tensor(a * mask), torch.as_tensor(b * mask), 1.0)
    assert got.shape == want.shape == (n // 2 + 1,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(32, 32), (30, 37)])
def test_calc_frc_2d_matches_reference(shape):
    r = np.random.default_rng(5)
    a = r.normal(size=shape).astype(np.float32)
    b = (a + 0.7 * r.normal(size=shape)).astype(np.float32)
    s_want, f_want = ref_an.calc_frc_2d(a, b, 1.5)
    s_got, f_got = analysis.calc_frc_2d(torch.as_tensor(a), torch.as_tensor(b), 1.5)
    np.testing.assert_array_equal(s_got, s_want)
    np.testing.assert_allclose(f_got, f_want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        analysis.calc_frc_2d(torch.as_tensor(a), torch.as_tensor(b[:-1]), 1.5)


@pytest.mark.parametrize("use_fit", [False, True])
def test_frc_score_matches_reference(use_fit):
    """A blob under noise in both images: every ring holds power far above
    float32 rounding (a noiseless Gaussian's outer rings hold ~1e-9 of its
    peak, where two float32 FFTs give unrelated ring correlations)."""
    r = np.random.default_rng(6)
    yy, xx = np.meshgrid(np.arange(32) - 16, np.arange(32) - 16, indexing="ij")
    a = (np.exp(-(yy**2 + xx**2) / 30.0) + 0.02 * r.normal(size=yy.shape)).astype(np.float32)
    b = (a + 0.05 * r.normal(size=a.shape)).astype(np.float32)
    want = ref_an.frc_score(a, b, 2.0, use_fit=use_fit)
    got = analysis.frc_score(torch.as_tensor(a), torch.as_tensor(b), 2.0, use_fit=use_fit)
    assert got == pytest.approx(want, abs=1e-5)


@pytest.mark.parametrize("seed,shape", [(0, (33, 33, 17)), (7, (24, 24, 13)), (2**31 - 2, (5,))])
def test_uniform_tensor_is_jax_uniform(seed, shape):
    """The device draw equals the numpy copy and jax.random.uniform bit for
    bit, an odd word count (33 x 33 x 17 = 18,513) included."""
    key = _jax_random.PRNGKey(seed)
    got = _jax_random.uniform_tensor(key, shape, 0.0, 2 * np.pi).numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=0.0,
                                         maxval=2 * np.pi))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _jax_random.uniform(key, shape, 0.0, 2 * np.pi).view(np.uint32))


@pytest.mark.parametrize("n", [24, 33])
def test_randomize_phases_lowpass_with_key(n):
    vol = _pair(n, 9)[0]
    for return_fft in (True, False):
        want = np.asarray(ref_filters.randomize_phases_lowpass(
            vol, 1.1, 6.0, return_fft=return_fft, key=jax.random.PRNGKey(123)))
        got = filters.randomize_phases_lowpass(torch.as_tensor(vol), 1.1, 6.0,
                                               return_fft=return_fft,
                                               key=_jax_random.PRNGKey(123))
        assert tuple(got.shape) == want.shape
        assert _rel(got, want) < 1e-5


def test_randomize_phases_lowpass_numpy_seed():
    """No key: both packages draw their seed from numpy's global generator."""
    vol = _pair(24, 10)[0]
    np.random.seed(2024)
    want = [np.asarray(ref_filters.randomize_phases_lowpass(vol, 1.0, 5.0)) for _ in range(2)]
    np.random.seed(2024)
    got = [filters.randomize_phases_lowpass(torch.as_tensor(vol), 1.0, 5.0) for _ in range(2)]
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5
    assert _rel(got[0], got[1]) > 1e-2  # two draws, two seeds
