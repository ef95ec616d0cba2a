"""Curvelet denoising in the PyTorch port (helicon_tpu_torch/core/curvelet.py)
against the JAX package's (helicon_tpu/core/curvelet.py) on the same
numpy inputs, every name of its __all__: the window stacks at atol 1e-6,
the even-count median against jnp.median, the transforms, and the
denoisers (2D udct / mct, 3D nDirs 6 / 0, sigma 0 and 3, the tiled
variants and the batch aliases), each at 1e-5 of the reference output's
peak. Where a denoiser thresholds, the kept masks are held band by band:
every coefficient whose keep decision differs between the two packages
must lie within 1e-5 relative of the reference's threshold of its band,
and the outputs are compared with those coefficients' own synthesis taken
out (one so close to its threshold moves an image by up to ~9 % of its
peak at sigma 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.core import curvelet as ref
from helicon_tpu.core import fft as ref_fft
from helicon_tpu_torch.core import curvelet

SHAPES_2D = [(32, 32), (31, 33)]
SHAPE_3D = (24, 20, 18)
KEEP_REL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _image(shape, seed=0):
    """Noise of std 1 over two bright lines and a blob."""
    g = np.random.default_rng(seed)
    y, x = np.meshgrid(*(np.arange(n) - n / 2 for n in shape), indexing="ij")
    sig = 4 * np.exp(-((x - 0.6 * y) ** 2) / 2) + 3 * np.exp(-((y - 5) ** 2) / 3)
    sig += 5 * np.exp(-((x + 6) ** 2 + (y + 6) ** 2) / 8)
    return (sig + g.normal(size=shape)).astype(np.float32)


def _volume(shape=SHAPE_3D, seed=0):
    g = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n) - n / 2 for n in shape), indexing="ij")
    sig = 4 * np.exp(-((x - 3) ** 2 + y**2) / 3) + 3 * np.exp(-((x + 2) ** 2 + (z - 4) ** 2) / 2)
    return (sig + g.normal(size=shape)).astype(np.float32)


# --------------------------------------------------------------------------
# windows, medians, transforms
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("n_scales,n_angles", [(4, 8), (3, 4), (2, 1)])
def test_windows_2d_match_reference(shape, n_scales, n_angles):
    want, meta_w = ref.curvelet_bands_2d(shape, n_scales, n_angles)
    got, meta = curvelet.curvelet_bands_2d(shape, n_scales, n_angles, device="cpu")
    assert meta == meta_w and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_scales,n_dirs", [(4, 6), (4, 0), (3, 1), (2, 3)])
def test_windows_3d_match_reference(n_scales, n_dirs):
    """The directional stack (nDirs > 0) and the radial one (nDirs 0)."""
    want, meta_w = ref.curvelet_bands_3d(SHAPE_3D, n_scales, n_dirs)
    got, meta = curvelet.curvelet_bands_3d(SHAPE_3D, n_scales, n_dirs, device="cpu")
    assert meta == meta_w and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    if n_dirs > 0:
        np.testing.assert_allclose(
            curvelet._directional_bands_3d(*SHAPE_3D, n_scales, n_dirs, "cpu")[0].numpy(),
            ref._directional_bands_3d(*SHAPE_3D, n_scales, n_dirs)[0], atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(curvelet._radial_bands_3d(*SHAPE_3D, n_scales, "cpu").numpy(),
                                   ref._radial_bands_3d(*SHAPE_3D, n_scales), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1001])
def test_median_and_mad_match_jnp(n):
    """The median of an even count is the mean of the two middle values
    (jnp's), exactly; the MAD sigma at 1e-7 relative."""
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    x[: n // 3] = np.round(x[: n // 3], 1)  # ties
    assert float(curvelet._median(torch.as_tensor(x))) == float(jnp.median(x))
    rows = torch.as_tensor(np.stack([x, -2 * x]))
    np.testing.assert_array_equal(curvelet._median(rows).numpy(),
                                  [float(jnp.median(x)), float(jnp.median(-2 * x))])
    want = float(ref._mad_sigma(jnp.asarray(x)))
    assert abs(float(curvelet._mad_sigma(torch.as_tensor(x))) - want) <= 1e-7 * abs(want)


@pytest.mark.parametrize("n", [5, 64, 999])
def test_elbow_threshold_matches_reference(n):
    mags = np.abs(np.random.default_rng(n).standard_cauchy(size=n)).astype(np.float32)
    assert float(curvelet._elbow_threshold(torch.as_tensor(mags))) == float(
        ref._elbow_threshold(jnp.asarray(mags)))


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_transforms_2d_match_reference(shape):
    """Forward coefficients, the inverse and the Riesz pair at 1e-5 of the
    reference's peak; the inverse of the forward is the image (tight frame)."""
    img = _image(shape)
    want = np.asarray(ref.curvelet_transform_2d(img, 3, 4))
    got = curvelet.curvelet_transform_2d(torch.as_tensor(img), 3, 4)
    assert got.dtype == torch.complex64
    assert _rel(torch.view_as_real(got), np.stack([want.real, want.imag], -1)) < 1e-5
    back = curvelet.curvelet_inverse_2d(got, 3, 4)
    assert _rel(back, ref.curvelet_inverse_2d(jnp.asarray(want), 3, 4)) < 1e-5
    assert _rel(back, img) < 1e-5
    for g, w in zip(curvelet.riesz_transform_2d(torch.as_tensor(img)),
                    ref.riesz_transform_2d(img)):
        assert _rel(g, w) < 1e-5


# --------------------------------------------------------------------------
# the denoisers, with the kept-mask rule
# --------------------------------------------------------------------------


def _ref_bands_2d(img, transform, sigma, n_scales=4, n_angles=8):
    """The reference's thresholded bands of denoise_curvelet_2d: (k, the
    coefficients it keeps or drops, the magnitudes it thresholds, its
    threshold), from its own functions."""
    c0 = ref.curvelet_transform_2d(img, n_scales, n_angles)
    mags = jnp.abs(c0)
    if transform == "mct":
        rx, ry = ref.riesz_transform_2d(img)
        cx = ref.curvelet_transform_2d(rx, n_scales, n_angles)
        cy = ref.curvelet_transform_2d(ry, n_scales, n_angles)
        mags = jnp.sqrt(jnp.abs(c0) ** 2 + jnp.abs(cx) ** 2 + jnp.abs(cy) ** 2)
    mad = ref._mad_sigma(jnp.real(c0[-1]))
    _, meta = ref._windows_2d(*img.shape, n_scales, n_angles)
    return [(k, np.asarray(c0[k]), np.asarray(mags[k]),
             float(ref._elbow_threshold(mags[k]) if sigma <= 0 else sigma * mad))
            for k, (scale, _) in enumerate(meta) if scale != -1]


def _ref_bands_3d(vol, sigma, n_dirs, n_scales=4):
    U, _ = ref.curvelet_bands_3d(vol.shape, n_scales=n_scales, n_dirs=n_dirs)
    coeffs = ref_fft.ifftn(ref_fft.fftn(jnp.asarray(vol))[None] * U, axes=(-3, -2, -1))
    out = []
    for k in range(1, coeffs.shape[0]):
        mag = jnp.abs(coeffs[k])
        thr = (ref._elbow_threshold(mag) if sigma <= 0
               else sigma * ref._mad_sigma(jnp.real(coeffs[k])))
        out.append((k, np.asarray(coeffs[k]), np.asarray(mag), float(thr)))
    return out


def _recorder():
    seen = []
    return seen, lambda k, c, mag, thr: seen.append((k, mag.numpy(), thr.numpy()))


def _hold_masks(seen, want, U):
    """The kept-mask rule. Returns the synthesis of the differing
    coefficients (the reference's values, + where only the port kept one,
    - where only the reference did) through the windows U: the port's
    output less it is the reference's output."""
    assert [k for k, *_ in seen] == [k for k, *_ in want]
    delta = 0.0
    for (k, mag, thr), (_, c_w, mag_w, thr_w) in zip(seen, want):
        assert abs(float(thr) - thr_w) <= KEEP_REL * thr_w
        kept, kept_w = mag >= thr, mag_w >= thr_w
        differ = kept != kept_w
        assert np.all(np.abs(mag_w[differ] - thr_w) <= KEEP_REL * thr_w)
        if differ.any():
            dims = tuple(range(-c_w.ndim, 0))
            D = torch.as_tensor(c_w * (kept.astype(np.float32) - kept_w))
            D = torch.fft.fftn(D, dim=dims) * U[k]
            delta = delta + torch.fft.ifftn(D, dim=dims).real.numpy()
    return delta


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("transform", ["udct", "mct"])
@pytest.mark.parametrize("sigma", [0.0, 3.0])
def test_denoise_curvelet_2d_matches_reference(shape, transform, sigma):
    img = _image(shape, 1)
    want = np.asarray(ref.denoise_curvelet_2d(img, transform=transform, threshold_sigma=sigma))
    seen, on_band = _recorder()
    got = curvelet.denoise_curvelet_2d(torch.as_tensor(img), transform=transform,
                                       threshold_sigma=sigma, on_band=on_band)
    delta = _hold_masks(seen, _ref_bands_2d(img, transform, sigma),
                        curvelet.curvelet_bands_2d(shape, device="cpu")[0])
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy() - delta, want) < 1e-5


@pytest.mark.parametrize("n_dirs", [6, 0])
@pytest.mark.parametrize("sigma", [0.0, 3.0])
def test_denoise_curvelet_3d_matches_reference(n_dirs, sigma):
    vol = _volume()
    want = np.asarray(ref.denoise_curvelet_3d(vol, threshold_sigma=sigma, n_dirs=n_dirs))
    seen, on_band = _recorder()
    got = curvelet.denoise_curvelet_3d(torch.as_tensor(vol), threshold_sigma=sigma,
                                       n_dirs=n_dirs, on_band=on_band)
    delta = _hold_masks(seen, _ref_bands_3d(vol, sigma, n_dirs),
                        curvelet.curvelet_bands_3d(vol.shape, n_dirs=n_dirs, device="cpu")[0])
    assert got.shape == want.shape and _rel(got.numpy() - delta, want) < 1e-5


# --------------------------------------------------------------------------
# the tiled variants and the aliases
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("denoise_curvelet_2d_tiled", dict(tile_size=24, overlap=8)),
    ("denoise_curvelet_2d_tiled", dict(tile_size=48, overlap=8, transform="mct")),
    ("curvelet_denoise_udct_tiled", dict(tile_size=20, overlap=6, threshold_sigma=2.0)),
    ("curvelet_denoise_fdct_tiled", dict(tile_size=24, overlap=8)),
    ("curvelet_denoise_mct_tiled", dict(tile_size=24, overlap=8)),
])
def test_tiled_2d_matches_reference(name, kw):
    """A 40 x 44 image in tiles smaller than it (and one tile that holds it)."""
    img = _image((40, 44), 2)
    want = np.asarray(getattr(ref, name)(img, **kw))
    got = getattr(curvelet, name)(torch.as_tensor(img), **kw)
    assert got.shape == want.shape and _rel(got, want) < 1e-5


@pytest.mark.parametrize("name,kw", [
    ("curvelet_denoise_3d_udct_tiled", dict(tile_size=16, overlap=4)),
    ("curvelet_denoise_3d_mct_tiled", dict(tile_size=12, overlap=3, n_dirs=0)),
    ("curvelet_denoise_3d_udct_tiled", dict(tile_size=64, overlap=4, threshold_sigma=2.0)),
])
def test_tiled_3d_matches_reference(name, kw):
    """A (40, 12, 14) map in z-chunks smaller than it (and one that holds it)."""
    vol = _volume((40, 12, 14), 3)
    want = np.asarray(getattr(ref, name)(vol, **kw))
    got = getattr(curvelet, name)(torch.as_tensor(vol), **kw)
    assert got.shape == want.shape and _rel(got, want) < 1e-5


@pytest.mark.parametrize("name", ["curvelet_denoise_udct", "curvelet_denoise_fdct",
                                  "curvelet_denoise_mct", "curvelet_denoise_3d_udct",
                                  "curvelet_denoise_3d_mct"])
def test_aliases_match_reference(name):
    data = _volume((12, 14, 10), 4) if "3d" in name else _image((24, 26), 4)
    want = np.asarray(getattr(ref, name)(data, threshold_sigma=2.5, n_scales=3))
    got = getattr(curvelet, name)(torch.as_tensor(data), threshold_sigma=2.5, n_scales=3)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("name", ["curvelet_denoise_batch_udct", "curvelet_denoise_batch_fdct",
                                  "curvelet_denoise_batch_mct"])
def test_batch_aliases_match_reference(name, monkeypatch):
    """An array stack denoised in chunks of two images (each image as it
    is alone), a list of two shapes (a list back) and a list of one shape
    (a stack back)."""
    monkeypatch.setattr(curvelet, "BATCH_PIXELS", 2 * 24 * 24)
    stack = np.stack([_image((24, 24), s) for s in range(5)])
    want = np.asarray(getattr(ref, name)(stack, threshold_sigma=2.0))
    got = getattr(curvelet, name)(torch.as_tensor(stack), threshold_sigma=2.0)
    assert got.shape == want.shape and _rel(got, want) < 1e-5
    for i in range(len(stack)):
        assert _rel(got[i], want[i]) < 1e-5
    mixed = [_image((24, 24), 7), _image((20, 28), 8)]
    want = getattr(ref, name)(mixed)
    got = getattr(curvelet, name)([torch.as_tensor(m) for m in mixed])
    assert isinstance(got, list) and len(got) == 2
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5
    same = [_image((24, 24), 9), _image((24, 24), 10)]
    want = np.asarray(getattr(ref, name)(same))
    got = getattr(curvelet, name)(same, device="cpu")
    assert torch.is_tensor(got) and _rel(got, want) < 1e-5


def test_exports_match_reference():
    assert sorted(curvelet.__all__) == sorted(ref.__all__)
    for name in ref.__all__:
        assert callable(getattr(curvelet, name)), name
