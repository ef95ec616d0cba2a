"""The PyTorch port's image prep chain against the JAX package: cubic
down-scaling, rotation and shift, map_coordinates, the Fourier filters,
the denoisers, the helix orientation and diameter estimators,
prepare_data and the size bookkeeping, on the committed amyloid class
average. The JAX denoisers run under jax.disable_jit(): compiling the
non-local means' 529 shifted passes takes minutes on the CPU."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.core import analysis as ref_analysis
from helicon_tpu.core import denoise as ref_denoise
from helicon_tpu.core import filters as ref_filters
from helicon_tpu.core import interp as ref_interp
from helicon_tpu.core import transforms as ref_transforms
from helicon_tpu.denovo3d import pipeline as ref_pipeline
from helicon_tpu.helix import orient as ref_orient
from helicon_tpu_torch.core import analysis as port_analysis
from helicon_tpu_torch.core import denoise as port_denoise
from helicon_tpu_torch.core import filters as port_filters
from helicon_tpu_torch.core import interp as port_interp
from helicon_tpu_torch.core import transforms as port_transforms
from helicon_tpu_torch.denovo3d import pipeline as port_pipeline
from helicon_tpu_torch.helix import orient as port_orient

AMYLOID = pathlib.Path(__file__).parent / "data" / "class_avg_amyloid.npy"


@pytest.fixture(scope="module")
def amyloid():
    return np.load(AMYLOID).astype(np.float32)


@pytest.mark.parametrize("target_apix", [4.0, 3.0])
def test_down_scale(amyloid, target_apix):
    ref = np.asarray(ref_filters.down_scale(amyloid, target_apix, 2.0))
    out = port_filters.down_scale(amyloid, target_apix, 2.0, device="cpu").numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_down_scale_same_pixel_size_is_identity(amyloid):
    np.testing.assert_array_equal(port_filters.down_scale(amyloid, 2.0, 2.0, device="cpu").numpy(),
                                  amyloid)


@pytest.mark.parametrize("rotation", [7.5, -31.0])
def test_transform_image_rotation(amyloid, rotation):
    ref = np.asarray(ref_transforms.transform_image(amyloid, rotation=rotation))
    out = port_transforms.transform_image(amyloid, rotation=rotation, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("order,mode", [(1, "constant"), (3, "mirror"), (3, "constant")])
def test_map_coordinates(order, mode):
    rng = np.random.default_rng(0)
    img = rng.random((17, 23)).astype(np.float32)
    yy = rng.uniform(-2.0, 18.0, (9, 11)).astype(np.float32)
    xx = rng.uniform(-2.0, 24.0, (9, 11)).astype(np.float32)
    ref = np.asarray(ref_interp.map_coordinates(jnp.asarray(img), (yy, xx), order=order, mode=mode))
    out = port_interp.map_coordinates(torch.from_numpy(img), (yy, xx), order=order, mode=mode)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_map_coordinates_raises_on_unported_order():
    """Order 2 is in neither package: both raise ValueError (order 0 is
    ported; its parity is test_map_coordinates_order0)."""
    args = (np.zeros((4, 4), np.float32), (np.zeros(2, np.float32), np.zeros(2, np.float32)))
    with pytest.raises(ValueError):
        ref_interp.map_coordinates(*args, order=2)
    with pytest.raises(ValueError):
        port_interp.map_coordinates(torch.from_numpy(args[0]), args[1], order=2)


MODES = ("constant", "nearest", "edge", "mirror", "reflect", "wrap", "grid-wrap")


def _coords_with_halves(rng, shape):
    """Uniform coordinates past both edges, every fourth one an exact .5."""
    out = []
    for n in shape:
        c = rng.uniform(-3.0, n + 2.0, (9, 11)).astype(np.float32)
        c.flat[::4] = np.floor(c.flat[::4]) + np.float32(0.5)
        out.append(c)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_map_coordinates_order0(mode):
    """scipy's floor(c + 0.5) rule (an exact .5 takes the upper pixel) in
    every mode, exactly as the reference."""
    rng = np.random.default_rng(1)
    img = rng.random((17, 23)).astype(np.float32)
    yy, xx = _coords_with_halves(rng, img.shape)
    ref = np.asarray(ref_interp.map_coordinates(jnp.asarray(img), (yy, xx), order=0, mode=mode,
                                                cval=-1.0))
    out = port_interp.map_coordinates(torch.from_numpy(img), (yy, xx), order=0, mode=mode,
                                      cval=-1.0)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("order,mode", [(1, "edge"), (1, "grid-wrap"), (3, "edge"),
                                        (3, "grid-wrap")])
def test_map_coordinates_mode_aliases(order, mode):
    rng = np.random.default_rng(2)
    img = rng.random((13, 19)).astype(np.float32)
    yy, xx = _coords_with_halves(rng, img.shape)
    ref = np.asarray(ref_interp.map_coordinates(jnp.asarray(img), (yy, xx), order=order, mode=mode))
    out = port_interp.map_coordinates(torch.from_numpy(img), (yy, xx), order=order, mode=mode)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("fn", ["transform_image", "rotate_shift_image", "get_rotated_clip"])
def test_order0_transforms(amyloid, fn):
    """The three image transforms at order=0 (they raised before the port
    had order 0). Exact where no sample lands within float32 rounding of a
    half-pixel; the count of differing pixels is held at zero."""
    img = amyloid[:, 64:192]
    calls = dict(transform_image=lambda m, x: m.transform_image(x, rotation=12.5, mode="edge",
                                                                 order=0),
                 rotate_shift_image=lambda m, x: m.rotate_shift_image(x, angle=-7.0,
                                                                      post_shift=(1.5, -2.0),
                                                                      order=0),
                 get_rotated_clip=lambda m, x: m.get_rotated_clip(x, 10.0, 5.0, 50.0, 120.0, 24,
                                                                  order=0))
    ref = np.asarray(calls[fn](ref_transforms, img))
    out = calls[fn](port_transforms, torch.as_tensor(np.ascontiguousarray(img))).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_estimate_helix_rotation_center_diameter(amyloid):
    rot_r, shift_r, diam_r = ref_analysis.estimate_helix_rotation_center_diameter(amyloid)
    rot_p, shift_p, diam_p = port_analysis.estimate_helix_rotation_center_diameter(amyloid)
    assert diam_p == diam_r
    assert abs(rot_p - rot_r) < 1e-3
    assert abs(shift_p - shift_r) < 1e-3


@pytest.mark.parametrize(
    "tube_diameter,estimated,rise,target_apix3d",
    [(110.0, None, 5.0, -1), (-1, 40, 4.75, -1), (90.0, None, 12.0, 4.0)],
)
def test_task_and_pixel_geometry(tube_diameter, estimated, rise, target_apix3d):
    args = ((64, 256), 2.0, rise, (rise * 0.9, rise), (0.0, 0.0), -1, tube_diameter,
            0.0, 3.0 * rise, -1, target_apix3d, estimated)
    g_r = ref_pipeline.derive_task_geometry(*args)
    g_p = port_pipeline.derive_task_geometry(*args)
    assert g_p == g_r
    assert port_pipeline._pixel_geometry(g_p, (64, 256), rise) == ref_pipeline._pixel_geometry(
        g_r, (64, 256), rise
    )
    assert port_pipeline.auto_sym_oversample(6, 38, 4) == ref_pipeline.auto_sym_oversample(6, 38, 4)


def test_prepare_data_default_path_and_raises(amyloid):
    """The default path is the image as float32; the options no longer
    raise (the chain's parity is test_prepare_data_chain_matches_reference),
    and the result lies on the device asked for."""
    import inspect

    assert inspect.signature(port_pipeline.prepare_data).parameters["device"].default == "cuda"
    out = port_pipeline.prepare_data(amyloid.astype(np.float64), 2.0, device="cpu")
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), ref_pipeline.prepare_data(amyloid, 2.0))
    for kw in (dict(low_pass=10.0), dict(denoise="tv"), dict(transpose=1),
               dict(horizontalize=1)):
        assert port_pipeline.prepare_data(amyloid, 2.0, device="cpu", **kw).ndim == 2


def _max_rel(out, ref):
    return float(np.abs(np.asarray(out) - np.asarray(ref)).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape,low,high", [((64, 256), 0.4, 2.0 / 256), ((31, 50), 0.25, 0.0),
                                            ((12, 14, 17), 0.3, 0.1), ((12, 14, 16), 0.0, 0.2)])
def test_low_high_pass_filter(shape, low, high):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = np.asarray(ref_filters.low_high_pass_filter(x, low, high))
    assert _max_rel(port_filters.low_high_pass_filter(torch.from_numpy(x), low, high).numpy(),
                    ref) < 1e-5


@pytest.mark.parametrize("low_pass", [-1, 2.0, 4.0])
def test_prepare_data_low_pass_no_op_range(amyloid, low_pass):
    """low_pass <= 2 apix leaves the image as it is, as in the reference."""
    out = port_pipeline.prepare_data(amyloid, 2.0, low_pass=low_pass, device="cpu").numpy()
    np.testing.assert_array_equal(out, amyloid)
    np.testing.assert_array_equal(out, ref_pipeline.prepare_data(amyloid, 2.0, low_pass=low_pass))


def _noisy(shape, seed=0):
    rng = np.random.default_rng(seed)
    base = np.outer(np.hanning(shape[0]), np.hanning(shape[1]))
    return (base + 0.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("method,shape,tol", [
    ("tv", (30, 50), 1e-5), ("wavelet", (27, 41), 1e-5),
    # an even element count: the MAD's median averages the two middle values
    ("wavelet", (32, 64), 1e-5), ("nl_means", (24, 30), 1e-4), ("nl_mean", (20, 20), 1e-4),
])
def test_denoise_matches_reference(method, shape, tol):
    x = _noisy(shape)
    with jax.disable_jit():
        ref = np.asarray(ref_denoise.denoise_image(x, method))
    out = port_denoise.denoise_image(torch.from_numpy(x), method)
    assert out.dtype == torch.float32
    assert _max_rel(out.numpy(), ref) < tol


def test_wavelet_median_averages_middle_values():
    v = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(port_denoise._median(v)) == 2.5 == float(np.median(v.numpy()))


def test_denoise_unknown_method_warns_and_returns_image(caplog):
    x = _noisy((8, 8))
    out = port_denoise.denoise_image(torch.from_numpy(x), "bilateral")
    np.testing.assert_array_equal(out.numpy(), x)
    assert "unknown denoise method" in caplog.text


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("kw", [dict(angle=3.0), dict(angle=-7.3, post_shift=(2.5, 0)),
                                dict(angle=1.0, pre_shift=(1.2, -0.7), rotation_center=(30, 100)),
                                dict()])
def test_rotate_shift_image(amyloid, order, kw):
    ref = np.asarray(ref_transforms.rotate_shift_image(amyloid, order=order, **kw))
    out = port_transforms.rotate_shift_image(torch.from_numpy(amyloid), order=order, **kw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("transposed", [False, True])
def test_is_vertical(amyloid, transposed):
    img = amyloid.T.copy() if transposed else amyloid
    assert port_orient.is_vertical(torch.from_numpy(img)) == ref_orient.is_vertical(img)
    assert port_orient.is_vertical(torch.from_numpy(img)) == transposed


@pytest.mark.parametrize("angle", [3.0, -5.0])
def test_auto_horizontalize(amyloid, angle):
    """The Nelder-Mead search follows float values, so the angle and shift
    are compared at the scale of its xtol."""
    img = np.array(ref_transforms.rotate_shift_image(amyloid, angle=angle))
    ref, th_r, sy_r = ref_orient.auto_horizontalize(img, refine=True)
    out, th_p, sy_p = port_orient.auto_horizontalize(torch.from_numpy(img), refine=True)
    assert abs(th_p - th_r) < 1e-2 and abs(sy_p - sy_r) < 1e-2, (th_p, th_r, sy_p, sy_r)
    assert _max_rel(out.numpy(), ref) < 1e-3


def test_prepare_data_chain_matches_reference(amyloid):
    """low-pass, tv denoise, transpose of a vertical filament and the
    refined horizontalize, in the reference's order."""
    img = amyloid.T.copy()
    kw = dict(low_pass=10.0, denoise="tv", transpose=-1, horizontalize=1)
    with jax.disable_jit():
        ref = ref_pipeline.prepare_data(img, 2.0, **kw)
    out = port_pipeline.prepare_data(img, 2.0, device="cpu", **kw).numpy()
    assert out.shape == ref.shape == amyloid.shape
    assert _max_rel(out, ref) < 1e-3
