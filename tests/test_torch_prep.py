"""The PyTorch port's image prep chain against the JAX package: cubic
down-scaling, rotation, map_coordinates, the helix diameter estimator and
the size bookkeeping, on the committed amyloid class average."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from helicon_tpu.core import analysis as ref_analysis
from helicon_tpu.core import filters as ref_filters
from helicon_tpu.core import interp as ref_interp
from helicon_tpu.core import transforms as ref_transforms
from helicon_tpu.denovo3d import pipeline as ref_pipeline
from helicon_tpu_torch.core import analysis as port_analysis
from helicon_tpu_torch.core import filters as port_filters
from helicon_tpu_torch.core import interp as port_interp
from helicon_tpu_torch.core import transforms as port_transforms
from helicon_tpu_torch.denovo3d import pipeline as port_pipeline

AMYLOID = pathlib.Path(__file__).parent / "data" / "class_avg_amyloid.npy"


@pytest.fixture(scope="module")
def amyloid():
    return np.load(AMYLOID).astype(np.float32)


@pytest.mark.parametrize("target_apix", [4.0, 3.0])
def test_down_scale(amyloid, target_apix):
    ref = np.asarray(ref_filters.down_scale(amyloid, target_apix, 2.0))
    out = port_filters.down_scale(amyloid, target_apix, 2.0).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_down_scale_same_pixel_size_is_identity(amyloid):
    np.testing.assert_array_equal(port_filters.down_scale(amyloid, 2.0, 2.0).numpy(), amyloid)


@pytest.mark.parametrize("rotation", [7.5, -31.0])
def test_transform_image_rotation(amyloid, rotation):
    ref = np.asarray(ref_transforms.transform_image(amyloid, rotation=rotation))
    out = port_transforms.transform_image(amyloid, rotation=rotation).numpy()
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
    with pytest.raises(NotImplementedError):
        port_interp.map_coordinates(torch.zeros(4, 4), (torch.zeros(2), torch.zeros(2)), order=0)


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
    out = port_pipeline.prepare_data(amyloid.astype(np.float64), 2.0)
    np.testing.assert_array_equal(out, ref_pipeline.prepare_data(amyloid, 2.0))
    for kw in (dict(low_pass=10.0), dict(denoise="nl_mean"), dict(transpose=1),
               dict(horizontalize=1)):
        with pytest.raises(NotImplementedError):
            port_pipeline.prepare_data(amyloid, 2.0, **kw)
