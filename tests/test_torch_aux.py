"""The rest of the core array functions and the host modules of the
PyTorch port against the JAX package on the same seeded numpy inputs:
core.rotation.apply_rotation and core.interp's two gathers (float32,
tolerance at each test), and the host copies gauss, point_group, euler
and angular (equal results)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from helicon_tpu import angular as ref_angular
from helicon_tpu import euler as ref_euler
from helicon_tpu import gauss as ref_gauss
from helicon_tpu import point_group as ref_pg
from helicon_tpu.core import interp as ref_interp
from helicon_tpu.core import rotation as ref_rotation
from helicon_tpu_torch import angular, euler, gauss, point_group
from helicon_tpu_torch.core import interp, rotation


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_apply_rotation_matches_reference(inverse, stacked):
    """Within 1e-6 (float32 products of unit-scale vectors)."""
    rng = np.random.default_rng(0)
    angles = rng.uniform(-180, 180, (5, 3)).astype(np.float32)
    mats = np.asarray(ref_rotation.euler_matrix("ZYZ", angles if stacked else angles[0]))
    if not stacked:
        mats = mats.reshape(3, 3)
    vecs = rng.standard_normal((5, 7, 3) if stacked else (11, 3)).astype(np.float32)
    if stacked:
        mats = mats[:, None]  # (5, 1, 3, 3) against (5, 7, 3): one matrix a row
        vecs = vecs[..., None, :]
    want = np.asarray(ref_rotation.apply_rotation(jnp.asarray(mats), jnp.asarray(vecs), inverse))
    got = rotation.apply_rotation(torch.from_numpy(mats), torch.from_numpy(vecs), inverse)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_gathers_match_reference():
    """Bilinear and trilinear samples with a fill value, past both edges,
    within 1e-6 (the reference's jitted gather fuses its multiply-adds)."""
    rng = np.random.default_rng(1)
    img = rng.random((17, 23)).astype(np.float32)
    yy = rng.uniform(-2, 19, (40,)).astype(np.float32)
    xx = rng.uniform(-2, 25, (40,)).astype(np.float32)
    want = np.asarray(ref_interp.linear_gather_2d(img, yy, xx, fill=-1.0))
    got = interp.linear_gather_2d(torch.from_numpy(img), yy, xx, fill=-1.0)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    vol = rng.random((9, 11, 13)).astype(np.float32)
    zz, yy, xx = (rng.uniform(-1.5, n + 0.5, (6, 7)).astype(np.float32) for n in vol.shape)
    want = np.asarray(ref_interp.trilinear_gather_3d(vol, zz, yy, xx, fill=2.0))
    got = interp.trilinear_gather_3d(torch.from_numpy(vol), zz, yy, xx, fill=2.0)
    assert np.abs(got.numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("model", [
    lambda m: m.IsotropicGaussian(center=(1.5, -2.0), sigma=2.0, amplitude=3.0),
    lambda m: m.AnisotropicGaussian(center=(0.0, 3.0), sigmas=(1.0, 4.0), rotation=30.0),
    lambda m: m.IsotropicGaussianSet([m.IsotropicGaussian(sigma=2.0),
                                      m.IsotropicGaussian(center=(3, 3), sigma=1.0)]),
    lambda m: m.AnisotropicGaussianSet([m.AnisotropicGaussian(sigmas=(2.0, 1.0), rotation=-15),
                                        m.AnisotropicGaussian(amplitude=2.0)]),
])
def test_gaussians_match_reference(model):
    for shape, apix in (((32, 32), 1.0), ((24, 40), 1.7)):
        np.testing.assert_array_equal(model(gauss).evaluate(shape, apix),
                                      model(ref_gauss).evaluate(shape, apix))


SYMBOLS = ["C1", "C5", "c2", "D3", "T", "O", "I", "I2", "I_3z2y"]


@pytest.mark.parametrize("symbol", SYMBOLS)
def test_point_group_matches_reference(symbol):
    got, want = point_group.PointGroup(symbol), ref_pg.PointGroup(symbol)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.matrices, want.matrices)
    rng = np.random.default_rng(2)
    p1, p2 = rng.standard_normal((6, 3)), rng.standard_normal((6, 3))
    for metric in ("mse", "rmse", "max"):
        assert got.distance_of_points(p1, p2, metric) == want.distance_of_points(p1, p2, metric)
    assert got.distance_of_points(p1[0], p2[0]) == want.distance_of_points(p1[0], p2[0])
    r1 = Rotation.from_euler("ZYZ", rng.uniform(-180, 180, (4, 3)), degrees=True)
    r2 = Rotation.from_euler("ZYZ", rng.uniform(-180, 180, (4, 3)), degrees=True)
    for metric in ("geodesic", "chordal"):
        assert got.distance_of_rotations(r1, r2, metric) == \
            want.distance_of_rotations(r1, r2, metric)


def test_point_group_conventions_and_errors_match_reference():
    for a, b in (("I_5z2x", "I_2z2x5y"), ("I1", "I4"), ("I_3z2y", "I3")):
        np.testing.assert_array_equal(
            point_group.PointGroup.get_icosahedral_conversion_rotation(a, b).as_matrix(),
            ref_pg.PointGroup.get_icosahedral_conversion_rotation(a, b).as_matrix())
    for bad in ("X2", "I_9z", "!"):
        with pytest.raises(ValueError) as want:
            ref_pg.PointGroup(bad)
        with pytest.raises(ValueError) as got:
            point_group.PointGroup(bad)
        assert str(got.value) == str(want.value)


def test_angular_matches_reference():
    rng = np.random.default_rng(3)
    a1, a2 = rng.uniform(-720, 720, 50), rng.uniform(-720, 720, 50)
    for period in (360, 180):
        np.testing.assert_array_equal(angular.angular_difference(a1, a2, period),
                                      ref_angular.angular_difference(a1, a2, period))
    rot, tilt, psi = rng.uniform(-180, 180, (3, 20))
    for fn in ("euler_relion2eman", "euler_eman2relion"):
        np.testing.assert_array_equal(getattr(angular, fn)(rot, tilt, psi),
                                      getattr(ref_angular, fn)(rot, tilt, psi))
    for fn in ("eman_euler2quaternion", "relion_euler2quaternion"):
        np.testing.assert_array_equal(getattr(angular, fn)(rot, tilt, psi),
                                      getattr(ref_angular, fn)(rot, tilt, psi))
    q = ref_angular.relion_euler2quaternion(rot, tilt, psi)
    for conv in ("relion", "eman"):
        np.testing.assert_array_equal(angular.quaternion2euler(q, conv),
                                      ref_angular.quaternion2euler(q, conv))
    with pytest.raises(ValueError):
        angular.quaternion2euler(q, "spider")
    w = rng.random(20)
    np.testing.assert_array_equal(angular.average_quaternions(q, w),
                                  ref_angular.average_quaternions(q, w))
    for kw in (dict(), dict(weights=w), dict(return_quaternion=True)):
        np.testing.assert_array_equal(angular.average_relion_eulers(rot, tilt, psi, **kw),
                                      ref_angular.average_relion_eulers(rot, tilt, psi, **kw))
    r1, r2 = Rotation.from_quat(q[0, [1, 2, 3, 0]]), Rotation.from_quat(q[1, [1, 2, 3, 0]])
    assert angular.angular_distance(r1, r2) == ref_angular.angular_distance(r1, r2)
    for v in (-190.0, 45.0, 400.0, np.array([-190.0, 200.0, 30.0])):
        np.testing.assert_array_equal(angular.set_angle_range(v), ref_angular.set_angle_range(v))
    assert angular.set_to_periodic_range(-200.0) == ref_angular.set_to_periodic_range(-200.0)


def test_euler_reexports():
    names = [n for n in dir(ref_euler) if not n.startswith("_") and n != "annotations"]
    assert names and all(getattr(euler, n) is getattr(angular, n) for n in names)
