"""The core functions the denovo3D web app calls, in the PyTorch port,
against the JAX package on the same numpy inputs (those of
tests/test_transforms.py and tests/test_filters.py, volumes of at most
32^3): euler_matrix, apply_helical_symmetry, transform_map, the centre
crops, threshold_data, phase_cross_correlation and the orient helpers."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from helicon_tpu.core import alignment as ref_align
from helicon_tpu.core import filters as ref_filters
from helicon_tpu.core import rotation as ref_rot
from helicon_tpu.core import transforms as ref_tf
from helicon_tpu.helix import orient as ref_orient
from helicon_tpu_torch.core import alignment, filters, rotation, transforms
from helicon_tpu_torch.helix import orient


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("seq,angles", [("ZYZ", (20.0, 10.0, -15.0)), ("zyz", (20.0, 10.0, -15.0)),
                                        ("YX", (3.0, -1.0)), ("z", (123.4,))])
def test_euler_matrix_matches_reference(seq, angles):
    got = rotation.euler_matrix(seq, angles, device="cpu").numpy()
    want = np.asarray(ref_rot.euler_matrix(seq, jnp.asarray(angles, jnp.float32)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    for f, rf in ((rotation.rot_x, ref_rot.rot_x), (rotation.rot_y, ref_rot.rot_y),
                  (rotation.rot_z, ref_rot.rot_z)):
        np.testing.assert_allclose(f(angles[0], device="cpu").numpy(), np.asarray(rf(angles[0])),
                                   atol=1e-6)


def test_euler_matrix_mixed_case_raises():
    with pytest.raises(ValueError):
        rotation.euler_matrix("Zy", (1.0, 2.0), device="cpu")


# (data maker, keyword arguments): the inputs of tests/test_transforms.py's
# TestApplyHelicalSymmetry, and csym / fraction / an amyloid-like rise
SYM_CASES = dict(
    same_size=(lambda r: r.normal(size=(16, 12, 12)).astype(np.float32) ** 2,
               dict(apix=2.0, twist_degree=29.7, rise_angstrom=6.1, csym=2,
                    new_size=(16, 12, 12), new_apix=2.0)),
    resample=(lambda r: r.uniform(size=(12, 10, 10)).astype(np.float32),
              dict(apix=1.5, twist_degree=-12.0, rise_angstrom=4.75, csym=1,
                   new_size=(20, 14, 14), new_apix=1.0)),
    default_size=(lambda r: r.uniform(size=(24, 16, 16)).astype(np.float32),
                  dict(apix=1.0, twist_degree=25.0, rise_angstrom=3.0)),
    csym3_fraction=(lambda r: r.uniform(size=(20, 16, 16)).astype(np.float32),
                    dict(apix=2.0, twist_degree=1.2, rise_angstrom=4.75, csym=3,
                         fraction=0.5)),
    shrink=(lambda r: r.uniform(size=(32, 24, 24)).astype(np.float32),
            dict(apix=2.0, twist_degree=-1.0, rise_angstrom=4.75, csym=1,
                 new_size=(31, 21, 21), new_apix=2.5)),
)


@pytest.mark.parametrize("name", sorted(SYM_CASES))
def test_apply_helical_symmetry_matches_reference(name, monkeypatch):
    make, kw = SYM_CASES[name]
    data = make(np.random.default_rng(42))
    want = np.asarray(ref_tf.apply_helical_symmetry(data, **kw))
    got = transforms.apply_helical_symmetry(data, device="cpu", **kw)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) < 1e-5
    # the copies run in chunks: one copy a chunk gives the same volume
    monkeypatch.setattr(transforms, "SYM_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(
        transforms.apply_helical_symmetry(data, device="cpu", **kw).numpy(), got.numpy())


def test_apply_helical_symmetry_sparse_source():
    """The verify-skill example: a source spanning a few z-slices."""
    vol = np.zeros((48, 32, 32), np.float32)
    vol[22:27, 16, 24] = 100.0
    kw = dict(apix=1.0, twist_degree=23.7, rise_angstrom=4.75, csym=2, new_size=(48, 32, 32),
              new_apix=1.0)
    got = transforms.apply_helical_symmetry(vol, device="cpu", **kw)
    want = np.asarray(ref_tf.apply_helical_symmetry(vol, **kw))
    assert _rel(got, want) < 1e-5 and float(got.max()) > 0


TRANSFORM_CASES = dict(
    rot_tilt_psi_shift=dict(rot=20, tilt=10, psi=-15, dx=1, dy=-2, dz=0.5),
    scale=dict(scale=1.1, rot=5),
    tilt_dy=dict(tilt=3.0, dy=0.75),
    psi=dict(psi=7.5),
)


@pytest.mark.parametrize("name", sorted(TRANSFORM_CASES))
def test_transform_map_matches_reference(name):
    data = np.random.default_rng(42).normal(size=(12, 14, 16)).astype(np.float32)
    kw = TRANSFORM_CASES[name]
    got = transforms.transform_map(data, device="cpu", **kw)
    want = np.asarray(ref_tf.transform_map(data, **kw))
    assert _rel(got, want) < 1e-4


def test_transform_map_identity():
    data = np.random.default_rng(42).normal(size=(8, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(transforms.transform_map(data, device="cpu").numpy(), data)


@pytest.mark.parametrize("shape,offset", [((4, 6), None), ((4, 6), (1, -2)), ((10, 12), None),
                                          ((4, 4, 4), (1, 0, -1)), ((5, 3, 7), None)])
def test_crop_center_matches_reference(shape, offset):
    data = np.random.default_rng(42).normal(size=(10, 12) if len(shape) == 2 else (8, 8, 9))
    want = ref_tf.crop_center(data, shape, center_offset=offset)
    np.testing.assert_array_equal(transforms.crop_center(data, shape, center_offset=offset), want)
    np.testing.assert_array_equal(
        transforms.crop_center(torch.as_tensor(data), shape, center_offset=offset).numpy(), want)


@pytest.mark.parametrize("n", [2, 3, 6])
def test_crop_center_z_matches_reference(n):
    data = np.random.default_rng(42).normal(size=(10, 3, 3))
    np.testing.assert_array_equal(transforms.crop_center_z(data, n), ref_tf.crop_center_z(data, n))


@pytest.mark.parametrize("kw", [dict(thresh_fraction=0.5), dict(thresh_value=0.2),
                                dict(thresh_fraction=-1, thresh_value=0.2), dict()])
def test_threshold_data_matches_reference(kw):
    x = np.random.default_rng(42).normal(size=(16, 16)).astype(np.float32)
    got = filters.threshold_data(torch.as_tensor(x), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_filters.threshold_data(x, **kw)))


@pytest.mark.parametrize("shift", [(-5, 3), (7, -12), (0, 0), (32, 31)])
def test_phase_cross_correlation_matches_reference(shift):
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((64, 64)).astype(np.float32)
    mov = np.roll(np.roll(ref, shift[0], axis=0), shift[1], axis=1)
    got, _, _ = alignment.phase_cross_correlation(ref, mov, device="cpu")
    want, _, _ = ref_align.phase_cross_correlation(ref, mov)
    np.testing.assert_array_equal(got, want)


def test_orient_helpers_match_reference():
    rng = np.random.default_rng(3)
    vol = rng.uniform(size=(20, 16, 16)).astype(np.float32)
    for kw in (dict(), dict(is_amyloid=True, apix=1.5)):
        for g, w in zip(orient.generate_xyz_projections(vol, device="cpu", **kw),
                        ref_orient.generate_xyz_projections(vol, **kw)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
    kw = dict(apix=2.0, twist_degree=29.4, rise_angstrom=4.75, csym=1, new_size=(24, 20, 20),
              new_apix=2.5, axial_rotation=5.0, tilt=2.0)
    got = orient.symmetrize_transform_map(vol, device="cpu", **kw)
    want = np.asarray(ref_orient.symmetrize_transform_map(vol, **kw))
    assert got.shape == want.shape and _rel(got, want) < 1e-4
    for args in ((0, 0, 0), (2.345, -1.0, 0.5), (0, 3, 0)):
        for kw in (dict(), dict(sep=",", sep2=":", unit=False)):
            assert orient.tilt_psi_dy_str(*args, **kw) == ref_orient.tilt_psi_dy_str(*args, **kw)
