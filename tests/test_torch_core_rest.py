"""The rest of the core array functions in the PyTorch port against the
JAX package on the same numpy inputs: the structural factors, the
normalizations and the cosine taper (core/filters), is_3d, twist2pitch,
the float image scores, the correlations, the elbow and the line fit
(core/analysis), get_rotated_clip and the meridian phase difference
(core/transforms), the interpolation modes transform_image maps onto, and
align_images (core/alignment). Tolerances are stated at each test:
1e-5 relative to the reference's peak for maps, 1e-6 for scores."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.core import alignment as ref_align
from helicon_tpu.core import analysis as ref_an
from helicon_tpu.core import filters as ref_filters
from helicon_tpu.core import transforms as ref_tf
from helicon_tpu_torch.core import alignment, analysis, filters, transforms


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _blobs(shape, seed=0):
    g = np.random.default_rng(seed)
    grids = np.meshgrid(*(np.arange(n) - n / 2 for n in shape), indexing="ij")
    v = np.zeros(shape)
    for c in g.uniform(-3, 3, size=(4, len(shape))):
        v += np.exp(-sum((x - ci) ** 2 for x, ci in zip(grids, c)) / 8.0)
    return (v + 0.05 * g.normal(size=shape)).astype(np.float32)


# --------------------------------------------------------------------------
# filters
# --------------------------------------------------------------------------

SF_CASES = dict(
    map3d=((20, 20, 20), 1.5, dict()),
    image2d=((24, 30), 1.0, dict()),
    thresh=((16, 18, 20), 2.0, dict(thresh=0.3)),
    mask=((20, 20, 20), 1.5, dict(mask=True)),
)


def _sf_args(shape, kw, seed=0):
    kw = dict(kw)
    if kw.get("mask"):
        kw["mask"] = (_blobs(shape, seed + 7) > 0.2).astype(np.float32)
    return kw


@pytest.mark.parametrize("name", sorted(SF_CASES))
def test_calculate_structural_factor_matches_reference(name):
    """qbins exactly, the factor and the spectrum at 1e-5 of their peaks."""
    shape, apix, kw = SF_CASES[name]
    data = _blobs(shape)
    kw = _sf_args(shape, kw)
    qb_w, sf_w, F_w = ref_filters.calculate_structural_factor(data, apix, return_fft=True, **kw)
    qb, sf, F = filters.calculate_structural_factor(data, apix, return_fft=True, device="cpu",
                                                    **kw)
    np.testing.assert_array_equal(qb, qb_w)
    assert sf.dtype == torch.float32 and _rel(sf, sf_w) < 1e-5
    assert _rel(torch.view_as_real(F), np.stack([np.real(F_w), np.imag(F_w)], -1)) < 1e-5


@pytest.mark.parametrize("name", sorted(SF_CASES))
def test_set_and_match_structural_factors_match_reference(name):
    """set_ against a target curve, match_ against a second map: 1e-5 of
    the reference map's peak."""
    shape, apix, kw = SF_CASES[name]
    data, target = _blobs(shape, 1), _blobs(shape, 2) * 2.0
    kw = _sf_args(shape, kw)
    tb, tsf = ref_filters.calculate_structural_factor(target, apix * 1.1)
    want = ref_filters.set_structural_factors(data, apix, tb, np.asarray(tsf), **kw)
    got = filters.set_structural_factors(data, apix, tb, np.asarray(tsf), device="cpu", **kw)
    assert _rel(got, want) < 1e-5
    kw_t = {k: v for k, v in kw.items() if k != "thresh"}
    want = ref_filters.match_structural_factors(data, apix, target, apix * 1.1, **kw_t)
    got = filters.match_structural_factors(data, apix, target, apix * 1.1, device="cpu", **kw_t)
    assert _rel(got, want) < 1e-5


NORM_INPUTS = dict(
    random=lambda: _blobs((13, 17), 3) * 5 - 1,
    constant=lambda: np.full((6, 5), 2.5, np.float32),
    volume=lambda: _blobs((8, 9, 10), 4),
)


@pytest.mark.parametrize("name", sorted(NORM_INPUTS))
@pytest.mark.parametrize("fn,kw", [("normalize_min_max", dict()),
                                   ("normalize_min_max", dict(min=-1, max=3)),
                                   ("normalize_mean_std", dict()),
                                   ("normalize_percentile", dict()),
                                   ("normalize_percentile", dict(percentile=(2, 98))),
                                   ("normalize_percentile", dict(percentile=(37.5, 12.5)))])
def test_normalizations_match_reference(name, fn, kw):
    """Each normalization at 1e-6 absolute (outputs of order 1)."""
    data = NORM_INPUTS[name]()
    want = np.asarray(getattr(ref_filters, fn)(data, **kw))
    got = getattr(filters, fn)(torch.as_tensor(data), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("size,start,slope", [((32, 32), (0.8, 0.8), 0.1),
                                              ((31, 40), (0.6, 0.9), 0.05),
                                              ((20, 24), (0.7, 1.0), 0.2),
                                              ((16, 16), (1.0, 0.0), 0.1)])
def test_generate_tapering_filter_matches_reference(size, start, slope):
    """The taper at 1e-6 absolute, float32, on the device asked for."""
    want = np.asarray(ref_filters.generate_tapering_filter(size, start, slope))
    got = filters.generate_tapering_filter(size, start, slope, device="cpu")
    assert got.dtype == torch.float32 and got.shape == size
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# analysis
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 8, 8), (8, 12, 8), (8, 8), (8, 9, 8)])
def test_is_3d_matches_reference(shape):
    x = np.zeros(shape, np.float32)
    assert analysis.is_3d(torch.as_tensor(x)) == ref_an.is_3d(x)


@pytest.mark.parametrize("twist,rise,flag", [(-1.2, 4.75, True), (179.4, 2.38, True),
                                             (-118.8, 1.58, True), (29.7, 6.1, True),
                                             (22.03, 2.91, False), (-0.9, 4.8, True)])
def test_twist2pitch_matches_reference(twist, rise, flag):
    """Exact: the same float64 arithmetic."""
    assert analysis.twist2pitch(twist, rise, flag) == ref_an.twist2pitch(twist, rise, flag)


def _pairs():
    """Pairs of one shape (64 x 64: four scales of ms_ssim), but one
    smaller than the SSIM window."""
    a = _blobs((64, 64), 5)
    return dict(noisy=(a, a + 0.1 * np.random.default_rng(6).normal(size=a.shape)
                       .astype(np.float32)),
                other=(a, _blobs((64, 64), 8)),
                small=(a[:6, :9], a[1:7, :9]),
                constant=(np.ones((64, 64), np.float32), a))


@pytest.mark.parametrize("name", sorted(_pairs()))
@pytest.mark.parametrize("score", ["ssim_score", "ms_ssim_score", "mutual_information_score",
                                   "r_factor_score", "cross_correlation_coefficient"])
def test_float_scores_match_reference(name, score):
    """Python floats at 1e-6 absolute (scores of order 1)."""
    a, b = _pairs()[name]
    want = getattr(ref_an, score)(a, b)
    got = getattr(analysis, score)(torch.as_tensor(a), torch.as_tensor(b))
    assert isinstance(got, float)
    assert abs(got - float(want)) < 1e-6, (got, want)


@pytest.mark.parametrize("score", ["ssim_score", "ms_ssim_score", "mutual_information_score",
                                   "r_factor_score"])
def test_float_scores_shape_mismatch_raises(score):
    a = np.zeros((8, 8), np.float32)
    b = np.zeros((8, 9), np.float32)
    with pytest.raises(ValueError) as want:
        getattr(ref_an, score)(a, b)
    with pytest.raises(ValueError) as got:
        getattr(analysis, score)(torch.as_tensor(a), torch.as_tensor(b))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("a,b", [([1.0, 2.0, 3.0], [2.0, 0.5, -1.0]),
                                 ([0.0, 0.0], [1.0, 2.0]),
                                 ([3.0, -4.0, 1e-3], [3.0, -4.0, 1e-3])])
def test_cosine_similarity_matches_reference(a, b):
    want = ref_an.cosine_similarity(np.float32(a), np.float32(b))
    got = analysis.cosine_similarity(torch.tensor(a), torch.tensor(b))
    assert abs(got - want) < 1e-6


@pytest.mark.parametrize("curve", [np.exp(-np.arange(30) / 4.0),
                                   np.r_[np.linspace(0, 1, 10), np.ones(15)],
                                   np.sort(np.random.default_rng(1).normal(size=50)),
                                   np.arange(5.0)])
def test_find_elbow_point_matches_reference(curve):
    assert analysis.find_elbow_point(torch.as_tensor(curve)) == ref_an.find_elbow_point(curve)


@pytest.mark.parametrize("weighted,ref_i,xy", [(False, 0, False), (True, 3, True),
                                               (False, 7, True)])
def test_line_fit_projection_matches_reference(weighted, ref_i, xy):
    """float64 positions at 1e-12 absolute."""
    g = np.random.default_rng(2)
    t = np.sort(g.uniform(0, 50, 12))
    x, y = 3 + 0.8 * t + g.normal(0, 0.3, 12), -2 + 0.6 * t + g.normal(0, 0.3, 12)
    w = g.uniform(0.5, 2, 12) if weighted else None
    want = ref_an.line_fit_projection(x, y, w=w, ref_i=ref_i, return_xy_fit=xy)
    got = analysis.line_fit_projection(torch.as_tensor(x), torch.as_tensor(y),
                                       w=None if w is None else torch.as_tensor(w), ref_i=ref_i,
                                       return_xy_fit=xy)
    if xy:
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-12, rtol=0)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


# --------------------------------------------------------------------------
# transforms and the interpolation modes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seg,width", [((5.0, 4.0, 30.0, 40.0), 9), ((30.5, 2.0, 3.0, 41.0), 12),
                                       ((10, 10, 10, 45), 7), ((2.0, 44.0, 37.0, 1.5), 16)])
def test_get_rotated_clip_matches_reference(seg, width):
    """The strip at 1e-5 of the image's peak."""
    img = _blobs((40, 48), 11)
    want = np.asarray(ref_tf.get_rotated_clip(img, *seg, width))
    got = transforms.get_rotated_clip(torch.as_tensor(img), *seg, width)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(img).max()


@pytest.mark.parametrize("shape", [(9, 16), (4, 8, 11)])
def test_compute_phase_difference_across_meridian_matches_reference(shape):
    """Degrees at 1e-4 absolute (arccos near 0 and 180 amplifies float32
    rounding to ~1e-5 degrees)."""
    phase = np.random.default_rng(4).uniform(-np.pi, np.pi, shape).astype(np.float32)
    want = np.asarray(ref_tf.compute_phase_difference_across_meridian(phase))
    got = transforms.compute_phase_difference_across_meridian(torch.as_tensor(phase))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["constant", "edge", "symmetric", "reflect", "wrap"])
@pytest.mark.parametrize("kw", [dict(rotation=17.0), dict(scale=1.3, rotation=-40.0),
                                dict(scale=(0.8, 1.1), rotation=5.0, post_translation=(3.0, -7.5)),
                                dict(rotation=95.0, rotation_center=(10.0, 14.0),
                                     pre_translation=(-2.0, 1.5))])
def test_transform_image_matches_reference(mode, kw):
    """The affine warp in each skimage mode at 1e-5 of the image's peak."""
    img = _blobs((28, 34), 12)
    want = np.asarray(ref_tf.transform_image(img, mode=mode, **kw))
    got = transforms.transform_image(torch.as_tensor(img), mode=mode, **kw)
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(img).max()


# --------------------------------------------------------------------------
# alignment
# --------------------------------------------------------------------------

ALIGN_CASES = dict(
    scale_angle=dict(scale_range=0.2, angle_range=10.0),
    angle_only=dict(scale_range=0.0, angle_range=15.0, check_flip=False),
    identity=dict(scale_range=0.0, angle_range=0.0),
    no_flip_no_polarity=dict(scale_range=0.1, angle_range=8.0, check_flip=False,
                             check_polarity=False),
)


@pytest.mark.parametrize("name", sorted(ALIGN_CASES))
def test_align_images_matches_reference(name):
    """A moving image (smaller than the reference: padded) that is the
    reference rotated 6 degrees, scaled 1.05 and shifted. The flip and the
    shift exactly, the score at 1e-6, the scale at 1e-4; the angle within
    0.05 degrees: the bounded angle search stops within its xatol of 0.01
    of a point of a score flat to 1e-7 there, and float32 rounding of the
    score moves that point (0.016 degrees in the angle-only case); the
    aligned raw image at 1e-5 of its peak against the reference's warp at
    the port's pose."""
    kw = dict(ALIGN_CASES[name], return_aligned_moving_image=True)
    ref = _blobs((32, 32), 13)
    mov = np.array(ref_tf.transform_image(ref, scale=1.05, rotation=6.0,
                                          post_translation=(2.0, -3.0)))[3:29, 4:28]
    want = ref_align.align_images(mov, ref, **kw)
    got = alignment.align_images(torch.as_tensor(mov), torch.as_tensor(ref), **kw)
    assert len(got) == len(want)
    if kw.get("check_flip", True):
        assert got[0] == want[0]
        flipped, got, want = got[0], got[1:], want[1:]
    else:
        flipped = False
    scale, angle, shift, score, aligned = got
    assert abs(scale - want[0]) < 1e-4 and abs(angle - want[1]) < 0.05
    np.testing.assert_array_equal(shift, want[2])
    assert abs(score - want[3]) < 1e-6
    padded = np.asarray(ref_tf.pad_to_size(mov[::-1] if flipped else mov, ref.shape))
    at_pose = np.asarray(ref_tf.transform_image(padded, scale=scale, rotation=angle,
                                                post_translation=shift, mode="wrap"))
    assert np.abs(aligned.numpy() - at_pose).max() < 1e-5 * np.abs(at_pose).max()
