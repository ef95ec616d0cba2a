"""The adaptive 3D mask chain of trueFSC in the PyTorch port
(helicon_tpu_torch/core/mask3d.py) against the JAX package's
(helicon_tpu/core/mask3d.py) on the same seeded numpy volumes (24-40
voxels a side, some odd): masks equal as booleans, levels and distances
within 1e-6, adaptive_mask_3d in its four threshold modes, its fallback,
and a tie at the 1,000th seed."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu.core import mask3d as ref
from helicon_tpu_torch.core import mask3d


def _blobs(shape, centers, r=3.0, amps=None, noise=0.0, seed=0):
    g = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    v = np.zeros(shape)
    for i, c in enumerate(centers):
        a = 1.0 if amps is None else amps[i]
        v += a * np.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) / (2 * r * r))
    return (v + noise * g.normal(size=shape)).astype(np.float32)


def _close(got, want, tol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= tol, err


SHAPES = [(24, 24, 24), (25, 27, 29)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.0, 1.3, 3.0])
def test_gaussian_lowpass_3d_matches_reference(shape, sigma):
    v = _blobs(shape, [(8, 9, 10), (16, 15, 20)], noise=0.3, seed=1)
    _close(mask3d.gaussian_lowpass_3d(torch.as_tensor(v), sigma),
           ref.gaussian_lowpass_3d(v, sigma))


@pytest.mark.parametrize("ignore_zero", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_otsu_threshold_3d_matches_reference(shape, ignore_zero):
    v = _blobs(shape, [(8, 9, 10), (16, 15, 20)], noise=0.05, seed=2)
    v[:3] = 0.0  # exact zeros, dropped when ignore_zero
    got = mask3d.otsu_threshold_3d(torch.as_tensor(v), ignore_zero=ignore_zero)
    want = ref.otsu_threshold_3d(v, ignore_zero=ignore_zero)
    assert got.dtype == torch.float32
    _close(got, want)


def test_otsu_bins_saturate_as_the_reference():
    """A bin of more than 2^24 voxels: the reference adds float32 ones into
    its histogram, so the bin stops at 2^24 (1 + 2^24 rounds back). Here
    the solvent bin holds 2^24 + 500,000 voxels, and two smaller modes sit
    where the saturated count moves the Otsu level from above the solvent
    to above the second mode (found by a search over the modes' sizes;
    the two levels' variances differ by ~4e-5 relative, far above float32
    rounding). The port's level is the reference's."""
    counts = {10: 2**24 + 500_000, 120: 530_000, 250: 1_204_000}
    v = np.concatenate([np.float32([1e-6, 1.0])] + [
        np.full(n, (b + 0.5) / 256, np.float32) for b, n in counts.items()])
    want = ref.otsu_threshold_3d(v.reshape(-1, 1, 1))
    got = mask3d.otsu_threshold_3d(torch.from_numpy(v).reshape(-1, 1, 1))
    assert abs(float(want) - 121 / 256) < 1e-3  # the saturated count's level
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_grow_from_seeds_matches_reference(shape):
    g = np.random.default_rng(3)
    above = g.random(shape) > 0.62
    seeds = np.zeros(shape, np.float32)
    seeds.flat[g.choice(above.size, 6, replace=False)] = 1.0
    want = np.asarray(ref.grow_from_seeds(above, seeds))
    got = mask3d.grow_from_seeds(torch.as_tensor(above), torch.as_tensor(seeds))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_iters", [5, 13, 16])
def test_grow_from_seeds_cap_matches_reference(max_iters, monkeypatch):
    """A serpentine path longer than the cap: the growth stops after exactly
    max_iters dilations whatever the host's check interval."""
    shape = (5, 24, 25)
    above = np.zeros(shape, bool)
    above[2, ::4, :] = True
    for i, row in enumerate(range(0, 24, 4)):
        above[2, row:row + 5, 24 if i % 2 == 0 else 0] = True
    seeds = np.zeros(shape, np.float32)
    seeds[2, 0, 0] = 1.0
    want = np.asarray(ref.grow_from_seeds(above, seeds, max_iters=max_iters))
    for every in (1, 3, 8):
        monkeypatch.setattr(mask3d, "GROW_CHECK_EVERY", every)
        got, iters = mask3d._grow(torch.as_tensor(above), torch.as_tensor(seeds), max_iters)
        np.testing.assert_array_equal(got.numpy(), want)
        assert iters == max_iters
    assert want.sum() < above.sum()


@pytest.fixture(scope="module")
def grow_line():
    """A 1 x 18 line seeded at its 8th voxel, and the reference's growths
    capped at 0-12 dilations."""
    shape = (5, 24, 25)
    above = np.zeros(shape, bool)
    above[2, 3, 2:20] = True
    seeds = np.zeros(shape, np.float32)
    seeds[2, 3, 9] = 1.0
    runs = [np.asarray(ref.grow_from_seeds(above, seeds, max_iters=k)) for k in range(13)]
    return above, seeds, runs


@pytest.mark.parametrize("every", [1, 3, 8])
def test_grow_count_is_the_reference_loops(grow_line, every, monkeypatch):
    """_grow's count is the reference loop's: the fixpoint's dilations plus
    the one that changed nothing, whatever the host's check interval. The
    reference's count is the least k whose growth equals k - 1's."""
    above, seeds, runs = grow_line
    want = next(k for k in range(1, 13) if np.array_equal(runs[k], runs[k - 1]))
    monkeypatch.setattr(mask3d, "GROW_CHECK_EVERY", every)
    got, iters = mask3d._grow(torch.as_tensor(above), torch.as_tensor(seeds))
    np.testing.assert_array_equal(got.numpy(), runs[-1])
    assert want == 11 and iters == want


@pytest.mark.parametrize("cap", [None, 3.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_euclidean_distance_outside_matches_reference(shape, cap):
    m = np.random.default_rng(4).random(shape) > 0.985
    want = np.asarray(ref.euclidean_distance_outside(m, cap=cap))
    got = mask3d.euclidean_distance_outside(torch.as_tensor(m), cap=cap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [0.0, 2.5, 6.0, np.float64(4.37)])
def test_soft_cosine_mask_matches_reference(width):
    m = _blobs((25, 27, 29), [(12, 13, 14)]) > 0.5
    _close(mask3d.soft_cosine_mask(torch.as_tensor(m), width), ref.soft_cosine_mask(m, width))


def _check_adaptive(v, **kw):
    want_mask, want_level, want_lp = ref.adaptive_mask_3d(v, **kw)
    mask, level, v_lp = mask3d.adaptive_mask_3d(torch.as_tensor(v), **kw)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    _close(level, want_level)
    _close(v_lp, want_lp)
    return mask.numpy()


ADAPTIVE = dict(
    otsu=dict(),
    fraction=dict(thresh_fraction=0.3, thresh_absolute=0.05, mass_kda=1.0),
    absolute=dict(thresh_absolute=0.2, mass_kda=1.0),
    mass=dict(mass_kda=2.5),
)


@pytest.mark.parametrize("mode", sorted(ADAPTIVE))
@pytest.mark.parametrize("shape", [(32, 32, 32), (31, 33, 35)])
def test_adaptive_mask_3d_matches_reference(mode, shape):
    v = _blobs(shape, [(10, 10, 12), (20, 22, 22), (8, 25, 6)], amps=[1.0, 0.8, 0.3],
               noise=0.05, seed=5)
    mask = _check_adaptive(v, apix=1.2, cutoff_res=6.0, **ADAPTIVE[mode])
    assert 0 < mask.sum() < mask.size


def test_adaptive_mask_3d_seed_tie():
    """1,200 voxels of the low-index component and 500 of the high-index one
    tie at the maximum: jax.lax.top_k takes the 1,000 seeds from the lower
    flat indices, so only the first component grows."""
    v = np.zeros((24, 30, 31), np.float32)
    v[1:5, 2:17, 2:22] = 5.0  # 4 x 15 x 20 = 1,200 voxels
    v[14:19, 5:15, 10:20] = 5.0  # 5 x 10 x 10 = 500 voxels
    v[20, 25, 25] = 1.0
    mask = _check_adaptive(v, apix=1.0, cutoff_res=1.5, thresh_absolute=0.5)
    assert mask[1:5, 2:17, 2:22].all() and not mask[14:19, 5:15, 10:20].any()


def test_adaptive_mask_3d_falls_back_to_threshold():
    """A level above every seed grows nothing: the mask is the threshold's."""
    v = _blobs((24, 25, 26), [(12, 12, 12)], noise=0.01, seed=6)
    mask = _check_adaptive(v, apix=1.0, cutoff_res=1.5, thresh_absolute=50.0)
    assert not mask.any()
