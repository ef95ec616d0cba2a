"""The PyTorch port's bucketed search on the wide-rise grid of
tests/test_denovo3d_pipeline.py (rises 4-20 A: three rise buckets, then a
second pass of one candidate per twist, which both packages score on their
per-candidate paths) against the JAX package, and the two places where
the port's groups of one (forced with HELICON_GRID_GROUPED=1) and the
reference differ (ROADMAP C1 and C11).

The JAX searches run under jax.disable_jit() with one device, as in
tests/test_torch_grid.py. An eager JAX search costs seconds per twist
group, so the tests reuse the module fixture's second-pass calls where they
can: a group's score depends only on its own twist and the call's rises.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.denovo3d import grid as ref_grid
from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu.helix import simulate_helical_projection as ref_simulate
from helicon_tpu_torch.denovo3d import projector_separable as port_ps
from helicon_tpu_torch.denovo3d import reconstruct_grid


def _ref(image, tw, ri, **kw):
    with jax.disable_jit():
        return ref_reconstruct_grid(image, twists=tw, rises=ri, devices=jax.devices()[:1], **kw)


def _port(image, tw, ri, **kw):
    return reconstruct_grid(image, twists=tw, rises=ri, device="cpu", **kw)


def _wide_rise_image():
    return np.array(ref_simulate(
        n=1, twist=30.0, rise=6.0, csym=1, helical_diameter=40.0, ball_radius=5.0, polymer=0,
        planarity=1.0, ny=48, nx=96, apix=2.0, rng=0), np.float32)


WIDE_KW = dict(apix=2.0, tube_diameter=44.0, reconstruct_length_rise=3.0, sym_oversample=2,
               compute_dtype="float32", return_best_volume=False)
TWISTS = np.float32([30.1, 55.0])


@pytest.fixture(scope="module")
def wide_rise():
    """The wide-rise grid with its twist 30 moved to 30.1
    (test_half_way_ties_at_twist_30) and eight power iterations. Every
    candidate lies in its bucket's top 10, so each final score is that of
    the second-pass call at its own rise: twists TWISTS, one candidate
    each."""
    image = _wide_rise_image()
    tw = np.repeat(TWISTS, 4)
    ri = np.tile(np.float32([4.0, 6.0, 8.0, 20.0]), 2)
    kw = dict(WIDE_KW, cg_iters=10, fista_iters=16, power_iters=8)
    return image, tw, ri, _port(image, tw, ri, **kw), _ref(image, tw, ri, **kw)


def _at_rise(res, ri, rise):
    return res.scores[ri == rise]


def test_bucketed_wide_rise_grid_matches_reference(wide_rise):
    _, _, ri, port, ref = wide_rise
    np.testing.assert_allclose(port.scores, ref.scores, rtol=0, atol=1e-4)
    assert port.best_index == ref.best_index
    assert port.effective["n_buckets"] == len(ref_grid._rise_buckets(ri, 1.6)) == 3
    assert port.geom == port.geom.__class__(**ref.geom.__dict__)


def test_second_pass_goes_per_candidate(wide_rise):
    """The second pass's calls hold one candidate per twist, so both
    packages score them on the per-candidate path (the winner's call is
    the bucketed result's)."""
    _, _, _, port, ref = wide_rise
    assert port.effective["path"] == ref.effective["path"] == "percand"


def test_power_seed_moves_groups_of_one(wide_rise, monkeypatch):
    """ROADMAP C1 on groups of one, forced with HELICON_GRID_GROUPED=1: one
    candidate per twist at the wide-rise grid's longest rise, each package
    on its grouped path. The reference's XLA paths start the power
    iteration from ones; B1 and its plain version start from the rhs. At
    two power iterations the scores differ by more than 1e-4; at eight by
    less."""
    image = wide_rise[0]
    monkeypatch.setenv("HELICON_GRID_GROUPED", "1")
    rises = np.float32([20.0, 20.0])
    d = {}
    for power in (2, 8):
        kw = dict(WIDE_KW, cg_iters=10, fista_iters=16, power_iters=power)
        port, ref = _port(image, TWISTS, rises, **kw), _ref(image, TWISTS, rises, **kw)
        assert port.effective["path"] == "grouped" and port.effective["R"] == 1
        d[power] = float(np.abs(port.scores - ref.scores).max())
    assert d[2] > 1e-4 > d[8], d


def _jax_cos_sin(theta):
    """XLA's float32 cos and sin of the port's angles (for C11's test)."""
    t = jnp.asarray(theta.detach().cpu().numpy())
    return (torch.from_numpy(np.array(jnp.cos(t))).to(theta.device),
            torch.from_numpy(np.array(jnp.sin(t))).to(theta.device))


def test_float32_sin_cos_differ_between_libraries():
    """ROADMAP C11's cause: on the same float32 angles, the copy angles of
    twist 30 deg, XLA's and PyTorch's float32 cos / sin differ by one unit
    in the last place on some angles, and neither rounds correctly (float64
    rounded to float32 differs from each)."""
    h = torch.arange(-40, 41, dtype=torch.float32)
    theta = torch.deg2rad(np.float32(30.0) * h)
    np.testing.assert_array_equal(
        theta.numpy(), np.asarray(jnp.deg2rad(jnp.float32(30.0) * jnp.asarray(h.numpy()))))
    port = port_ps.cos_sin(theta)
    ref = _jax_cos_sin(theta)
    exact = [torch.from_numpy(f(theta.double().numpy()).astype(np.float32))
             for f in (np.cos, np.sin)]
    ulps = [((p - r) / torch.finfo(torch.float32).eps).abs().max() for p, r in zip(port, ref)]
    assert any(bool((p != r).any()) for p, r in zip(port, ref))
    assert max(float(u) for u in ulps) <= 2.0, ulps
    assert any(bool((p != e).any()) for p, e in zip(port, exact))
    assert any(bool((r != e).any()) for r, e in zip(ref, exact))


def test_half_way_ties_at_twist_30(wide_rise, monkeypatch):
    """ROADMAP C11: at twist 30 deg (12 units a turn, sin 30 = 1/2) many
    nearest-neighbour samples of this geometry fall half-way between two
    voxels, so the last bit of a float32 cos / sin decides their rounding.
    With PyTorch's cos / sin the score moves from the reference's by more
    than 1e-4 there and by less than 1e-5 at 30.1 deg and 55 deg, on the
    grouped path (HELICON_GRID_GROUPED=1, groups of one) and on the
    per-candidate path that this call takes by the reference's rule (and
    in the fixture's per-candidate call at rise 8). Given XLA's values of
    the same angles (test_float32_sin_cos_differ_between_libraries) the
    port matches the reference within 1e-4 at 30 deg too, on both paths."""
    image, _, ri, fixed_port, fixed_ref = wide_rise
    kw = dict(WIDE_KW, cg_iters=10, fista_iters=16, power_iters=8)
    tw, rises = np.float32([30.0, 30.1, 55.0]), np.float32([8.0, 8.0, 8.0])
    for grouped, path in (("1", "grouped"), ("-1", "percand")):
        with monkeypatch.context() as m:
            m.setenv("HELICON_GRID_GROUPED", grouped)
            ref = _ref(image, tw, rises, **kw)
            apart = np.abs(_port(image, tw, rises, **kw).scores - ref.scores)
            m.setattr(port_ps, "cos_sin", _jax_cos_sin)
            port = _port(image, tw, rises, **kw)
        assert port.effective["path"] == ref.effective["path"] == path
        np.testing.assert_allclose(port.scores, ref.scores, rtol=0, atol=1e-4)
        assert apart[0] > 1e-4 and apart[1:].max() < 1e-5, (path, apart)
    fixed = np.abs(_at_rise(fixed_port, ri, 8.0) - _at_rise(fixed_ref, ri, 8.0))
    assert fixed.max() < 1e-5, fixed
