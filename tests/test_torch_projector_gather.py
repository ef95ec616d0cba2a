"""The PyTorch port's gather projector (any pose) and the gather form of
the separable build against the JAX package.

The reference's PT and ST are jax.vjp's of P and S; the port's are
explicit transposes (index_add_ of the same samples). Operators are held at
atol 1e-5 (PARITY.md section 1), sums of many terms at 1e-5 relative to
their largest value, and the transposes by the adjoint identities
<P x, r> == <x, PT r>, <S x, q> == <x, ST q>. The JAX side runs eagerly
(jax.disable_jit()), where XLA evaluates each float32 operation alone, as
the port does."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.denovo3d import geometry as ref_geo
from helicon_tpu.denovo3d import projector as ref_pr
from helicon_tpu.denovo3d import projector_separable as ref_ps
from helicon_tpu_torch.denovo3d import geometry as port_geo
from helicon_tpu_torch.denovo3d import projector as port_pr
from helicon_tpu_torch.denovo3d import projector_separable as port_ps
from helicon_tpu_torch.denovo3d import solver as port_solver

GEOM = dict(d2=14, l2=24, d3=12, l3=8, rmin=0.0, rmax=5.0, scale2d_to_3d=0.858)
TWIST, RISE = 29.4, 1.3


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(out, ref, atol=1e-5, rel=False):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if rel else 1.0
    np.testing.assert_allclose(out.astype(np.float32), ref.astype(np.float32), atol=atol * scale)


def _tables(geom, csym):
    ch, cc, cv = ref_geo.select_copies(geom, RISE, 6)
    phc, pv = ref_geo.select_pairs(geom, TWIST, RISE, 5)
    ops = ref_geo.select_pair_ops(geom, TWIST, RISE, 5, 12)
    return (ch, cc, cv, phc, pv), ops


def _both(csym, interpolation, tilt, psi, dy):
    """The reference's and the port's build_problem on one seed."""
    rg = ref_geo.ReconstructionGeometry(csym=csym, **GEOM)
    pg = port_geo.ReconstructionGeometry(csym=csym, **GEOM)
    rng = np.random.default_rng(3)
    region = rng.random((rg.d2, rg.l2)).astype(np.float32)
    tabs, _ = _tables(rg, csym)
    mask, cellok = rg.cylindrical_mask(), rg.cell_valid_mask()
    with jax.disable_jit():
        ref = ref_pr.build_problem(
            rg, jnp.asarray(region), jnp.float32(TWIST), jnp.float32(RISE),
            *(jnp.asarray(t) for t in tabs), jnp.float32(tilt), jnp.float32(psi),
            jnp.float32(dy), interpolation, mask, cellok,
        )
    port = port_pr.build_problem(
        pg, region, np.float32(TWIST), np.float32(RISE), *tabs, tilt, psi, np.float32(dy),
        interpolation, mask, cellok, device="cpu",
    )
    x = (rng.random(rg.volume_shape) * mask).astype(np.float32)
    r = rng.random(tuple(ref["row_valid"].shape)).astype(np.float32)
    q = rng.random((len(tabs[4]),) + rg.volume_shape).astype(np.float32)
    return ref, port, x, r, q


CASES = [(1, "nn"), (1, "linear"), (2, "nn"), (2, "linear")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"csym{c[0]}_{c[1]}")
def posed(request):
    csym, interpolation = request.param
    return _both(csym, interpolation, 3.0, 1.0, 0.5)


def test_rotation_matches_reference():
    for tilt, psi in ((3.0, 1.0), (0.0, 0.0), (-7.5, 2.25)):
        ref = np.asarray(ref_pr._rot_yx_inv(jnp.float32(tilt), jnp.float32(psi)))
        np.testing.assert_array_equal(_np(port_pr.rot_yx_inv(tilt, psi)), ref)


def test_posed_operators_match_reference(posed):
    ref, port, x, r, q = posed
    np.testing.assert_array_equal(_np(port["row_valid"]), np.asarray(ref["row_valid"]))
    with jax.disable_jit():
        p_r = ref["P"](jnp.asarray(x))
        pt_r = ref["PT"](jnp.asarray(r))
        s_r = ref["S"](jnp.asarray(x))
        st_r = ref["ST"](jnp.asarray(q))
    xt = torch.from_numpy(x)
    _close(port["P"](xt), p_r, rel=True)
    _close(port["PT"](torch.from_numpy(r)), pt_r, rel=True)
    _close(port["S"](xt), s_r)
    _close(port["ST"](torch.from_numpy(q)), st_r, rel=True)
    _close(port["b"], ref["b"])


def test_posed_transposes_are_adjoint(posed):
    _, port, x, r, q = posed
    xt, rt, qt = (torch.from_numpy(a).double() for a in (x, r, q))
    lhs = float((port["P"](xt.float()).double() * rt).sum())
    rhs = float((xt * port["PT"](rt.float()).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (lhs, rhs)
    lhs = float((port["S"](xt.float()).double() * qt).sum())
    rhs = float((xt * port["ST"](qt.float()).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs)), (lhs, rhs)


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_gather_at_zero_pose_equals_separable(interpolation):
    """At tilt = psi = 0 the gather operators equal the separable ones of
    the port itself (the separable build on dense symmetry matrices)."""
    pg = port_geo.ReconstructionGeometry(csym=1, **GEOM)
    rng = np.random.default_rng(5)
    region = rng.random((pg.d2, pg.l2)).astype(np.float32)
    tabs, ops = _tables(pg, 1)
    mask, cellok = pg.cylindrical_mask(), pg.cell_valid_mask()
    args = (pg, region, np.float32(TWIST), np.float32(RISE), *tabs)
    gat = port_pr.build_problem(*args, 0.0, 0.0, np.float32(0.7), interpolation, mask, cellok,
                                device="cpu")
    sep = port_ps.build_problem_separable(*args, np.float32(0.7), interpolation, mask, cellok,
                                          pair_ops=ops[:3], device="cpu")
    assert "factors" in sep
    x = torch.from_numpy((rng.random(pg.volume_shape) * mask).astype(np.float32))
    r = torch.from_numpy(rng.random(tuple(gat["row_valid"].shape)).astype(np.float32))
    np.testing.assert_array_equal(_np(gat["row_valid"]), _np(sep["row_valid"]))
    _close(gat["P"](x), sep["P"](x), rel=True)
    _close(gat["PT"](r), sep["PT"](r), rel=True)
    _close(gat["S"](x), sep["S"](x))


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_separable_gather_form_matches_reference_and_dense(interpolation):
    """Without pair_ops the separable build samples each symmetry pair by
    gathers, as the reference's does; it gives the rows of the dense
    form."""
    pg = port_geo.ReconstructionGeometry(csym=1, **GEOM)
    rg = ref_geo.ReconstructionGeometry(csym=1, **GEOM)
    rng = np.random.default_rng(9)
    region = rng.random((pg.d2, pg.l2)).astype(np.float32)
    tabs, ops = _tables(pg, 1)
    keep = ref_geo.compute_sym_dedup_mask(rg, TWIST, RISE, tabs[3], tabs[4])
    mask, cellok = pg.cylindrical_mask(), pg.cell_valid_mask()
    x = (rng.random(pg.volume_shape) * mask).astype(np.float32)
    q = rng.random((len(tabs[4]),) + pg.volume_shape).astype(np.float32)
    args = (np.float32(TWIST), np.float32(RISE))
    gat = port_ps.build_problem_separable(pg, region, *args, *tabs, 0.0, interpolation, mask,
                                          cellok, sym_keep=keep, device="cpu")
    dense = port_ps.build_problem_separable(pg, region, *args, *tabs, 0.0, interpolation, mask,
                                            cellok, pair_ops=ops[:3], sym_keep=keep,
                                            device="cpu")
    assert "factors" not in gat and "factors" in dense
    with jax.disable_jit():
        ref = ref_ps.build_problem_separable(
            rg, jnp.asarray(region), jnp.float32(TWIST), jnp.float32(RISE),
            *(jnp.asarray(t) for t in tabs), 0.0, interpolation, mask, cellok,
            sym_keep=jnp.asarray(keep),
        )
        s_r, st_r = ref["S"](jnp.asarray(x)), ref["ST"](jnp.asarray(q))
    xt = torch.from_numpy(x)
    _close(gat["S"](xt), s_r)
    _close(gat["ST"](torch.from_numpy(q)), st_r, rel=True)
    _close(gat["S"](xt), dense["S"](xt))
    _close(gat["ST"](torch.from_numpy(q)), dense["ST"](torch.from_numpy(q)), rel=True)


def test_dense_rule_follows_the_reference():
    """Past 32 MB of op matrices (n_ops * d3^4 * 2 bytes) the reference's
    build takes the gather form (its use_matmul_sym); the port keeps the
    dense form wherever pair_ops is given, since B2 solves on it, and its
    symmetry rows there are the reference's gather rows. The separable
    solve needs pair_ops."""
    geom = port_geo.ReconstructionGeometry(d2=12, l2=16, d3=48, l3=4, rmin=0.0, rmax=23.0,
                                           scale2d_to_3d=1.0, csym=1)
    rg = ref_geo.ReconstructionGeometry(d2=12, l2=16, d3=48, l3=4, rmin=0.0, rmax=23.0,
                                        scale2d_to_3d=1.0, csym=1)
    assert 8 * 48**4 * 2 > 32 * 1024 * 1024
    tabs, _ = _tables(geom, 1)
    ops = port_geo.select_pair_ops(geom, TWIST, RISE, 5, 8)
    region = np.zeros((12, 16), np.float32)
    args = (np.float32(TWIST), np.float32(RISE), *tabs, 0.0, "nn", geom.cylindrical_mask(),
            geom.cell_valid_mask())
    port = port_ps.build_problem_separable(geom, region, *args, pair_ops=ops[:3], device="cpu")
    assert "factors" in port
    x = (np.random.default_rng(2).random(geom.volume_shape) * geom.cylindrical_mask()
         ).astype(np.float32)
    with jax.disable_jit():
        ref = ref_ps.build_problem_separable(rg, jnp.asarray(region), *args[:2],
                                             *(jnp.asarray(t) for t in tabs), *args[7:],
                                             pair_ops=tuple(jnp.asarray(a) for a in ops[:3]))
        s_r = ref["S"](jnp.asarray(x))
    assert "factors" not in ref
    _close(port["S"](torch.from_numpy(x)), s_r)
    cfg = port_solver.SolveConfig(cg_iters=2, fista_iters=0, separable=True)
    with pytest.raises(ValueError):
        port_solver.solve_candidate(geom, cfg, region, *args[:7], device="cpu")
