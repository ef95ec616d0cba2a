"""The PyTorch port's separable and twist-grouped operator builds against
the JAX package (operator tensors at atol 1e-5, the projector gate of
PARITY.md section 1), the fused-NTN invariant NTN == PTP + ST(S(.)), and
the adjoint identities of the explicit transposes <P x, y> == <x, PT y>.

Data-derived tensors (rhs, |b|, products with random volumes) are sums of
many O(1) float32 terms; they are held at 1e-5 relative to their largest
value."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.denovo3d import geometry as ref_geo
from helicon_tpu.denovo3d import projector_grouped as ref_pg
from helicon_tpu.denovo3d import projector_separable as ref_ps
from helicon_tpu.denovo3d.grid import _group_tables
from helicon_tpu_torch.denovo3d import geometry as port_geo
from helicon_tpu_torch.denovo3d import projector_grouped as port_pg
from helicon_tpu_torch.denovo3d import projector_separable as port_ps

GEOM = dict(d2=14, l2=32, d3=12, l3=6, rmin=0.0, rmax=5.0, scale2d_to_3d=0.858)


def _close(out, ref, atol=1e-5, rel=False):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if rel else 1.0
    np.testing.assert_allclose(out.astype(np.float32), ref.astype(np.float32), atol=atol * scale)


@pytest.fixture(scope="module", params=[(29.4, 1, 0.0), (-2.0, 2, 1.5)], ids=["c1", "c2_dy"])
def group_case(request):
    """One twist group (3 rises) built by both packages from one seed."""
    twist, csym, dy = request.param
    rg = ref_geo.ReconstructionGeometry(csym=csym, **GEOM)
    pg = port_geo.ReconstructionGeometry(csym=csym, **GEOM)
    region = np.random.default_rng(7).random((rg.d2, rg.l2)).astype(np.float32)
    rises = np.asarray([1.0, 1.1, 1.25], np.float32)
    n_copies, n_pairs = ref_geo.estimate_copy_pair_counts(
        rg, float(rises.min()), 8, rise_pixel_max=float(rises.max())
    )
    n_ops = ref_geo.estimate_n_pair_ops(rg, float(rises.min()))
    u = set()
    for r in rises:
        ch, cc, cv = ref_geo.select_copies(rg, float(r), n_copies)
        u.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    rp, m, ch_u, cc_u, pidx, pval, _ = _group_tables(
        rg, twist, rises, n_copies, n_pairs, n_ops, len(u), 3, {}
    )
    hmax = (n_ops // csym - 1) // 2
    ops_h = np.repeat(np.arange(-hmax, hmax + 1), csym).astype(np.int32)
    ops_c = np.tile(np.arange(csym), 2 * hmax + 1).astype(np.int32)
    mask, cellok = rg.cylindrical_mask(), rg.cell_valid_mask()
    sh_r = ref_pg.build_group_shared(
        rg, jnp.float32(twist), jnp.asarray(ch_u), jnp.asarray(cc_u), jnp.asarray(ops_h),
        jnp.asarray(ops_c), dy_pixel=jnp.float32(dy), interpolation="nn", mask=mask,
        cellok=cellok, compute_dtype=jnp.float32,
    )
    tens_r = jax.vmap(
        lambda r, mm, pi, pv: ref_pg.build_candidate_tensors_grouped(
            sh_r, rg, jnp.asarray(region), r, jnp.sqrt(mm), pi, pv
        )
    )(jnp.asarray(rp), jnp.asarray(m), jnp.asarray(pidx), jnp.asarray(pval))
    sh_p = port_pg.build_group_shared(
        pg, np.float32(twist), ch_u, cc_u, ops_h, ops_c, np.float32(dy), "nn", mask,
        cellok, torch.float32, "cpu",
    )
    tab = (rp, np.sqrt(m), pidx, pval)
    tens_p = port_pg.build_candidate_tensors_grouped(sh_p, pg, region, *tab)
    return dict(rg=rg, pg=pg, region=region, sh_r=sh_r, sh_p=sh_p, tens_r=tens_r,
                tens_p=tens_p, tab=tab)


def test_build_group_shared(group_case):
    sh_r, sh_p = group_case["sh_r"], group_case["sh_p"]
    for k in ("A_top", "Wsum", "Mxy_ops", "mask_f"):
        _close(sh_p[k], sh_r[k])
    for k in ("xy_any", "xy_ok_ops"):
        np.testing.assert_array_equal(sh_p[k].numpy(), np.asarray(sh_r[k]))


@pytest.mark.parametrize("key", ["Gz", "Mz_ops", "a_f", "Cn", "deg", "ub_raw"])
def test_candidate_tensors_grouped(group_case, key):
    _close(group_case["tens_p"][key], group_case["tens_r"][key])


@pytest.mark.parametrize("key", ["rhs", "b_norm"])
def test_candidate_rhs_grouped(group_case, key):
    _close(group_case["tens_p"][key], group_case["tens_r"][key], rel=True)


def test_fused_ntn_matches_separate_operators(group_case):
    pg = group_case["pg"]
    ops, _ = port_pg.build_candidate_problem_grouped(
        group_case["sh_p"], pg, group_case["region"], *group_case["tab"]
    )
    rng = np.random.default_rng(11)
    for _ in range(2):
        v = torch.from_numpy(rng.standard_normal((3,) + pg.volume_shape).astype(np.float32))
        ref = ops["PTP"](v) + ops["ST"](ops["S"](v))
        _close(ops["NTN"](v), ref.numpy(), atol=1e-4 * float(ref.abs().max()))


def test_grouped_adjoints(group_case):
    pg = group_case["pg"]
    ops, rowv = port_pg.build_candidate_problem_grouped(
        group_case["sh_p"], pg, group_case["region"], *group_case["tab"]
    )
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3,) + pg.volume_shape).astype(np.float32))
    for fwd, adj in (("P", "PT"), ("S", "ST")):
        y = torch.from_numpy(rng.standard_normal(tuple(ops[fwd](x).shape)).astype(np.float32))
        lhs = float((ops[fwd](x).double() * y.double()).sum())
        rhs = float((x.double() * ops[adj](y).double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1e-30), (fwd, lhs, rhs)


@pytest.fixture(scope="module", params=[(29.4, 1.3, 1), (-60.0, 1.7, 2)], ids=["c1", "c2"])
def separable_case(request):
    twist, rise, csym = request.param
    rg = ref_geo.ReconstructionGeometry(csym=csym, **GEOM)
    pg = port_geo.ReconstructionGeometry(csym=csym, **GEOM)
    region = np.random.default_rng(3).random((rg.d2, rg.l2)).astype(np.float32)
    n_copies, n_pairs = ref_geo.estimate_copy_pair_counts(rg, rise, 8)
    n_ops = ref_geo.estimate_n_pair_ops(rg, rise)
    ch, cc, cv = ref_geo.select_copies(rg, rise, n_copies)
    phc, pv = ref_geo.select_pairs(rg, twist, rise, n_pairs)
    ops_hc, ops_v, pidx, pv_ops = ref_geo.select_pair_ops(rg, twist, rise, n_pairs, n_ops)
    keep = ref_geo.compute_sym_dedup_mask(rg, twist, rise, phc, pv)
    mask, cellok = rg.cylindrical_mask(), rg.cell_valid_mask()
    ref_ops = ref_ps.build_problem_separable(
        rg, jnp.asarray(region), jnp.float32(twist), jnp.float32(rise), jnp.asarray(ch),
        jnp.asarray(cc), jnp.asarray(cv), jnp.asarray(phc), jnp.asarray(pv_ops), 0.0, "nn",
        mask, cellok, compute_dtype=jnp.float32,
        pair_ops=(jnp.asarray(ops_hc), jnp.asarray(ops_v), jnp.asarray(pidx)),
        sym_keep=jnp.asarray(keep),
    )
    port_ops = port_ps.build_problem_separable(
        pg, region, np.float32(twist), np.float32(rise), ch, cc, cv, phc, pv_ops, 0.0, "nn",
        mask, cellok, compute_dtype=torch.float32, pair_ops=(ops_hc, ops_v, pidx),
        sym_keep=keep, device="cpu",
    )
    return pg, ref_ops, port_ops


def test_build_problem_separable(separable_case):
    pg, ref_ops, port_ops = separable_case
    np.testing.assert_array_equal(port_ops["row_valid"].numpy(), np.asarray(ref_ops["row_valid"]))
    _close(port_ops["b"], ref_ops["b"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal(pg.volume_shape).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for k in ("P", "PTP", "S"):
        _close(port_ops[k](xt), ref_ops[k](xj), rel=True)
    for fwd, adj in (("P", "PT"), ("S", "ST")):
        y = rng.standard_normal(np.asarray(ref_ops[fwd](xj)).shape).astype(np.float32)
        _close(port_ops[adj](torch.from_numpy(y)), ref_ops[adj](jnp.asarray(y)), rel=True)


def test_separable_adjoints(separable_case):
    pg, _, ops = separable_case
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(pg.volume_shape).astype(np.float32))
    for fwd, adj in (("P", "PT"), ("S", "ST")):
        y = torch.from_numpy(rng.standard_normal(tuple(ops[fwd](x).shape)).astype(np.float32))
        lhs = float((ops[fwd](x).double() * y.double()).sum())
        rhs = float((x.double() * ops[adj](y).double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1e-30), (fwd, lhs, rhs)


def test_plane_shift_tables():
    plane = np.random.default_rng(4).random((9, 9)) > 0.4
    ref = ref_ps.plane_shift_tables(plane)
    out = port_ps.plane_shift_tables(plane)
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]))


def test_linear_interpolation_raises():
    """Linear builds are ported (tests/test_torch_candidate_solve.py); the
    in-kernel nearest-neighbour build of B3 still raises on linear, before
    it reads anything, as the reference does (ROADMAP C4)."""
    from helicon_tpu_torch.denovo3d.candidate_solve import full_kernel_inputs

    pg = port_geo.ReconstructionGeometry(csym=1, **GEOM)
    c = np.zeros(2, np.int32)
    with pytest.raises(NotImplementedError):
        full_kernel_inputs(pg, None, 10.0, 1.0, c, c, c > -1, np.zeros((1, 2), np.int32),
                           torch.float32, interpolation="linear")
