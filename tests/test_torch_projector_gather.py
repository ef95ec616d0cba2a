"""The PyTorch port's gather projector (any pose) and the gather form of
the separable build against the JAX package.

The reference's PT and ST are jax.vjp's of P and S; the port's are
explicit transposes (index_add_ of the same samples; PT and ST(S(x)) summed
exactly, in 64-bit integers). Operators are held at
atol 1e-5 (PARITY.md section 1), sums of many terms at 1e-5 relative to
their largest value, and the transposes by the adjoint identities
<P x, r> == <x, PT r>, <S x, q> == <x, ST q>. The JAX side runs eagerly
(jax.disable_jit()), where XLA evaluates each float32 operation alone, as
the port does."""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.denovo3d import geometry as ref_geo
from helicon_tpu.denovo3d import projector as ref_pr
from helicon_tpu.denovo3d import projector_separable as ref_ps
from helicon_tpu_torch.denovo3d import gather_kernels as port_gk
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
        np.testing.assert_array_equal(_np(port_pr.rot_yx_inv(tilt, psi, device="cpu")), ref)


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


def test_posed_sym_normal_matches_reference(posed):
    """STS, the normal operator's symmetry term (K4's plain version, summed
    exactly), against the reference's ST(S(x)) and the port's own float
    ST(S(x))."""
    ref, port, x, _, _ = posed
    with jax.disable_jit():
        sts_r = ref["ST"](ref["S"](jnp.asarray(x)))
    xt = torch.from_numpy(x)
    _close(port["STS"](xt), sts_r, rel=True)
    _close(port["STS"](xt), port["ST"](port["S"](xt)), rel=True)


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_exact_transposes_do_not_depend_on_order(interpolation, monkeypatch):
    """PT and STS sum in 64-bit integers: another order of the terms (one
    copy a chunk instead of all; the symmetry pairs reversed) gives the
    same bits, within float32 rounding of a float64 sum."""
    pg = port_geo.ReconstructionGeometry(csym=2, **GEOM)
    rng = np.random.default_rng(11)
    tabs, _ = _tables(pg, 2)
    mask = torch.from_numpy(pg.cylindrical_mask().reshape(-1))
    cellok = torch.from_numpy(pg.cell_valid_mask().reshape(-1))
    tab = port_gk.gather_tables(pg, [TWIST], [RISE], *(t[None] for t in tabs[:3]), 3.0, 1.0,
                                0.5, interpolation, mask, cellok)
    r = torch.from_numpy(rng.standard_normal(tab.shape).astype(np.float32))
    pt = port_gk.gather_backproject(tab, r)
    monkeypatch.setattr(port_gk, "_CHUNK_SAMPLES", pg.l2 * pg.d2 * pg.d2)
    np.testing.assert_array_equal(_np(port_gk.gather_backproject(tab, r)), _np(pt))
    sampler = tab.sampler()
    acc = torch.zeros(sampler.size, dtype=torch.float64)
    for sl, _, taps, _ in port_gk._chunks(tab, 0, sampler):
        rv = (r[0, sl] * tab.cvf[0, sl, None, None])[..., None]
        for idx, w in taps:
            v = rv.expand(idx.shape) if w is None else w * rv
            acc.index_add_(0, idx.reshape(-1), v.reshape(-1).double())
    _close(pt[0], sampler.result(acc)[0], atol=1e-6, rel=True)

    x = (torch.from_numpy(rng.random((1,) + pg.volume_shape).astype(np.float32)) - 0.3
         ) * mask.reshape(pg.volume_shape)
    phc, pv = tabs[3][None], tabs[4][None]
    sts = port_gk.sym_normal(port_gk.sym_tables(pg, [TWIST], [RISE], phc, pv, interpolation,
                                                mask, cellok), x)
    rev = port_gk.sym_tables(pg, [TWIST], [RISE], phc[:, ::-1].copy(), pv[:, ::-1].copy(),
                             interpolation, mask, cellok)
    np.testing.assert_array_equal(_np(port_gk.sym_normal(rev, x)), _np(sts))
    S, ST = port_pr.sym_operators(pg, [TWIST], [RISE], phc, pv, interpolation, mask, cellok)
    _close(sts, ST(S(x).double().float()), atol=1e-6, rel=True)


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
@pytest.mark.parametrize("pose", [(3.0, 1.0, 0.5), (-7.5, 2.25, -1.0), (12.0, -4.0, 2.0)])
def test_pruned_plain_kernels_equal_every_block(interpolation, pose, monkeypatch):
    """The plain K1, K2 and K3 take only the (copy, row) blocks that reach
    the volume's z range (_live_chunks): their projection, row validity and
    transpose equal, bit for bit, the sums over every block of every copy,
    and K3's float64 sums agree to 1e-12 relative, at tilted, psi and dy
    poses; and the blocks are _chunks' samples."""
    pg = port_geo.ReconstructionGeometry(csym=2, **GEOM)
    rng = np.random.default_rng(5)
    tabs, _ = _tables(pg, 2)
    mask = torch.from_numpy(pg.cylindrical_mask().reshape(-1))
    cellok = torch.from_numpy(pg.cell_valid_mask().reshape(-1))
    tab = port_gk.gather_tables(pg, [TWIST], [RISE], *(t[None] for t in tabs[:3]), *pose,
                                interpolation, mask, cellok, derivatives=True)
    x = torch.from_numpy(rng.random((1,) + pg.volume_shape).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(tab.shape).astype(np.float32))
    b = torch.from_numpy(rng.random(tab.shape[2:]).astype(np.float32))
    sampler = tab.sampler()
    k, C, l2, d2 = tab.shape
    live = sum(len(ci) for ci, *_ in port_gk._live_chunks(tab, 0, sampler))
    assert 0 < live < C * l2  # some blocks left out, some kept

    def plain():
        out = port_gk.gather_project_reference(tab, x, row_valid=True)
        out += (port_gk.gather_backproject_reference(tab, r),)
        return out + (port_gk.pose_jacobian_reference(tab, x, b) if tab.linear else ())

    pruned = plain()
    every = functools.partial(port_gk._live_chunks, every=True)
    monkeypatch.setattr(port_gk, "_live_chunks", every)
    full = plain()
    for got, want in zip(pruned[:3], full[:3]):
        np.testing.assert_array_equal(_np(got), _np(want))
    for got, want in zip(pruned[3:], full[3:]):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=0)
    # every block holds _chunks' samples, bit for bit
    zyx = {}
    for ci, ii, (Z, Y, X), _, _ in every(tab, 0, sampler):
        for n, (c, i) in enumerate(zip(ci.tolist(), ii.tolist())):
            zyx[c, i] = (Z[n], Y[n], X[n])
    for sl, (Z, Y, X), _, _ in port_gk._chunks(tab, 0, sampler):
        for c in range(sl.start, sl.stop):
            for i in range(l2):
                for got, want in zip(zyx[c, i], (Z[c - sl.start, i], Y[c - sl.start, i],
                                                 X[c - sl.start, i])):
                    assert torch.equal(got, want)


def test_live_rays_list_the_valid_rows():
    """with_live_rays lists, per candidate and in order, the rays of
    row_valid: the rays K1 and K2 take on the card."""
    pg = port_geo.ReconstructionGeometry(csym=2, **GEOM)
    tabs, _ = _tables(pg, 2)
    ch, cc, cv = (np.stack([t, t]) for t in tabs[:3])
    cv[1, ::2] = False
    tab = port_gk.gather_tables(pg, [TWIST, TWIST + 1], [RISE, RISE], ch, cc, cv,
                                [3.0, -2.0], [1.0, 0.0], [0.5, 0.0], "nn",
                                torch.from_numpy(pg.cylindrical_mask().reshape(-1)),
                                torch.from_numpy(pg.cell_valid_mask().reshape(-1)))
    _, rowv = port_gk.gather_project(tab, None, row_valid=True)
    listed = port_gk.with_live_rays(tab, rowv)
    flat = rowv.reshape(2, -1)
    for q in range(2):
        got = listed.ridx[int(listed.rptr[q]):int(listed.rptr[q + 1])]
        np.testing.assert_array_equal(_np(got), np.flatnonzero(_np(flat[q])))
    assert listed.n_max == int(flat.sum(dim=1).max()) > 0
    assert listed.ridx.dtype == listed.rptr.dtype == torch.int32


def test_posed_data_term_matches_reference(posed):
    """PTRP(x, rows) = PT(rows * P(x)), the solver's data term
    (gather_normal's plain version), against the reference's PT(rows *
    P(x)), at the valid rows and at an fsc half's (mode 3) weighting."""
    ref, port, x, _, _ = posed
    rows = port["row_valid"].float()
    half = torch.from_numpy(port_solver._pid_split_masks(port_geo.ReconstructionGeometry(
        csym=1, **GEOM), 3)[0])
    xt = torch.from_numpy(x)
    for rw in (rows, rows * half):
        with jax.disable_jit():
            want = ref["PT"](ref["P"](jnp.asarray(x)) * jnp.asarray(_np(rw)))
        got = port["PTRP"](xt, rw)
        _close(got, want, rel=True)
        np.testing.assert_array_equal(_np(got), _np(port["PT"](port["P"](xt) * rw)))


def _ragged(interpolation):
    """Tables of three candidates at their own poses whose lists of live
    rays differ in length (other populated slots, other poses)."""
    pg = port_geo.ReconstructionGeometry(csym=2, **GEOM)
    tabs, _ = _tables(pg, 2)
    ch, cc, cv = (np.stack([t, t, t]) for t in tabs[:3])
    cv[1, ::2] = False
    cv[2, 1::3] = False
    mask = torch.from_numpy(pg.cylindrical_mask().reshape(-1))
    tab = port_gk.gather_tables(pg, [TWIST, TWIST + 1, TWIST - 2], [RISE] * 3, ch, cc, cv,
                                [3.0, -2.0, 7.5], [1.0, 0.0, -2.0], [0.5, 0.0, 1.0],
                                interpolation, mask,
                                torch.from_numpy(pg.cell_valid_mask().reshape(-1)))
    rng = np.random.default_rng(13)
    x = (torch.from_numpy(rng.random((3,) + pg.volume_shape).astype(np.float32)) - 0.3
         ) * mask.reshape(pg.volume_shape)
    return pg, tab, x


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_gather_normal_is_the_composition_on_the_live_rays(interpolation):
    """gather_normal (its plain version on CPU tensors) equals
    gather_backproject_reference(tab, gather_project_reference(tab, x) *
    rows) bit for bit at k = 3 with ragged live lists, at the valid rows
    and at an fsc half's weighting; and the kernel's reading of it holds:
    P(x) is 0 off the list, so the listed rays' values alone (its compact
    (k, n_max) buffer) have the same max and, added back, give the same
    bits."""
    pg, tab, x = _ragged(interpolation)
    _, rowv = port_gk.gather_project(tab, None, row_valid=True)
    listed = port_gk.with_live_rays(tab, rowv)
    counts = _np(listed.rptr[1:] - listed.rptr[:-1])
    assert len(set(counts.tolist())) == 3 and counts.min() > 0
    half = torch.from_numpy(port_solver._pid_split_masks(pg, 2)[1])
    pred = port_gk.gather_project_reference(tab, x)
    assert not bool(pred[~rowv].any())
    for rows in (rowv.float(), rowv.float() * half):
        got = port_gk.gather_normal(listed, x, rows)
        want = port_gk.gather_backproject_reference(tab, pred * rows)
        np.testing.assert_array_equal(_np(got), _np(want))
        assert bool(want.abs().max() > 0)
        flat = (pred * rows).reshape(3, -1)
        dense = torch.zeros_like(flat)
        for q in range(3):
            idx = listed.ridx[int(listed.rptr[q]):int(listed.rptr[q + 1])].long()
            comp = flat[q, idx]
            assert torch.equal(comp.abs().max(), flat[q].abs().max())
            dense[q, idx] = comp
        np.testing.assert_array_equal(
            _np(port_gk.gather_backproject_reference(tab, dense.reshape(tab.shape))), _np(want))


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
def test_sample_table_gives_the_plain_samples(interpolation):
    """The plain sample table of an nn list (k = 3, ragged) holds each
    listed ray's samples as K1 takes them: summed from the table in K1's
    order, each listed ray's value equals the plain P's bit for bit, and
    the slots past a candidate's entries hold -1. Linear lists have no
    table: sample_table refuses them."""
    pg, tab, x = _ragged(interpolation)
    _, rowv = port_gk.gather_project(tab, None, row_valid=True)
    listed = port_gk.with_live_rays(tab, rowv)
    assert listed.sidx is None  # built on the card only
    if tab.linear:
        with pytest.raises(ValueError):
            port_gk.sample_table(listed)
        return
    sidx = port_gk.sample_table(listed)
    assert sidx.shape == (3, listed.n_max, pg.d2) and sidx.dtype == torch.int32
    pred = port_gk.gather_project_reference(tab, x).reshape(3, -1)
    for q in range(3):
        a, b = int(listed.rptr[q]), int(listed.rptr[q + 1])
        si = sidx[q, : b - a].long()
        assert bool((sidx[q, b - a:] == -1).all()) and bool((si >= 0).any(dim=1).all())
        val = torch.where(si >= 0, x[q].reshape(-1)[si.clamp(0)], 0.0)
        np.testing.assert_array_equal(_np(port_gk._ray_sum(val)),
                                      _np(pred[q, listed.ridx[a:b].long()]))


@pytest.mark.parametrize("k,n,listed", [(1, 62694, True), (45, 62694, True), (1, 300, True),
                                        (200, 5000, True), (3, 0, True), (1, 2539520, False),
                                        (45, 2539520, False), (2, 500, False)])
def test_launch_grid_follows_the_work(k, n, listed):
    """K1 / K2's grid: at most one block an SM over the launch, none
    without a share of the list, each with at least MIN_RAYS entries (or a
    group of 32 rays a warp) unless one block takes them all."""
    sms = 132
    per, rpb = port_gk.launch_grid(k, n, listed, sms)
    assert 1 <= per <= -(-sms // k)
    if not listed:
        assert rpb == 0 and (per == 1 or n // per >= 1024)
        return
    assert per * rpb >= n and (per - 1) * rpb < max(n, 1)
    assert per == 1 or rpb >= port_gk.MIN_RAYS


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


def _sym_case(csym, interpolation, with_keep):
    """The symmetry tables of two candidates (other twists and rises; the
    second with every other pair slot padding), with the reference's
    deduplication mask or without, and a volume each."""
    pg = port_geo.ReconstructionGeometry(csym=csym, **GEOM)
    tabs, _ = _tables(pg, csym)
    phc, pv = np.stack([tabs[3], tabs[3]]), np.stack([tabs[4], tabs[4]])
    pv[1, ::2] = False
    keep = None
    if with_keep:
        keep = np.stack([ref_geo.compute_sym_dedup_mask(pg, TWIST, RISE, tabs[3], tabs[4])] * 2)
    mask = torch.from_numpy(pg.cylindrical_mask().reshape(-1))
    st = port_gk.sym_tables(pg, [TWIST, TWIST + 1], [RISE, RISE * 1.1], phc, pv, interpolation,
                            mask, torch.from_numpy(pg.cell_valid_mask().reshape(-1)), keep)
    rng = np.random.default_rng(17)
    x = (torch.from_numpy(rng.random((2,) + pg.volume_shape).astype(np.float32)) - 0.3
         ) * mask.reshape(pg.volume_shape)
    return st, x


SYM_CASES = [(csym, interp, keep) for csym in (1, 2) for interp in ("nn", "linear")
             for keep in (False, True)]


@pytest.mark.parametrize("csym,interpolation,with_keep", SYM_CASES)
def test_sym_items_are_the_plain_taps(csym, interpolation, with_keep):
    """K4's item list (sym_items on the CPU: its plain version, which
    samples each item alone as the build kernels do) holds the rows that
    _sym_taps finds valid, in order, with their samples' voxels (nn; the
    taps index the padded volume) or cells and eight weights (linear)."""
    st, _ = _sym_case(csym, interpolation, with_keep)
    k, P = st.shape
    d3, l3 = st.d3, st.l3
    vol = l3 * d3 * d3
    taps1, taps2, valid = st.taps()
    iptr, itap, iw = port_gk.sym_items(st)
    ids = torch.nonzero(valid.reshape(-1) > 0)[:, 0]
    assert itap.shape == (len(ids), 2) and itap.dtype == iptr.dtype == torch.int32
    np.testing.assert_array_equal(_np(iptr), np.concatenate(
        [[0], np.cumsum(_np(valid.reshape(k, -1).sum(dim=1)))]))
    assert int(iptr[2] - iptr[1]) < int(iptr[1]) and len(ids) > 0
    size = st.sampler().size
    q = ids // (P * vol)
    for o, taps in enumerate((taps1, taps2)):
        first = taps[0][0].reshape(-1)[ids] - q * size
        if interpolation == "nn":
            D = d3 + 2
            z, y, x = first // (D * D) - 1, (first // D) % D - 1, first % D - 1
            first = (z * d3 + y) * d3 + x
            assert iw is None
        else:
            for a, (_, w) in enumerate(taps):
                np.testing.assert_array_equal(_np(iw[:, o, a]), _np(w.reshape(-1)[ids]))
        np.testing.assert_array_equal(_np(itap[:, o]).astype(np.int64), _np(first))


@pytest.mark.parametrize("csym,interpolation,with_keep", SYM_CASES)
def test_sym_normal_on_the_list_is_plain(csym, interpolation, with_keep):
    """The plain K4 on the tables' item list (each row's difference, each
    incidence's integer added into its voxel: the kernels' arithmetic)
    equals sym_normal_reference bit for bit; each item's taps appear once
    as incidences, sorted by output voxel, signed by op."""
    st, x = _sym_case(csym, interpolation, with_keep)
    want = port_gk.sym_normal_reference(st, x)
    np.testing.assert_array_equal(_np(port_gk.sym_normal_list_reference(st, x)), _np(want))
    assert bool(want.abs().max() > 0)
    lst = port_gk.sym_list(st)
    n, taps = lst.itap.shape[0], 8 if interpolation == "linear" else 1
    assert lst.cinc.numel() == lst.cw.numel() == 2 * taps * n == int(lst.cptr[-1])
    assert bool((lst.cptr[1:] >= lst.cptr[:-1]).all())
    np.testing.assert_array_equal(np.bincount(_np(lst.cinc), minlength=n), 2 * taps)
    # each item: its first op's taps weigh +1 in all, its second's -1
    per_item = torch.zeros(n, dtype=torch.float64).index_add_(0, lst.cinc.long(), lst.cw.double())
    np.testing.assert_allclose(_np(per_item), 0.0, atol=1e-6)
    if interpolation == "nn":
        assert bool((lst.cw.abs() == 1).all())
    else:
        np.testing.assert_allclose(_np(lst.iw.double().sum(dim=-1)), 1.0, atol=1e-6)


@pytest.mark.parametrize("pose", [(3.0, 1.0, 0.5), (-7.5, 2.25, -1.0), (12.0, -4.0, 2.0)])
def test_pose_jacobian_on_the_live_list(pose):
    """At a Gauss-Newton pose, K3's plain version on the tables' list of
    live rays (the rays the kernel walks: K1's row validity, as gn_step
    lists them on the card) gives the (J^T J, J^T r, r^T r) of the plain
    version over every ray of every copy within 1e-12 relative, at k = 2
    with ragged lists."""
    pg = port_geo.ReconstructionGeometry(csym=2, **GEOM)
    tabs, _ = _tables(pg, 2)
    ch, cc, cv = (np.stack([t, t]) for t in tabs[:3])
    cv[1, 1::3] = False
    tab = port_gk.gather_tables(pg, [TWIST, TWIST - 1], [RISE, RISE], ch, cc, cv,
                                [pose[0], pose[0] / 2], [pose[1], 0.0], [pose[2], 0.0], "linear",
                                torch.from_numpy(pg.cylindrical_mask().reshape(-1)),
                                torch.from_numpy(pg.cell_valid_mask().reshape(-1)),
                                derivatives=True)
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.random((2,) + pg.volume_shape).astype(np.float32))
    b = torch.from_numpy(rng.random(tab.shape[2:]).astype(np.float32))
    listed = port_gk.with_live_rays(tab, port_gk.gather_project(tab, None, row_valid=True)[1])
    assert listed.n_max < tab.shape[1] * tab.shape[2] * tab.shape[3]
    got = port_gk.pose_jacobian(listed, x, b)
    every = functools.partial(port_gk._live_chunks, every=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_gk, "_live_chunks", every)
        want = port_gk.pose_jacobian_reference(tab, x, b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=0)
    assert float(want[2].min()) > 0


@pytest.mark.parametrize("k,n,vol,n_inc", [(1, 52068, 8664, 57466), (1, 28733, 8664, 292512),
                                           (45, 62694, 8664, 2586000), (1, 0, 8664, 0),
                                           (3, 1500, 1152, 3000), (200, 5000, 100000, 10 ** 7)])
def test_k3_and_k4_grids_follow_the_work(k, n, vol, n_inc):
    """K3's grid (jacobian_grid): at most K3_BLOCKS_A_SM blocks an SM over
    the launch, each with at least K3_MIN_RAYS entries unless one block
    takes them all, the list covered. K4's first kernel one thread an
    item or voxel at most, at most four blocks an SM; its sums' lanes a
    power of two up to 32, no more than one wave of threads holds, none
    past the mean incidences a voxel."""
    sms = 132
    per, rpb = port_gk.jacobian_grid(k, n, sms)
    assert 1 <= per <= -(-port_gk.K3_BLOCKS_A_SM * sms // k)
    assert per * rpb >= n and (per - 1) * rpb < max(n, 1)
    assert per == 1 or rpb >= port_gk.K3_MIN_RAYS
    nb = port_gk.sym_blocks(k, n, vol, sms)
    assert 1 <= nb <= max(1, -(-4 * sms // k)) and (nb - 1) * 256 < max(-(-n // k), vol)
    lanes = port_gk.sym_lanes(k, vol, n_inc, sms)
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert lanes == 1 or (k * vol * lanes <= sms * 2048 and (lanes // 2) * k * vol < n_inc)
