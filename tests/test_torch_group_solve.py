"""The grouped solve (group_solve.py, whose CUDA kernel replaces
pallas_solver.py::_group_kernel) against the JAX package.

On CPU tensors solve_group runs its plain PyTorch version. It is held
against:
  * the JAX package's Pallas kernel in interpret mode on identical
    operators (x rel 1e-4, scores abs 1e-4: the gate of
    tests/test_pallas_solver.py). Both seed the power iteration from rhs.
  * the JAX package's XLA grouped path _solve_group_impl(fused_ntn=True),
    with each package building its own operators from the same tables
    (scores abs 1e-4). That path seeds the power iteration from ones; the
    FISTA margin absorbs the difference at these budgets.
The kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.denovo3d import geometry as ref_geo
from helicon_tpu.denovo3d import projector_grouped as ref_pg
from helicon_tpu.denovo3d.grid import _group_tables
from helicon_tpu.denovo3d.pallas_solver import grouped_pallas_inputs, solve_group_pallas
from helicon_tpu.denovo3d.solver import SolveConfig, _solve_group_impl
from helicon_tpu.helix import simulate_helical_projection
from helicon_tpu_torch.denovo3d import geometry as port_geo
from helicon_tpu_torch.denovo3d import group_solve as gs
from helicon_tpu_torch.denovo3d import grid as port_grid
from helicon_tpu_torch.denovo3d import projector_grouped as port_pg
from helicon_tpu_torch.denovo3d.solver import SolveConfig as PortSolveConfig

ITERS = dict(cg_iters=6, fista_iters=8, power_iters=2)
TWIST = 29.4


def _case(n_rises: int, positive_constraint: int):
    """tests/test_pallas_solver.py::_grouped_case's group, widened to
    n_rises candidates; both packages' inputs from the same tables."""
    img = np.asarray(
        simulate_helical_projection(
            n=1, twist=TWIST, rise=4.75, csym=1, helical_diameter=100.0, ball_radius=6.0,
            polymer=0, planarity=1.0, ny=64, nx=128, apix=2.0, rng=0,
        )
    ).squeeze()
    kw = dict(d2=14, l2=32, d3=12, l3=4, rmin=0.0, rmax=5.0, scale2d_to_3d=0.858, csym=1)
    rg, pg = ref_geo.ReconstructionGeometry(**kw), port_geo.ReconstructionGeometry(**kw)
    region = img[: rg.d2, : rg.l2].astype(np.float32)
    rises = np.linspace(1.0, 1.2, n_rises).astype(np.float32)
    n_copies, n_pairs = ref_geo.estimate_copy_pair_counts(
        rg, float(rises.min()), 8, rise_pixel_max=float(rises.max())
    )
    n_ops = ref_geo.estimate_n_pair_ops(rg, float(rises.min()))
    u = set()
    for r in rises:
        ch, cc, cv = ref_geo.select_copies(rg, float(r), n_copies)
        u.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    rp, m, ch_u, cc_u, pidx, pval, _ = _group_tables(
        rg, TWIST, rises, n_copies, n_pairs, n_ops, len(u), n_rises, {}
    )
    hmax = (n_ops - 1) // 2
    ops_h = np.arange(-hmax, hmax + 1).astype(np.int32)
    ops_c = np.zeros_like(ops_h)
    cfg = SolveConfig(interpolation="nn", separable=True, compute_dtype="float32",
                      positive_constraint=positive_constraint, **ITERS)
    mask, cellok = rg.cylindrical_mask(), rg.cell_valid_mask()

    # the JAX package's inputs, as its _solve_group_pallas assembles them
    shared = ref_pg.build_group_shared(
        rg, jnp.float32(TWIST), jnp.asarray(ch_u), jnp.asarray(cc_u), jnp.asarray(ops_h),
        jnp.asarray(ops_c), dy_pixel=jnp.float32(0.0), interpolation="nn", mask=mask,
        cellok=cellok, compute_dtype=jnp.float32,
    )
    tens = jax.vmap(
        lambda r, mm, pi, pv: ref_pg.build_candidate_tensors_grouped(
            shared, rg, jnp.asarray(region), r, jnp.sqrt(mm), pi, pv
        )
    )(jnp.asarray(rp), jnp.asarray(m), jnp.asarray(pidx), jnp.asarray(pval))
    tens = dict(tens)
    lb, ub = port_grid._box_bounds(
        port_grid._positive(PortSolveConfig(positive_constraint=positive_constraint), rp,
                            TWIST, rg.l3),
        torch.from_numpy(np.array(tens["ub_raw"])),
    )
    tens["lb"], tens["ub"] = jnp.asarray(lb.numpy()), jnp.asarray(ub.numpy())
    tens_np = {k: np.asarray(v) for k, v in tens.items()}
    shared_np = {k: np.asarray(shared[k]) for k in ("A_top", "mask_f", "Wsum")}
    tens.pop("ub_raw")
    args, static = grouped_pallas_inputs(shared, tens, rg, n_rises)
    xla_common = (
        rg, cfg, jnp.asarray(region), jnp.float32(TWIST), jnp.asarray(rp), jnp.asarray(m),
        jnp.asarray(ch_u), jnp.asarray(cc_u), jnp.asarray(pidx), jnp.asarray(pval),
    )
    port_tables = (pg, region, rp, m, ch_u, cc_u, pidx, pval, ops_h, ops_c)
    return dict(args=args, static=static, shared_np=shared_np, tens_np=tens_np,
                xla_common=xla_common, n_ops=n_ops, port_tables=port_tables,
                positive_constraint=positive_constraint)


CASES = {"r3": (3, -1), "r16": (16, -1), "unbounded": (5, 0)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    c = _case(*CASES[request.param])
    x_w, s = solve_group_pallas(c["args"], c["static"], use_bf16=False, interpret=True, **ITERS)
    R, l3 = c["static"]["R"], c["static"]["l3"]
    c["pallas_x"] = np.asarray(x_w).reshape(l3, R, -1).transpose(1, 0, 2)
    c["pallas_s"] = np.asarray(s)[:, 0]
    c["xla_s"] = np.asarray(_solve_group_impl(*c["xla_common"], n_ops_u=c["n_ops"], fused_ntn=True))
    return c


def _port_inputs_from_numpy(c):
    return gs.group_inputs_from_numpy(c["shared_np"], c["tens_np"])


def test_bounds_case_is_what_it_says(case):
    lb = case["tens_np"]["lb"]
    if case["positive_constraint"] == 0:
        assert np.all(np.isneginf(lb)) and np.all(np.isposinf(case["tens_np"]["ub"]))
    else:
        assert np.all(lb == 0.0)


def test_plain_matches_pallas_kernel_interpret(case):
    launches = gs.launches
    x, s = gs.solve_group(_port_inputs_from_numpy(case), **ITERS)
    assert gs.launches == launches  # CPU tensors never reach the kernel
    ref_x = case["pallas_x"]
    rel = np.abs(x[0].numpy() - ref_x).max() / max(np.abs(ref_x).max(), 1e-30)
    assert rel < 1e-4, rel
    np.testing.assert_allclose(s[0].numpy(), case["pallas_s"], atol=1e-4)


def test_port_build_and_solve_match_xla_grouped_path(case):
    pg, region, rp, m, ch_u, cc_u, pidx, pval, ops_h, ops_c = case["port_tables"]
    shared = port_pg.build_group_shared(
        pg, np.float32(TWIST), ch_u, cc_u, ops_h, ops_c, np.float32(0.0), "nn",
        pg.cylindrical_mask(), pg.cell_valid_mask(), torch.float32, "cpu",
    )
    tens = port_pg.build_candidate_tensors_grouped(shared, pg, region, rp, np.sqrt(m), pidx, pval)
    tens["lb"], tens["ub"] = port_grid._box_bounds(
        port_grid._positive(PortSolveConfig(positive_constraint=case["positive_constraint"]),
                            rp, TWIST, pg.l3),
        tens["ub_raw"],
    )
    _, s = gs.solve_group(gs.group_inputs(shared, tens), **ITERS)
    np.testing.assert_allclose(s[0].numpy(), case["xla_s"], atol=1e-4)


def test_group_inputs_batch_of_groups_solves_each_group(case):
    """G groups in one call give each group's own result."""
    one = _port_inputs_from_numpy(case)
    two = gs.GroupInputs.empty(2, one)
    two.put(0, one)
    two.put(1, one)
    x1, s1 = gs.solve_group(one, **ITERS)
    x2, s2 = gs.solve_group(two, **ITERS)
    for g in range(2):
        np.testing.assert_allclose(s2[g].numpy(), s1[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(x2[g].numpy(), x1[0].numpy(), atol=1e-6)


def test_solve_group_refuses_other_devices():
    one = gs.GroupInputs(
        a_top=torch.zeros((1, 4, 4), device="meta"), gz=torch.zeros((1, 1, 1, 1, 1)),
        mz=torch.zeros((1, 1, 1, 1, 1)), af=torch.zeros((1, 1, 1, 1, 4)),
        cn=torch.zeros((1, 1, 1, 1)), deg=torch.zeros((1, 1, 1, 1, 4)),
        mask=torch.zeros((1, 4)), rhs=torch.zeros((1, 1, 1, 4)), lb=torch.zeros((1, 1)),
        ub=torch.zeros((1, 1)), bn=torch.zeros((1, 1)), d2=0,
    )
    with pytest.raises(ValueError):
        gs.solve_group(one, 1, 1, 1)


def _with_pitch(one, pitch):
    """one's inputs with a_top as the [..., :d3^2] view of rows ``pitch``
    elements apart, zero in the padding."""
    G, rows, d3sq = one.a_top.shape
    buf = torch.zeros((G, rows, pitch), dtype=one.a_top.dtype)
    buf[..., :d3sq] = one.a_top
    return dataclasses.replace(one, a_top=buf[..., :d3sq])


@pytest.mark.parametrize("extra", [8, 24])
def test_padded_pitch_gives_the_contiguous_result(case, extra):
    """A padded row pitch of a_top (a multiple of 8 elements) passes the
    kernel path's layout check, and the plain solve gives the contiguous
    inputs' result."""
    one = _port_inputs_from_numpy(case)
    pad = _with_pitch(one, one.a_top.shape[2] + extra)
    assert not pad.a_top.is_contiguous() and pad.a_top.stride(1) % 8 == 0
    gs._check_cuda_inputs(pad)
    x1, s1 = gs.solve_group_reference(one, **ITERS)
    x2, s2 = gs.solve_group_reference(pad, **ITERS)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), rtol=0, atol=1e-6 * float(x1.abs().max()))


@pytest.mark.parametrize("extra", [1, 3, 4, 6])
def test_check_cuda_inputs_rejects_other_pitches(case, extra):
    """A row pitch that is not a multiple of 8 elements, and a buffer
    whose groups are not rows x pitch apart, are refused."""
    one = _port_inputs_from_numpy(case)
    G, rows, d3sq = one.a_top.shape
    with pytest.raises(ValueError, match="pitch"):
        gs._check_cuda_inputs(_with_pitch(one, d3sq + extra))
    two = gs.GroupInputs.empty(2, one)
    gs._check_cuda_inputs(two)
    gap = torch.zeros((4, rows, gs.padded_pitch(d3sq + extra)))[::2, :, :d3sq]
    with pytest.raises(ValueError, match="pitch"):
        gs._check_cuda_inputs(dataclasses.replace(two, a_top=gap))


def _random_inputs(rng, G, d3sq, R=2, C_u=3, O=2, l3=4, d2=5):
    """GroupInputs of random values at small shapes (any d3^2)."""

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    return gs.GroupInputs(
        a_top=r(G, C_u * d2 + O * d3sq, d3sq), gz=r(G, R, C_u, l3, l3), mz=r(G, R, O, l3, l3),
        af=r(G, R, O, l3, d3sq).abs(), cn=r(G, R, O, O), deg=r(G, R, O, l3, d3sq).abs(),
        mask=(r(l3, d3sq) > -1).float(), rhs=r(G, R, l3, d3sq), lb=torch.zeros((G, R)),
        ub=torch.ones((G, R)), bn=torch.ones((G, R)), d2=d2,
    )


@pytest.mark.parametrize("d3sq", [30, 36, 44])
def test_group_inputs_empty_pads_a_top(d3sq):
    """GroupInputs.empty gives a_top a pitch of a multiple of 8 elements,
    zero in the padding; put fills it, and the plain matvec and solve give
    the contiguous inputs' results."""
    src = _random_inputs(np.random.default_rng(d3sq), 2, d3sq)
    pad = gs.GroupInputs.empty(2, src)
    for g in range(2):
        one = gs.GroupInputs(**{f.name: getattr(src, f.name)[g : g + 1]
                                if f.name not in ("mask", "d2") else getattr(src, f.name)
                                for f in dataclasses.fields(src)})
        pad.put(g, one)
    P = gs.padded_pitch(d3sq)
    assert P % 8 == 0 and d3sq < P < d3sq + 8
    assert pad.a_top.shape == src.a_top.shape and pad.a_top.stride() == (
        src.a_top.shape[1] * P, P, 1)
    assert torch.equal(pad.a_top, src.a_top)
    buf = torch.as_strided(pad.a_top, (2, src.a_top.shape[1], P), pad.a_top.stride())
    assert not bool(buf[..., d3sq:].any())
    gs._check_cuda_inputs(pad)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(src.rhs.shape, np.float32))
    np.testing.assert_allclose(gs.matvec_reference(pad, X).numpy(),
                               gs.matvec_reference(src, X).numpy(), rtol=1e-6, atol=1e-5)
    _, s1 = gs.solve_group_reference(src, 2, 2, 1)
    _, s2 = gs.solve_group_reference(pad, 2, 2, 1)
    assert bool(torch.isfinite(s1).all())
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,n_sm,want", [
    ((179, 78, 21084, 1444), 132, 1),  # B1's bf16 search launch: the groups fill the card
    ((1, 78, 21084, 1444), 132, 37),  # B1 at one group: 9 K slices a split
    ((8, 6, 21140, 1444), 132, 6),  # B2 / B3 at k = 8
    ((3, 130, 1004, 300), 132, 2),  # few K slices: at least 8 a split
])
def test_k_split_fills_the_card(shape, n_sm, want):
    """The second product's K split, the same for both dtypes (their tiles
    are the same): about 2 tiles per SM, each split >= 8 K slices of 64,
    the splits covering K once."""
    G, M, K, N = shape
    for nsplit_arg, expect in ((None, want), (4, None)):
        kchunk, nsplit = gs.k_split(G, M, K, N, n_sm, nsplit_arg)
        assert nsplit == (expect or nsplit_arg)
        assert kchunk % 64 == 0 and (nsplit - 1) * kchunk < K <= nsplit * kchunk
        if nsplit_arg is None and nsplit > 1:
            assert kchunk >= 8 * 64


@pytest.mark.parametrize("shape,n_sm,want", [
    ((1, 78, 21084, 1444), 132, (512, 3)),  # B1 float32 at one group: 83 tiles -> 249 blocks
    ((1, 78, 11032, 1444), 132, (512, 3)),  # its score pass (data columns): 44 tiles -> 132
    ((8, 6, 21140, 1444), 132, (1444, 1)),  # B2 / B3 at k = 8: 664 tiles fill the card
    ((179, 78, 21084, 1444), 132, (1444, 1)),  # the search's launch
    ((1, 78, 1005, 301), 132, (301, 1)),  # fewer than 16 K slices: never split
])
def test_x_split_fills_the_waves(shape, n_sm, want):
    """The float32 first product's K split: none while the tiles fill the
    card; else the split count (each >= 8 K slices of 32) whose blocks
    fill whole waves best, the splits covering K once."""
    G, M, N, K = shape
    kchunk, nsplit = gs.x_split(G, M, N, K, n_sm)
    assert (kchunk, nsplit) == want
    assert (nsplit - 1) * kchunk < K <= nsplit * kchunk
    assert nsplit == 1 or (kchunk % 64 == 0 and kchunk >= 8 * 32)


@pytest.mark.parametrize("pitch", [300, 304, 320])
def test_product_plain_versions_on_a_padded_view(pitch):
    """gemm_xat / gemm_ga on CPU tensors: the plain products, on a padded
    A as on a contiguous one, against float64 sums of the same values."""
    rng = np.random.default_rng(3)
    G, M, rows, d3sq = 2, 13, 1004, 300
    buf = torch.zeros((G, rows, pitch), dtype=torch.bfloat16)
    buf[..., :d3sq] = torch.from_numpy(rng.standard_normal((G, rows, d3sq), np.float32))
    A = buf[..., :d3sq]
    X = torch.from_numpy(rng.standard_normal((G, M, d3sq), np.float32))
    Gm = torch.from_numpy(rng.standard_normal((G, M, rows), np.float32)).to(torch.bfloat16)
    A64 = A.double().numpy()
    t_want = np.einsum("gmk,gnk->gmn", X.to(torch.bfloat16).double().numpy(), A64)
    y_want = np.einsum("gmr,grd->gmd", Gm.double().numpy(), A64)
    T = gs.gemm_xat(X, A)
    T_nd = gs.gemm_xat(X, A, N=100)
    Y = gs.gemm_ga(Gm, A)
    assert T.shape == (G, M, rows) and T_nd.shape == (G, M, 100) and Y.shape == (1, G, M, d3sq)
    np.testing.assert_allclose(T.numpy(), t_want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(T_nd.numpy(), t_want[..., :100], rtol=0, atol=1e-3)
    np.testing.assert_allclose(Y[0].numpy(), y_want, rtol=0, atol=1e-3)
    launches = gs.launches
    assert torch.equal(T, gs.gemm_xat(X, A.contiguous()))
    assert gs.launches == launches  # CPU tensors never reach the kernel
