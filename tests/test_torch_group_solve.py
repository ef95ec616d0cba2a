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
