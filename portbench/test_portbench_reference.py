"""The benchmark's plain reference against the port's plain path (CPU
tensors), at a tiny grid: scores, ranking and best volume, on both of the
port's scoring paths and both interpolations; and the frozen counts
against the port's cost_analysis at the same geometry."""

import numpy as np
import pytest
import torch

from portbench.harness import cell as cell_mod
from portbench.harness import check, counts
from portbench.harness.traffic import make_stack, pool
from portbench.reference import search as ref

IMAGE = dict(ny=64, nx=128, apix=2.0, helical_diameter_A=100.0, ball_radius_A=4.0,
             balls_per_unit=12, band_limit_A=8.0, noise_fraction=0.3)
KW = dict(apix=2.0, transpose=-1, horizontalize=1, tube_diameter=110.0, cg_iters=4,
          fista_iters=3, power_iters=2, positive_constraint=-1)
GRIDS = {
    # two rises a twist: the grouped path (B1's plain version)
    "grouped": (np.array([1.0, 1.0, 2.0, 2.0], np.float32),
                np.array([4.6, 4.75, 4.6, 4.75], np.float32)),
    # one rise a twist: the per-candidate path (B2's plain version)
    "percand": (np.array([1.0, 2.0, 3.0], np.float32), np.array([4.75, 4.75, 4.75], np.float32)),
}


@pytest.fixture(scope="module")
def image():
    return make_stack(IMAGE, dict(twist_abs=[1.0, 3.0], rise=[4.6, 4.9]), 1, 2 ** 31 + 5,
                      "cpu").images[0]


def _program(image, twists, rises, **kw):
    from helicon_tpu_torch.denovo3d import reconstruct_grid

    return reconstruct_grid(image, twists=twists, rises=rises, device="cpu",
                            compute_dtype="float32", return_best_volume=True,
                            cost_analysis=True, **kw)


@pytest.mark.parametrize("interpolation", ["nn", "linear"])
@pytest.mark.parametrize("path", sorted(GRIDS))
def test_reference_matches_the_ports_plain_path(image, path, interpolation):
    twists, rises = GRIDS[path]
    kw = dict(KW, interpolation=interpolation)
    res = _program(image, twists, rises, **kw)
    assert res.effective["path"] == path
    s, sc = check.reference(image, kw, twists, rises, "cpu")
    readings = check.numbers(check.outcome(0, res), s, sc)
    assert readings["geometry_mismatch"] == 0
    assert readings["score_gap"] < 1e-5
    assert res.best_index == int(np.argmax(sc))
    assert readings["volume_determinacy"] <= check.DETERMINED
    assert readings["volume_err"] < 1e-5


@pytest.mark.parametrize("path", sorted(GRIDS))
def test_frozen_counts_match_the_ports_cost_analysis(image, path):
    twists, rises = GRIDS[path]
    res = _program(image, twists, rises, **KW)
    s = ref.setup(image, KW, twists, rises, "cpu")
    work = counts.search_work(s, KW, "float32")
    cost = res.cost
    per = work.flops / work.n_candidates
    assert per == pytest.approx(cost["analytic_flops_per_candidate"], rel=1e-12)
    iters = (KW["cg_iters"], KW["fista_iters"], KW["power_iters"])
    nm = counts.n_matvecs(iters)
    d3sq = s.geom.d3 ** 2
    if path == "grouped":
        # the port counts one group of R, A_top streamed once per product
        # (two a matvec); the benchmark counts every group, A_top read once
        C_u = res.effective["C_u"]
        a_top = (C_u * s.geom.d2 + s.n_ops * d3sq) * d3sq * 4
        groups = res.effective["n_groups"]
        R = res.effective["R"]
        assert groups == counts.group_count(s.geom, twists, s.n_copies, s.n_ops, None)
        one_group = work.bytes / groups if len(twists) == groups * R else None
        assert one_group is not None
        assert cost["bytes_accessed"] == pytest.approx(one_group + (2 * nm - 1) * a_top,
                                                       rel=1e-12)
    else:
        operand = (s.n_copies * s.geom.d2 + s.n_ops * d3sq) * d3sq * 4
        k = cost["batch_size"]
        n = len(twists)
        assert k == n
        assert cost["bytes_accessed"] == pytest.approx(
            work.bytes + n * (2 * nm - 1) * operand, rel=1e-12)


def test_control_is_further_from_the_reference_than_float32(image):
    """The control (float8 scoring) reads far above the program's float32
    path at a tiny grid, which the CPU can hold."""
    twists, rises = GRIDS["grouped"]
    s, sc = check.reference(image, KW, twists, rises, "cpu")
    control = check.numbers(check.control_outcome(s), s, sc)
    res = _program(image, twists, rises, **KW)
    program = check.numbers(check.outcome(0, res), s, sc)
    assert control["score_gap"] > 100 * max(program["score_gap"], 1e-6)
    # against the cells' limits only at their own sizes (on the card, below)


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card():
    """The control at each cell's own size, on three of its pool's class
    averages, fails the cell's limits (``calibrate.py`` gives the
    readings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for name in ("amyloid_2A_nn.cli_stack", "amyloid_2A_nn.known_rise",
                 "filament_1A_linear.fine_grid"):
        c = cell_mod.load(name)
        twists, rises = c.grid()
        stack = pool(c.config["image"], c.traffic, dev)
        for image in stack.images[:3]:
            s, sc = check.reference(image, c.search_kwargs, twists, rises, dev)
            control = check.numbers(check.control_outcome(s), s, sc)
            limits = c.checks["limits"]
            assert any(control[k] is not None and control[k] > limits[k] for k in limits)


def test_fp8_rounding_keeps_small_integers():
    from portbench.reference.solve import Rounding

    a = torch.tensor([[0.0, 1.0, 2.0, 3.0, 7.0]])
    assert torch.equal(Rounding("fp8")(a), a)
    b = torch.tensor([[1.0, 1.07, 100.3]])
    assert not torch.equal(Rounding("fp8")(b), b)
    assert torch.equal(Rounding("float32")(b), b)
