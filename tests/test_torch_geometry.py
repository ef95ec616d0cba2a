"""The PyTorch port's host tables are copies of the JAX package's: every
function of denovo3d/geometry.py and the grid's table builders must give
bit-identical outputs on the same inputs."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import helicon_tpu.denovo3d.geometry as ref
import helicon_tpu.denovo3d.grid as ref_grid
import helicon_tpu_torch.denovo3d.geometry as port
import helicon_tpu_torch.denovo3d.grid as port_grid

# (twist deg, rise px, csym, inner radius px)
CASES = [
    (29.4, 1.5, 1, 0.0),
    (-2.0, 1.58, 1, 0.0),
    (60.0, 2.3, 2, 2.0),
    (-178.5, 0.9, 3, 0.0),
]


def _geoms(csym, rmin):
    ref_g = ref.ReconstructionGeometry(
        d2=14, l2=32, d3=12, l3=6, rmin=rmin, rmax=5.0, scale2d_to_3d=0.858, csym=csym
    )
    port_g = port.ReconstructionGeometry(
        d2=14, l2=32, d3=12, l3=6, rmin=rmin, rmax=5.0, scale2d_to_3d=0.858, csym=csym
    )
    return ref_g, port_g


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 7, 64, 333])
def test_halton_permutation(n):
    _same(ref.halton_permutation(n), port.halton_permutation(n))


@pytest.mark.parametrize("case", CASES)
def test_geometry_masks_and_extents(case):
    twist, rise, csym, rmin = case
    rg, pg = _geoms(csym, rmin)
    assert rg.volume_shape == pg.volume_shape
    _same(rg.cylindrical_mask(), pg.cylindrical_mask())
    _same(rg.cell_valid_mask(), pg.cell_valid_mask())
    assert rg.hsym_max_data(rise) == pg.hsym_max_data(rise)
    assert rg.hsym_max_pairs(rise) == pg.hsym_max_pairs(rise)


@pytest.mark.parametrize("case", CASES)
def test_copy_and_pair_selection(case):
    twist, rise, csym, rmin = case
    rg, pg = _geoms(csym, rmin)
    n_copies, n_pairs = ref.estimate_copy_pair_counts(rg, rise, 4, rise_pixel_max=rise * 1.2)
    assert (n_copies, n_pairs) == port.estimate_copy_pair_counts(
        pg, rise, 4, rise_pixel_max=rise * 1.2
    )
    n_ops = ref.estimate_n_pair_ops(rg, rise)
    assert n_ops == port.estimate_n_pair_ops(pg, rise)
    _same(ref.select_copies(rg, rise, n_copies), port.select_copies(pg, rise, n_copies))
    _same(ref.select_pairs(rg, twist, rise, n_pairs), port.select_pairs(pg, twist, rise, n_pairs))
    _same(
        ref.select_pair_ops(rg, twist, rise, n_pairs, n_ops),
        port.select_pair_ops(pg, twist, rise, n_pairs, n_ops),
    )
    assert ref.sorted_hsym_csym_pairs(twist, rise, csym, 6) == port.sorted_hsym_csym_pairs(
        twist, rise, csym, 6
    )
    hc, pv = ref.select_pairs(rg, twist, rise, n_pairs)
    _same(
        ref.compute_sym_dedup_mask(rg, twist, rise, hc, pv),
        port.compute_sym_dedup_mask(pg, twist, rise, hc, pv),
    )


@pytest.mark.parametrize("scale", [1.0, 0.75])
def test_back_project_coords(scale):
    img = np.random.default_rng(3).random((20, 30)).astype(np.float32)
    _same(
        ref.back_project_2d_coords_to_3d_coords(img, scale, 14, 24),
        port.back_project_2d_coords_to_3d_coords(img, scale, 14, 24),
    )


@pytest.mark.parametrize("case", CASES)
def test_grid_tables(case):
    twist, rise, csym, rmin = case
    rg, pg = _geoms(csym, rmin)
    rises = np.asarray([rise, rise * 1.05, rise * 1.1], np.float32)
    twists = np.full(3, twist, np.float32)
    n_copies, n_pairs = ref.estimate_copy_pair_counts(
        rg, float(rises.min()), 4, rise_pixel_max=float(rises.max())
    )
    n_ops = ref.estimate_n_pair_ops(rg, float(rises.min()))
    _same(
        ref_grid._candidate_tables(rg, twists, rises, n_copies, n_pairs, n_ops),
        port_grid._candidate_tables(pg, twists, rises, n_copies, n_pairs, n_ops),
    )
    u = set()
    for r in rises:
        ch, cc, cv = ref.select_copies(rg, float(r), n_copies)
        u.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    for R_pad in (3, 5):
        _same(
            ref_grid._group_tables(rg, twist, rises, n_copies, n_pairs, n_ops, len(u), R_pad, {}),
            port_grid._group_tables(pg, twist, rises, n_copies, n_pairs, n_ops, len(u), R_pad, {}),
        )


@pytest.mark.parametrize(
    "args",
    [
        (1.0, 3.0, 0.25, 4.45, 5.06, 0.15, "left"),
        (0.5, 45.0, 0.25, 4.0, 5.0, 0.08, "both"),
        (2.0, 2.0, 0.1, 4.75, 4.75, 0.1, "right"),
    ],
)
def test_build_candidate_grid(args):
    _same(ref_grid.build_candidate_grid(*args), port_grid.build_candidate_grid(*args))
