"""Helical-assembly utilities of the port (counterpart of helicon_tpu/helix)."""

from .indexing import (
    LayerLine,
    bessel_first_peak_x,
    detect_layer_lines,
    detect_layer_lines_batch,
    estimate_bessel_order,
    estimate_helical_parameters,
    layer_line_profiles,
)
from .lattice import (
    helical_lattice_points,
    lattice_vectors_from_parameters,
    parameters_from_lattice_vectors,
)
from .orient import (
    auto_horizontalize,
    generate_xyz_projections,
    is_vertical,
    symmetrize_transform_map,
    tilt_psi_dy_str,
)
from .pitch import estimate_pitch_from_class2d, estimate_pitch_from_pair_distances
from .simulate import helical_unit_positions, random_polymer, simulate_helical_projection

__all__ = ["LayerLine", "auto_horizontalize", "bessel_first_peak_x", "detect_layer_lines",
           "detect_layer_lines_batch", "estimate_bessel_order", "estimate_helical_parameters",
           "estimate_pitch_from_class2d", "estimate_pitch_from_pair_distances",
           "generate_xyz_projections", "helical_lattice_points", "helical_unit_positions",
           "is_vertical", "lattice_vectors_from_parameters", "layer_line_profiles",
           "parameters_from_lattice_vectors", "random_polymer", "simulate_helical_projection",
           "symmetrize_transform_map", "tilt_psi_dy_str",
           # the submodules, which the flat namespace re-exports as the
           # reference's star import does
           "indexing", "lattice", "orient", "pitch", "simulate"]
