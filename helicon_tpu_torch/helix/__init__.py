"""Helical-assembly utilities of the port (counterpart of helicon_tpu/helix)."""

from .orient import (
    auto_horizontalize,
    generate_xyz_projections,
    is_vertical,
    symmetrize_transform_map,
    tilt_psi_dy_str,
)
from .simulate import helical_unit_positions, random_polymer, simulate_helical_projection

__all__ = ["auto_horizontalize", "generate_xyz_projections", "helical_unit_positions",
           "is_vertical", "random_polymer", "simulate_helical_projection",
           "symmetrize_transform_map", "tilt_psi_dy_str"]
