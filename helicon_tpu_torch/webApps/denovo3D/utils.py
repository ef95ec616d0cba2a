"""Facade matching the reference's ``webApps/denovo3D/utils.py``."""

from ...helix import (  # noqa: F401
    auto_horizontalize,
    generate_xyz_projections,
    helical_unit_positions,
    is_vertical,
    random_polymer,
    simulate_helical_projection,
    symmetrize_transform_map,
    tilt_psi_dy_str,
)
