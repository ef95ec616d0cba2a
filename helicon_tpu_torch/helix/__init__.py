"""Helical-assembly utilities of the port (counterpart of helicon_tpu/helix)."""

from .simulate import helical_unit_positions, random_polymer, simulate_helical_projection

__all__ = ["helical_unit_positions", "random_polymer", "simulate_helical_projection"]
