"""Helical-assembly utilities of the port (counterpart of helicon_tpu/helix)."""

from .orient import auto_horizontalize, is_vertical
from .simulate import helical_unit_positions, random_polymer, simulate_helical_projection

__all__ = ["auto_horizontalize", "helical_unit_positions", "is_vertical", "random_polymer",
           "simulate_helical_projection"]
