"""Utilities of the port (counterpart of helicon_tpu/utils)."""
