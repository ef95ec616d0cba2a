"""Command-line entry points of the port (counterpart of helicon_tpu/commands)."""
