"""File formats of the port (counterpart of helicon_tpu/io)."""
