"""whereIsMyClass: map 2D class members back to micrograph locations.

``compute`` holds the computation; the Shiny Express ``app`` (it needs
``shiny``) runs it on ``DEVICE``.
"""

# the device of the app's computations (``app`` reads it at its import)
DEVICE = "cuda"

from . import compute  # noqa: F401,E402
