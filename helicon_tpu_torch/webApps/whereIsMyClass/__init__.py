"""whereIsMyClass: map 2D class members back to micrograph locations.

Only the compute layer is ported; the Shiny UI (``app.py``) is not
(ROADMAP A11c).
"""

from . import compute  # noqa: F401
