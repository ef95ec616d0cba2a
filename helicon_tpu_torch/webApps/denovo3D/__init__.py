"""denovo3D web app: de-novo helical indexing and reconstruction of one
class average, on the card.

The algorithmic layers live in ``helicon_tpu_torch.denovo3d`` and
``helicon_tpu_torch.helix``; the modules here keep the reference's file
layout (``pipeline``, ``solver_linear_regression``, ``utils`` facades,
the shiny-free ``workflow`` and the Shiny Express ``app``, which needs
``shiny``).
"""

# the device of the app's computations (``app`` reads it at its import)
DEVICE = "cuda"

from . import pipeline, solver_linear_regression, utils, workflow  # noqa: F401,E402
