"""denovo3D web app: de-novo helical indexing and reconstruction of one
class average, on the card.

The algorithmic layers live in ``helicon_tpu_torch.denovo3d`` and
``helicon_tpu_torch.helix``; the modules here keep the reference's file
layout (``pipeline``, ``solver_linear_regression``, ``utils`` facades and
the shiny-free ``workflow``). ``app.py`` is not ported: it needs ``shiny``.
"""

from . import pipeline, solver_linear_regression, utils, workflow  # noqa: F401
