"""De-novo helical indexing + 3D reconstruction from one 2D class average,
in PyTorch (counterpart of ``helicon_tpu.denovo3d``)."""

from .geometry import (  # noqa: F401
    ReconstructionGeometry,
    back_project_2d_coords_to_3d_coords,
    compute_sym_dedup_mask,
    select_copies,
    select_pair_ops,
    select_pairs,
    sorted_hsym_csym_pairs,
)
from .checkpoint import reconstruct_grid_checkpointed  # noqa: F401
from .grid import GridResult, build_candidate_grid, reconstruct_grid  # noqa: F401
from .pipeline import process_one_task  # noqa: F401
from .solver import lsq_reconstruct  # noqa: F401
