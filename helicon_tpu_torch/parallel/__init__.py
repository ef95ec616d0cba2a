"""Parallel execution of the port (counterpart of helicon_tpu/parallel).

Process-sharded candidate grids over ``torch.distributed`` live in
:mod:`.multihost`. Several devices inside one process
(``reconstruct_grid(devices=[...])``, :func:`distributed_reconstruct_grid`)
are not ported yet (ROADMAP A10b) and raise.
"""

from .multihost import (  # noqa: F401
    initialize,
    is_distributed,
    is_writer,
    multihost_reconstruct_grid,
    process_candidate_slice,
    shutdown,
)


def distributed_reconstruct_grid(image, apix, twists, rises, devices=None, **kwargs):
    """Several devices inside one process: not ported yet. Run one process
    per card with :func:`multihost_reconstruct_grid` instead."""
    raise NotImplementedError(
        "more than one device in one process is not ported yet (ROADMAP A10b); run one "
        "process per card (torchrun) with multihost_reconstruct_grid")
