"""helicon-tpu-torch: the PyTorch / CUDA port of helicon-tpu for NVIDIA
Hopper GPUs.

The JAX package ``helicon_tpu`` stays the reference; this package mirrors
its module paths and imports no JAX. It covers the de-novo helical
indexing grid search (``helicon_tpu_torch.denovo3d.reconstruct_grid``) in
its default configuration; ROADMAP.md lists what is still to port.
"""

__version__ = "2026.08"
