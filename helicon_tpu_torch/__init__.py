"""helicon-tpu-torch: the PyTorch / CUDA port of helicon-tpu for NVIDIA
Hopper GPUs.

The JAX package ``helicon_tpu`` stays the reference; this package mirrors
its module paths and its flat namespace (``import helicon_tpu_torch as
ht``; ``helicon_tpu/__init__.py``) and imports no JAX. The TPU-only
``enable_jax_compilation_cache`` and ``fft`` (the matmul DFT) are not
ported. An array function of the namespace keeps a tensor on its device
and takes numpy to its keyword ``device``, the card unless the caller
asks for the CPU.
"""

__version__ = "2026.08"

from .utils.cache import setup_cache_dir as _setup_cache_dir

# module-level cache dir, created at import (reference __init__.py:216)
cache_dir = _setup_cache_dir()

# names that are not the submodule they load (any submodule loads by its
# own name below)
_ALIASES = {"apps": ".webApps", "dataset": ".io.dataset"}


def _load_namespace():
    """The flat namespace's names (``_namespace.py``), bound here at the
    first access of one of them."""
    import importlib

    ns = importlib.import_module("._namespace", __name__)
    names = [n for n in vars(ns) if not n.startswith("_")]
    globals().update({n: getattr(ns, n) for n in names})
    return names


def __getattr__(name):
    """Lazy access to the flat namespace and the heavier subsystems (io,
    helix, denovo3d, ...)."""
    import importlib
    import importlib.util

    if name == "EMDB":
        return importlib.import_module(".io.dataset", __name__).EMDB
    if name in _ALIASES:
        return importlib.import_module(_ALIASES[name], __name__)
    if name == "__all__":
        return sorted(_load_namespace() + ["cache_dir"])
    if name.startswith("_"):
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if importlib.util.find_spec(f"{__name__}.{name}") is not None:
        # a submodule (``from helicon_tpu_torch import angular`` inside the
        # package must not load the namespace, which imports that module)
        return importlib.import_module(f".{name}", __name__)
    if name in _load_namespace():
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_load_namespace()) | set(_ALIASES) | {"EMDB"})
