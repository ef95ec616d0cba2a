"""Typed exceptions for clean CLI error handling.

A copy of ``helicon_tpu/utils/exceptions.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_drivers.py`` pins it to the original.
"""

__all__ = [
    "HeliconExit",
    "HeliconError",
    "HeliconValueError",
    "HeliconIOError",
    "HeliconTypeError",
    "HeliconValidationError",
    "HeliconFileExistsError",
    "HeliconConfigError",
    "HeliconDependencyError",
]


class HeliconExit(SystemExit):
    """Raised to request a clean, non-error program exit."""


class HeliconError(Exception):
    """Base class for all helicon-tpu errors."""


class HeliconValueError(HeliconError, ValueError):
    """Invalid value supplied by the user."""


class HeliconIOError(HeliconError, IOError):
    """File or network I/O failure."""


class HeliconTypeError(HeliconError, TypeError):
    """Value of an unexpected type."""


class HeliconValidationError(HeliconError):
    """Input data failed validation."""


class HeliconFileExistsError(HeliconError, FileExistsError):
    """Refusing to overwrite an existing file."""


class HeliconConfigError(HeliconError):
    """Invalid configuration or parameter string."""


class HeliconDependencyError(HeliconError, ImportError):
    """An optional dependency is required but unavailable."""
