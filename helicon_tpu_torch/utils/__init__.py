"""Utilities of the port (counterpart of helicon_tpu/utils): exceptions,
system probes and encoders, logging, collections, the cache and paths."""

from .exceptions import *  # noqa: F401,F403
from .system import *  # noqa: F401,F403
from .logging import *  # noqa: F401,F403
from .collections import *  # noqa: F401,F403
from .cache import *  # noqa: F401,F403
from .path_utils import *  # noqa: F401,F403
