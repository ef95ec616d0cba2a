"""Option-pipeline plugin registries of the port (proc3d), as
``helicon_tpu/ops`` has them: a module exports a PLUGINS list of Plugin
records."""

from .registry import Plugin, discover_plugins  # noqa: F401
