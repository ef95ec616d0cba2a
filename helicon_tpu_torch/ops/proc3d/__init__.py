"""proc3d option plugins of the port (``helicon_tpu/ops/proc3d``).

Plugin protocol: handle(data, args, index_d, param, apix, nx, ny, nz) ->
(data, apix, nx, ny, nz). The pipeline threads the map (a float32 tensor
on the command's device) and its voxel size through the options in their
command-line order.
"""

from __future__ import annotations

from ..registry import add_plugin_args as _add_args
from ..registry import discover_plugins

_plugins = discover_plugins(__name__, __path__)


def dispatch(option_name, data, args, index_d, param, apix, nx, ny, nz):
    p = _plugins.get(option_name)
    if p is None:
        raise ValueError(f"Unknown option: {option_name}")
    return p.handle(data, args, index_d, param, apix, nx, ny, nz)


def add_plugin_args(parser):
    _add_args(_plugins, parser)
