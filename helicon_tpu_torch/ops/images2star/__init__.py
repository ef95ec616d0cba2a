"""images2star option plugins (reference: plugins/images2star/, 52 options).

The port's counterpart of ``helicon_tpu/ops/images2star/``. Options are
grouped into themed modules; each exports a PLUGINS list.
dispatch()/add_plugin_args() mirror the reference registry
(plugins/images2star/__init__.py:33-45). A handler reads the torch device
of its pixel work from ``args.device`` (default ``cuda``, the card).
"""

from __future__ import annotations

from ..registry import add_plugin_args as _add_args
from ..registry import discover_plugins, dispatch as _dispatch

_plugins = discover_plugins(__name__, __path__)


def dispatch(option_name, data, args, index_d, param):
    return _dispatch(_plugins, option_name, data, args, index_d, param)


def add_plugin_args(parser):
    _add_args(_plugins, parser)
