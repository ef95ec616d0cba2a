"""Plugin discovery and dispatch of the option pipelines (proc3d).

A copy of ``helicon_tpu/ops/registry.py``: each plugin has option_name
(the CLI flag), add_args(parser) and handle(...). The CLI order of the
options is the execution plan. tests/test_torch_proc3d.py pins the copy to
the original.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Plugin:
    option_name: str
    add_args: Callable
    handle: Callable


def plugin(option_name: str, add_args: Callable):
    """Decorator: build a Plugin from a handle function."""

    def wrap(fn):
        return Plugin(option_name=option_name, add_args=add_args, handle=fn)

    return wrap


def discover_plugins(package_name: str, package_path) -> dict:
    """Scan a package's modules for Plugin records or the module-level
    (option_name, handle) protocol; return {option_name: Plugin}."""
    plugins: dict = {}
    for _, modname, ispkg in pkgutil.iter_modules([str(p) for p in package_path]):
        if modname.startswith("_") or ispkg:
            continue
        mod = importlib.import_module(f".{modname}", package_name)
        found = getattr(mod, "PLUGINS", None)
        if found:
            for p in found:
                plugins[p.option_name] = p
        elif hasattr(mod, "option_name") and hasattr(mod, "handle"):
            plugins[mod.option_name] = Plugin(
                mod.option_name, getattr(mod, "add_args", lambda p: None), mod.handle
            )
    return plugins


def dispatch(plugins: dict, option_name: str, data, args, index_d, param):
    p = plugins.get(option_name)
    if p is None:
        raise ValueError(f"Unknown option: {option_name}")
    return p.handle(data, args, index_d, param)


def add_plugin_args(plugins: dict, parser):
    seen = set()
    for p in plugins.values():
        if id(p.add_args) in seen:
            continue
        seen.add(id(p.add_args))
        p.add_args(parser)
