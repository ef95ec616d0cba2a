"""cryosparc option plugins (10 options): the port's counterpart of
``helicon_tpu/ops/cryosparc/``. extractParticles cuts, crops and
normalises on ``args.device`` (default ``cuda``, the card); the exposure
options are host pandas.

Plugin protocol (commands/cryosparc.py:162-187): handle(data, args,
index_d, param, output_title, output_slots, exp_group_id_name,
micrograph_name, original_exp_group_ids) -> (data, output_title,
output_slots, index_d). `data` is a pandas DataFrame in cryosparc
convention (the reference uses cryosparc-tools Datasets).
"""

from __future__ import annotations

from ..registry import add_plugin_args as _add_args
from ..registry import discover_plugins

_plugins = discover_plugins(__name__, __path__)


def dispatch(
    option_name,
    data,
    args,
    index_d,
    param,
    output_title,
    output_slots,
    exp_group_id_name,
    micrograph_name,
    original_exp_group_ids,
):
    p = _plugins.get(option_name)
    if p is None:
        raise ValueError(f"Unknown option: {option_name}")
    return p.handle(
        data,
        args,
        index_d,
        param,
        output_title,
        output_slots,
        exp_group_id_name,
        micrograph_name,
        original_exp_group_ids,
    )


def add_plugin_args(parser):
    _add_args(_plugins, parser)
