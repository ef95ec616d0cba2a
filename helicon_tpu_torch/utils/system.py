"""Option ordering and the colon parameter mini-language of the option
pipelines (proc3d, images2star).

A copy of ``get_option_list``, ``resolve_option_abbreviations``,
``_coerce_value``, ``parse_param_str``, ``validate_param_dict`` and
``ceil_power_of_10`` from ``helicon_tpu/utils/system.py``; the JAX device
probes stay behind. tests/test_torch_proc3d.py and
tests/test_torch_metadata.py pin the copy to the original.
"""

from __future__ import annotations

import logging
from typing import Any

logger = logging.getLogger(__name__)

__all__ = ["ceil_power_of_10", "get_option_list", "parse_param_str",
           "resolve_option_abbreviations", "validate_param_dict"]


def get_option_list(argv: list[str]) -> list[str]:
    """Return ``--option`` names in the order they appear on the command line.

    The CLI option order IS the execution plan of the proc3d pipeline, so
    ordering must be preserved exactly.
    """
    names = []
    for token in argv:
        if token.startswith("--"):
            names.append(token.split("=", 1)[0].lstrip("-"))
    return names


def resolve_option_abbreviations(options, known):
    """Map argparse-abbreviated option names back to their full names.

    argparse (allow_abbrev=True) accepts e.g. ``--fft`` for
    ``--fft_resample`` and stores the value under the full dest, but
    get_option_list() reads the literal argv token: dispatching the
    abbreviation mid-pipeline would fail with 'Unknown option' after the
    input data has been loaded. Unique prefixes resolve up front;
    ambiguous or unknown names are returned unchanged for the caller's
    own validation to reject early.
    """
    known = list(known)
    resolved = []
    for name in options:
        if name in known:
            resolved.append(name)
            continue
        matches = [k for k in known if k.startswith(name)]
        resolved.append(matches[0] if len(matches) == 1 else name)
    return resolved


def _coerce_value(v: str) -> Any:
    if v.lower() == "true":
        return 1
    if v.lower() == "false":
        return 0
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if len(v) > 2 and v[0] == '"' and v[-1] == '"':
        return v[1:-1]
    return v


def parse_param_str(param_str: str) -> tuple[str | None, dict[str, Any]]:
    """Parse ``[name:]k1=v1:k2=v2`` into ``(name, {k1: v1, k2: v2})``.

    Values are coerced: true/false -> 1/0, then int, then float, then a
    quoted string has its quotes stripped; otherwise kept verbatim. A
    segment without ``=`` is the name if it comes first, otherwise it is
    ignored with an error log.
    """
    name = None
    d: dict[str, Any] = {}
    for pi, seg in enumerate(param_str.split(":")):
        if "=" in seg:
            k, _, v = seg.partition("=")
            d[k] = _coerce_value(v)
        elif pi == 0:
            name = seg
        else:
            logger.error("failed to parse parameter %s. Ignored", seg)
    return name, d


def validate_param_dict(
    param: dict[str, Any], param_ref: dict[str, Any]
) -> tuple[dict[str, Any], dict[str, Any], dict[str, Any]]:
    """Coerce *param* against the typed defaults in *param_ref*.

    Returns ``(final, changed, unsupported)`` where *final* has every key of
    *param_ref* (user value coerced to the default's type, else the default),
    *changed* holds the keys whose final value differs from the default, and
    *unsupported* holds user keys absent from *param_ref*.
    """
    unsupported = {k: v for k, v in param.items() if k not in param_ref}
    final = {
        k: (type(ref)(param[k]) if k in param else ref)
        for k, ref in param_ref.items()
    }
    changed = {k: v for k, v in final.items() if v != param_ref[k]}
    return final, changed, unsupported


def ceil_power_of_10(n: float | int) -> int:
    """Smallest power of 10 that is >= n (with 10 as the floor)."""
    import math

    if n < 0:
        raise ValueError(f"n={n} while n>0 is required")
    if n <= 1:
        return 10
    return 10 ** math.ceil(math.log10(n))
