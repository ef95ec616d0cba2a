"""Small container helpers used across the framework.

A copy of ``helicon_tpu/utils/collections.py`` (host code:
numpy and pandas); tests/test_torch_metadata.py pins the copy to the original.

Parity: reference lib/collections.py:20-331.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Iterable

import numpy as np

__all__ = [
    "unique",
    "assign_to_groups",
    "flatten",
    "order_by_unique_counts",
    "split_array",
    "unique_attr_name",
    "all_matched_attrs",
    "first_matched_attr",
    "DotDict",
]


def unique(values: Iterable) -> list:
    """Unique elements, first-occurrence order preserved."""
    seen = []
    for v in values:
        if v not in seen:
            seen.append(v)
    return seen


def assign_to_groups(numbers: Iterable, group_size: int) -> dict:
    """Sort values, then pack them into groups of up to *group_size*.

    Duplicate values always land in the same group. A trailing group
    smaller than half of *group_size* is merged into the previous group.
    Returns a mapping value -> 1-based group id.
    """
    ordered = sorted(numbers)
    by_value: dict[Any, int] = defaultdict(int)
    for v in ordered:
        by_value[v] += 1

    result: dict[Any, int] = {}
    group_id = 1
    current: list[Any] = []
    count = 0
    for value, n in by_value.items():
        if count + n > group_size:
            if current:
                for v in current:
                    result[v] = group_id
                group_id += 1
            current = [value] * n
            count = n
        else:
            current.extend([value] * n)
            count += n
        if count == group_size:
            for v in current:
                result[v] = group_id
            group_id += 1
            current = []
            count = 0
    if current:
        if len(current) < group_size // 2 and result:
            gid = max(result.values())
        else:
            gid = group_id
        for v in current:
            result[v] = gid
    return result


def flatten(nested, ltypes: tuple = (list, tuple)) -> list | tuple:
    """Flatten arbitrarily nested lists/tuples into a single level."""
    out_type = type(nested) if type(nested) in ltypes else list
    out = []
    stack = list(reversed(list(nested)))
    while stack:
        item = stack.pop()
        if isinstance(item, ltypes):
            stack.extend(reversed(list(item)))
        else:
            out.append(item)
    return out_type(out)


def order_by_unique_counts(labels, ignoreNegative: bool = True) -> list:
    """Relabel values by decreasing frequency (most frequent -> 0)."""
    labels = np.asarray(labels)
    if ignoreNegative:
        positive = labels[labels >= 0]
        uniq, counts = np.unique(positive, return_counts=True)
        order = np.argsort(counts)[::-1]
        mapping = {uniq[idx]: rank for rank, idx in enumerate(order)}
        mapping.update({v: v for v in np.unique(labels[labels < 0])})
    else:
        uniq, counts = np.unique(labels, return_counts=True)
        order = np.argsort(counts)[::-1]
        mapping = {uniq[idx]: rank for rank, idx in enumerate(order)}
    return [mapping[v] for v in labels]


def split_array(arr: list) -> tuple[list, list]:
    """Partition indices into two groups with near-equal sums (subset-sum DP)."""
    total = sum(arr)
    target = total // 2
    n = len(arr)

    reachable = np.zeros((n + 1, target + 1), dtype=bool)
    reachable[:, 0] = True
    for i in range(1, n + 1):
        v = arr[i - 1]
        reachable[i] = reachable[i - 1]
        if v <= target:
            reachable[i, v:] |= reachable[i - 1, : target + 1 - v]

    achieved = int(np.max(np.nonzero(reachable[n])[0])) if target >= 0 else 0

    group1 = []
    i, j = n, achieved
    while i > 0 and j > 0:
        if not reachable[i - 1, j]:
            group1.append(i - 1)
            j -= arr[i - 1]
        i -= 1
    group1_set = set(group1)
    group2 = [k for k in range(n) if k not in group1_set]
    return group1, group2


def unique_attr_name(data, attr_prefix: str) -> str:
    """First name ``{prefix}``, ``{prefix}2``, ``{prefix}3``, ... not in *data*."""
    if attr_prefix not in data:
        return attr_prefix
    i = 2
    while f"{attr_prefix}{i}" in data:
        i += 1
    return f"{attr_prefix}{i}"


def all_matched_attrs(data, query_str: str) -> list:
    """All column names containing *query_str* (DataFrame or mapping-like)."""
    import pandas as pd

    if isinstance(data, pd.DataFrame):
        cols = list(data.columns)
    elif hasattr(data, "keys"):
        cols = list(data.keys())
    else:
        raise TypeError(
            f"all_matched_attrs(data, query_str): unsupported data type {type(data)}"
        )
    return [c for c in cols if query_str in c]


def first_matched_attr(data, attrs: list) -> str | None:
    """First candidate attribute present in *data*, else None."""
    for attr in attrs:
        if attr in data:
            return attr
    return None


class DotDict(dict):
    """dict with attribute-style access (``d.key`` == ``d["key"]``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value
