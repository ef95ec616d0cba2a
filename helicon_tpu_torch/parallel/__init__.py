"""Parallel execution of the port (counterpart of helicon_tpu/parallel).

Several devices inside one process: ``reconstruct_grid(devices=[...])``
deals the candidate grid to one shard per entry (whole twist groups on the
grouped path, launches of k candidates per candidate), each shard on its
own device, driven by a thread of its own; :func:`distributed_reconstruct_grid`
calls it on every visible card. Per-candidate solves never communicate, so
the scores are simply put together on the host. The helpers below are the
reference's mesh utilities in torch's idiom: a list of devices where the
reference has a ``Mesh``, one tensor per device where it has a sharded
array. Process-sharded grids over ``torch.distributed`` live in
:mod:`.multihost`.
"""

from __future__ import annotations

import numpy as np
import torch

from .multihost import (  # noqa: F401
    initialize,
    is_distributed,
    is_writer,
    multihost_reconstruct_grid,
    process_candidate_slice,
    shutdown,
)

__all__ = [
    "candidate_mesh",
    "candidate_sharding",
    "distributed_reconstruct_grid",
    "image_candidate_mesh",
    "initialize",
    "is_distributed",
    "is_writer",
    "multihost_reconstruct_grid",
    "pad_to_multiple",
    "process_candidate_slice",
    "shard_batch",
    "shard_slices",
    "shutdown",
]


def _visible_cards() -> list:
    """Every CUDA card this process sees, as torch.devices; raises without
    one (nothing falls back to the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible: pass devices= (e.g. ['cpu'])")
    return [torch.device("cuda", i) for i in range(n)]


def candidate_mesh(devices=None) -> list:
    """The devices a grid is sharded over: every visible card, or the given
    ones (torch.devices, strings or card indices), as torch.devices."""
    if devices is None:
        return _visible_cards()
    return [torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
            for d in devices]


def image_candidate_mesh(devices=None, n_image_shards: int | None = None) -> list:
    """The devices as an (images, candidates) grid, a list of n_image_shards
    rows, for the multi-image batch workload (many class averages x one
    candidate grid): n_image_shards defaults to the largest power of 2 that
    divides the device count and is at most its square root, the
    reference's rule."""
    devices = candidate_mesh(devices)
    n = len(devices)
    if n_image_shards is None:
        n_image_shards = 1
        while n_image_shards * 2 <= int(np.sqrt(n)) and n % (n_image_shards * 2) == 0:
            n_image_shards *= 2
    if n % n_image_shards:
        raise ValueError(f"{n} devices do not split into {n_image_shards} image shards")
    per = n // n_image_shards
    return [devices[i * per:(i + 1) * per] for i in range(n_image_shards)]


def shard_slices(n: int, n_shards: int) -> list:
    """One contiguous slice of range(n) per shard, in order, the first
    n % n_shards shards one longer (numpy's array_split rule); a shard may
    be empty when n < n_shards."""
    base, extra = divmod(int(n), int(n_shards))
    out, start = [], 0
    for i in range(n_shards):
        stop = start + base + (i < extra)
        out.append(slice(start, stop))
        start = stop
    return out


def candidate_sharding(n: int, devices) -> list:
    """(slice of the leading axis, device) of each shard of a batch of n
    items over ``devices`` (see shard_slices)."""
    devices = candidate_mesh(devices)
    return list(zip(shard_slices(n, len(devices)), devices))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad by repeating the last slice so axis length % multiple == 0."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if not pad:
        return x
    last = np.take(x, [-1], axis=axis)
    reps = [1] * x.ndim
    reps[axis] = pad
    return np.concatenate([x, np.tile(last, reps)], axis=axis)


def shard_batch(arrays, devices):
    """Split the leading axis of each array of a tuple, list or dict (or of
    one array) into one contiguous shard per device, each moved to its
    device: a list with one structure like ``arrays`` per device. numpy
    arrays become tensors."""
    devices = candidate_mesh(devices)

    def leaves(a):
        if isinstance(a, dict):
            return list(a.values())
        return list(a) if isinstance(a, (tuple, list)) else [a]

    lengths = {len(x) for x in leaves(arrays)}
    if len(lengths) != 1:
        raise ValueError(f"the arrays' leading axes differ: {sorted(lengths)}")
    out = []
    for sl, dev in candidate_sharding(lengths.pop(), devices):
        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x[sl]) if isinstance(x, np.ndarray)
                                   else x[sl]).to(dev)
        if isinstance(arrays, dict):
            out.append({k: put(v) for k, v in arrays.items()})
        elif isinstance(arrays, (tuple, list)):
            out.append(type(arrays)(put(v) for v in arrays))
        else:
            out.append(put(arrays))
    return out


def distributed_reconstruct_grid(image, apix, twists, rises, devices=None, **kwargs):
    """reconstruct_grid sharded over every visible card (or the given
    devices) inside this process: the sharding lives in reconstruct_grid,
    this only selects the devices, as the reference's does."""
    from ..denovo3d import reconstruct_grid

    return reconstruct_grid(image, apix, twists, rises, devices=candidate_mesh(devices),
                            **kwargs)
