"""The device's busy time over a traced slice of the window, from
torch.profiler recording the device's activity alone (kernels, copies,
sets, and the CUDA runtime calls that launch them): the union of the
device's intervals, the device operations that took most time, and the
idle gaps, each named by the runtime call running across its middle or
else by the device operation it ends before (the host was preparing that
launch), summed by name: the device idles in many short gaps between
launches more than in a few long ones."""

from __future__ import annotations

import bisect
import collections
import dataclasses

NAME_CHARS = 160  # a kernel's name is cut to this many characters


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: list  # [[name, seconds], ...] most time first, at most 10
    idle_gaps: list  # [[name, seconds], ...] summed by name, most first, at most 10
    n_device_events: int


def _events(prof):
    """(device intervals [(start_us, end_us, name)], host runtime calls
    [(start_us, end_us, name)]) of a finished profile, in microseconds from
    the profile's start."""
    dev, host = [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if end <= start:
            continue
        kind = str(getattr(e, "device_type", "")).lower()
        if "cuda" in kind:
            dev.append((start, end, e.name))
        elif "cpu" in kind:
            host.append((start, end, e.name))
    return dev, host


def summarize(prof, window_s: float) -> TraceSummary | None:
    """A profile that spans a slice of ``window_s`` host seconds, begun just
    before the slice and ended after its last synchronisation: None where it
    holds no device interval (no device trace)."""
    dev, host = _events(prof)
    if not dev:
        return None
    per_op = collections.Counter()
    for s, e, n in dev:
        per_op[n] += (e - s) * 1e-6
    dev.sort()
    end_us = window_s * 1e6
    busy, gaps = 0.0, []  # gaps: (start_us, end_us, the next device op)
    cur_s, cur_e = dev[0][0], dev[0][1]
    if cur_s > 0:
        gaps.append((0.0, cur_s, dev[0][2]))
    for s, e, n in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s, n))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if cur_e < end_us:
        gaps.append((cur_e, end_us, "the slice's end"))
    host.sort()
    starts = [h[0] for h in host]
    per_gap = collections.Counter()
    for gs, ge, nxt in gaps:
        mid = 0.5 * (gs + ge)
        # the runtime call begun last before the gap's middle, if it runs across it
        i = bisect.bisect_right(starts, mid) - 1
        name = host[i][2] if i >= 0 and host[i][1] >= mid else f"host, before {nxt}"
        per_gap[name[:NAME_CHARS]] += (ge - gs) * 1e-6
    return TraceSummary(busy_s=busy * 1e-6, window_s=window_s,
                        device_ops=[[n[:NAME_CHARS], s] for n, s in per_op.most_common(10)],
                        idle_gaps=[[n, t] for n, t in per_gap.most_common(10)],
                        n_device_events=len(dev))
