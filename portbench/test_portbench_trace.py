"""The reading of a device trace, on a profile made by hand: the device's
busy union, its operations by time, and the idle gaps named and summed."""

import types

import pytest

from portbench.harness import trace


def _event(name, start, end, kind):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start,
                                                                             end=end),
                                 device_type=f"DeviceType.{kind}")


def _profile(events):
    return types.SimpleNamespace(events=lambda: events)


def test_busy_union_ops_and_gaps():
    prof = _profile([
        _event("k1", 100, 300, "CUDA"),
        _event("k2", 200, 400, "CUDA"),  # overlaps k1: busy 100-400
        _event("k1", 600, 700, "CUDA"),
        _event("cudaStreamSynchronize", 450, 550, "CPU"),  # across the gap 400-600
        _event("k3", 900, 1000, "CUDA"),
    ])
    t = trace.summarize(prof, 1200e-6)
    assert t.busy_s == pytest.approx(500e-6)
    assert t.window_s == pytest.approx(1200e-6)
    assert dict(t.device_ops) == pytest.approx({"k1": 300e-6, "k2": 200e-6, "k3": 100e-6})
    gaps = dict(t.idle_gaps)
    assert gaps == pytest.approx({
        "host, before k1": 100e-6,  # the slice's start to the first launch
        "cudaStreamSynchronize": 200e-6,
        "host, before k3": 200e-6,
        "host, before the slice's end": 200e-6,
    })
    assert sum(gaps.values()) + t.busy_s == pytest.approx(t.window_s)


def test_no_device_interval_reads_nothing():
    assert trace.summarize(_profile([_event("aten::mm", 0, 10, "CPU")]), 1e-3) is None
