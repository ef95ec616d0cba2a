"""The device's idle share over the traced slice: one less the union of
its kernel, copy and set intervals in torch.profiler's trace of the
device's activity alone, over the slice's host seconds. Nothing to read
where the trace holds no device interval."""

LAYER = "device"
UNIT = "%"
MOVES = "candidates_per_s"
SOURCE = "device_trace"


def read(run):
    t = run.window.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
