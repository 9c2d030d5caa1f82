"""The device's idle share of the traced solve window: 1 - the union of
device activity (profiler) over the window's length by CUDA events."""


def read(t):
    if t.kind != "solve" or not t.window_s > 0 or not t.busy_s > 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
