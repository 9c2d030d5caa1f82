"""The device's idle share inside the graphs: over each traced replay, the
time from its graph's first node to its last that no node covers, summed
over the window's length by CUDA events. The rest of
``device.idle_pct.solve`` is idle between replays: their input copies,
graph submission, output clones and the host's wait."""

from csr5_bench import replays


def read(t):
    reps = replays.replays(t)
    if not reps or not t.window_s > 0:
        return None
    idle_us = sum(max(e for _, _, e in r.nodes) - min(s for _, s, _ in r.nodes)
                  - replays.busy_us(r.nodes) for r in reps)
    return 100.0 * idle_us * 1e-6 / t.window_s
