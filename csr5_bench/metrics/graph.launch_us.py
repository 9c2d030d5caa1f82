"""Host microseconds per replay to submit its graph: the mean length of the
program's ``csr5.graph.launch`` spans (around ``graph.replay()``) in the
traced solve window."""

from csr5_bench import replays


def read(t):
    return replays.mean_us(t, "csr5.graph.launch") if t.kind == "solve" else None
