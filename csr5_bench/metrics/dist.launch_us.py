"""Host microseconds per distributed product to launch it as a program: the
mean length of the ``csr5.dist.product`` spans in replay mode in the
traced window (the key's lookup, x's copy into the kept buffer, the
graph's submission and y's clone). The run takes the worst rank's."""

from csr5_bench import dist_replays


def read(t):
    got = dist_replays.product_spans(t, "replay")
    if not got:
        return None
    return sum(s.end - s.start for s in got) / len(got)
