"""Host microseconds per product to enqueue it: the host clock over a loop
of enqueued products, before the wait for the device, over their count."""


def read(t):
    if t.dispatch_s is None:
        return None
    return t.dispatch_s * 1e6
