"""Device kernels per solver iteration: the kernels of the traced solves
(memory copies and sets left out) over their iterations. Every kernel of
a replayed CUDA graph is a node the device waits on in turn."""


def read(t):
    kernels = sum(1 for name, _, _ in t.device_ops if not name.startswith(("Memcpy", "Memset")))
    if t.kind != "solve" or not t.calls or not kernels:
        return None
    return kernels / (t.calls * t.iters)
