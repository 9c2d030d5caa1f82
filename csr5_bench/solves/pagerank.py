"""GAP's PageRank: ``iters`` steps from the uniform vector with damping
``damping``, on the configuration's one plane of the transition matrix.
Compared by ``r_err``, the 1-norm of the gap to the reference's iterate
over the reference's."""

from csr5_bench import harness, reference, yardstick


def planes(cfg, control):
    return {"a": (harness.CONTROL_PLANES if control else harness.PLANES)[cfg["precision"]]}


def inputs(cfg, traffic, csr, seed, device, vec):
    return {}


def program(port, traffic, mats, inputs, n, device):
    a5, d, iters = mats["a"], float(traffic["damping"]), int(traffic["iters"])
    spmv = lambda v: port.csr5_spmv(a5, v)  # noqa: E731  one operator for every solve
    fn = port.solvers.pagerank
    return fn, lambda: fn(spmv, n, damping=d, iters=iters, device=device), iters


def check(ref, traffic, inputs, kept):
    want = reference.pagerank(ref, float(traffic["damping"]), int(traffic["iters"]))
    return "r_err", [yardstick.relative_error(r, want, 1) for r in kept]
