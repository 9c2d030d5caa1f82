"""HPCG's solve: CG from x0 = 0 on b = A 1, ``iters`` iterations, on the
configuration's one plane (K4 for float64, K1 for float32). Compared by
``x_err``, the 2-norm of the gap to the reference's CG iterate over the
reference's."""

import torch

from csr5_bench import harness, reference, yardstick


def planes(cfg, control):
    return {"a": (harness.CONTROL_PLANES if control else harness.PLANES)[cfg["precision"]]}


def inputs(cfg, traffic, csr, seed, device, vec):
    """b = A 1 in float64 from the generated CSR (HPCG), and its copy in the
    vectors' precision, which the program solves for."""
    m, n = csr["shape"]
    a = reference.CSR(csr["row_ptr"], csr["col"], csr["val"], (m, n), device)
    b = a.matmul(torch.ones(n, dtype=torch.float64, device=device))
    return {"b": b, "b_vec": b.to(vec)}


def program(port, traffic, mats, inputs, n, device):
    a5, b, iters = mats["a"], inputs["b_vec"], int(traffic["iters"])
    spmv = lambda v: port.csr5_spmv(a5, v)  # noqa: E731  one operator for every solve
    fn = port.solvers.conjugate_gradient
    return fn, lambda: fn(spmv, b, iters=iters)[0], iters


def check(ref, traffic, inputs, kept):
    want = reference.conjugate_gradient(ref, inputs["b"], int(traffic["iters"]))
    return "x_err", [yardstick.relative_error(x, want, 2) for x in kept]
