"""HPCG's system solved to float64 accuracy by mixed-precision iterative
refinement (Buttari et al., ACM TOMS 34(4), 2008; HPG-MxP): ``outer_iters``
steps, each ``inner_iters`` iterations of CG on a plane of A in the
configuration's ``inner_precision`` (float32: K1), with the residual
r = b - A x and the update x += d on a plane in its ``precision``
(float64: K4); b = A 1, x0 = 0. Compared by ``res_err``, the
relative residual ||b - A x||_2 / ||b||_2 with the float64 reference's A:
the result must reach float64 accuracy, which a residual formed in
float32 (the control) cannot."""

import torch

from csr5_bench import harness, reference, yardstick


def planes(cfg, control):
    table = harness.CONTROL_PLANES if control else harness.PLANES
    return {"hi": table[cfg["precision"]], "lo": table[cfg["inner_precision"]]}


def inputs(cfg, traffic, csr, seed, device, vec):
    """b = A 1 in float64 from the generated CSR (HPCG), and its copy in the
    vectors' precision, which the program solves for."""
    m, n = csr["shape"]
    a = reference.CSR(csr["row_ptr"], csr["col"], csr["val"], (m, n), device)
    b = a.matmul(torch.ones(n, dtype=torch.float64, device=device))
    return {"b": b, "b_vec": b.to(vec)}


def program(port, traffic, mats, inputs, n, device):
    hi, lo, b = mats["hi"], mats["lo"], inputs["b_vec"]
    outer, inner = int(traffic["outer_iters"]), int(traffic["inner_iters"])
    spmv_lo = lambda v: port.csr5_spmv(lo, v)  # noqa: E731  one operator pair for every solve
    spmv_hi = lambda v: port.csr5_spmv(hi, v)  # noqa: E731
    fn = port.solvers.iterative_refinement
    call = lambda: fn(spmv_lo, spmv_hi, b, outer_iters=outer, inner_iters=inner)[0]  # noqa: E731
    return fn, call, outer * inner


def check(ref, traffic, inputs, kept):
    b = inputs["b"]
    return "res_err", [yardstick.relative_error(ref.matmul(x), b, 2) for x in kept]
