"""The capture of iterative refinement on HPCG's two planes, timed, on the
card: the seconds ``utils/graphs.py::_capture`` takes at the given counts,
the captured graph's nodes, the capture record (launches, per-operator
launches, products placed), each replay's time to its return (the
enqueue: the input copy, ``graph.replay()``, the output clones) and to the
device's end, and the relative residual against the benchmark's float64
reference.

    python3 <repo>/scripts/ir_capture.py [--n 192] [--outer 4] [--inner 200] [--seed N]
                                         [--full-read] [--replays R] [--out FILE]

Run it from the root of the checkout whose port it measures (that
checkout's ``benchmark_spmv_using_csr5_tpu_torch`` and ``csr5_bench`` are
imported), so the same script times two versions of the port. With
``--full-read``, where the port places its products by reading only the
nodes added since its last read, it captures once more with every read
made whole, as a port without that reading does, and says whether the two
records place every product alike. Prints one JSON line. Needs a CUDA card.
"""

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--outer", type=int, default=4)
    ap.add_argument("--inner", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-read", action="store_true")
    ap.add_argument("--replays", type=int, default=3,
                    help="replays timed after the capture, each from the call to its return "
                         "(the enqueue) and to the device's end")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    import benchmark_spmv_using_csr5_tpu_torch as port
    from benchmark_spmv_using_csr5_tpu_torch.utils import graphs, trace
    from csr5_bench import harness, reference, yardstick

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    cfg = {"nx": args.n, "ny": args.n, "nz": args.n}
    csr = harness.load_module(harness.ROOT, "generators", "stencil27").generate(cfg, args.seed, dev)
    m, n = csr["shape"]
    ref = reference.CSR(csr["row_ptr"], csr["col"], csr["val"], (m, n), dev)
    b = ref.matmul(torch.ones(n, dtype=torch.float64, device=dev))
    host = tuple(csr[k].cpu().numpy() for k in ("row_ptr", "col", "val")) + ((m, n),)
    del csr
    hi = port.build_csr5(host, value_dtype=torch.float64, device=dev)
    lo = port.build_csr5(host, value_dtype=torch.float32, device=dev)
    spmv_lo = lambda v: port.csr5_spmv(lo, v)  # noqa: E731
    spmv_hi = lambda v: port.csr5_spmv(hi, v)  # noqa: E731
    fn = port.solvers.iterative_refinement
    counts = {"outer_iters": args.outer, "inner_iters": args.inner}

    took = []
    capture = graphs._capture

    def timed(*a, **kw):
        t0 = time.perf_counter()
        prog = capture(*a, **kw)
        sync()
        took.append(time.perf_counter() - t0)
        return prog

    graphs._capture = timed

    def solve():
        t0 = time.perf_counter()
        x = fn(spmv_lo, spmv_hi, b, **counts)[0]
        sync()
        return x, time.perf_counter() - t0

    def record():
        return list(trace.captures().values())[-1]

    def digest(products):
        return hashlib.sha256(repr(sorted(products.items())).encode()).hexdigest()[:16]

    out = {"card": torch.cuda.get_device_name(dev), "rows": m, "nnz": int(host[1].shape[0]),
           **counts, "incremental": hasattr(graphs._Products(torch.cuda.current_stream()), "read")}
    _, out["eager_s"] = solve()
    _, out["second_call_s"] = solve()
    out["capture_s"] = took[-1]
    rec = record()
    enqueue, total = [], []
    for _ in range(args.replays):
        t0 = time.perf_counter()
        x = fn(spmv_lo, spmv_hi, b, **counts)[0]
        t1 = time.perf_counter()
        sync()
        enqueue.append(t1 - t0)
        total.append(time.perf_counter() - t0)
    out["replay_s"], out["replay_enqueue_s"] = total, enqueue
    out["res_err"] = yardstick.relative_error(ref.matmul(x), b, 2)
    out["nodes"] = rec.nodes
    out["launches"] = rec.launches
    out["operator_launches"] = getattr(rec, "operator_launches", None)
    out["products"] = None if rec.products is None else {
        k: len(v) for k, v in rec.products.items()}
    out["products_digest"] = None if rec.products is None else digest(rec.products)
    if args.full_read and out["incremental"]:
        read = graphs._Products._ops

        def whole(self):
            self.read = self.ops = self.seen_kernels = 0
            self.last = None
            return read(self)

        graphs._Products._ops = whole
        fn.cache_clear()
        solve()
        solve()
        graphs._Products._ops = read
        out["full_read_capture_s"] = took[-1]
        out["full_read_equal"] = record().products == rec.products
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
