"""What the per-layer metrics of the program's spans share: the port's spans
on the profiler's clock, and each traced replay's device operations.

The spans and the capture records come from the program itself
(``benchmark_spmv_using_csr5_tpu_torch/utils/trace.py``). A program
without them (older than its spans) gives nothing here, and its readers
return None.

**A replay's device operations.** The harness synchronises after each
solve, so every device operation of solve r starts after solve r's
``csr5.solve`` span opens and before solve r+1's opens. On the one
stream they run in this order: one copy per static input, the graph's
nodes, one clone per output; the capture record counts all three. So the
window's operations are cut by those counts, in the order of the spans.
The copies and clones are peeled off each end, and what is left must
match the record's nodes by type. A replay that does not fit makes
:func:`replays` return None: it never guesses.

**A solve's products.** The record also places each call of the solver's
operator (the SpMV) among the graph's device operations, as the capture
enqueued them; :func:`split` takes those as the products and the rest as
the solver's own work. A product is every operation the operator
enqueued, as ``spmv_roofline`` counts every operation per product.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

Op = Tuple[str, float, float]  #: (name, start µs, end µs)

#: the graph node types that each run as one device operation
SHOWN = ("kernel", "memcpy", "memset")
#: node types that run nothing on the device
SILENT = ("empty",)


def port_trace():
    """The program's trace module, or None where the program has none."""
    try:
        from benchmark_spmv_using_csr5_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


#: the profiler's names of copies and fills: the runtime's ("Memcpy DtoD
#: (Device -> Device)", "Memset (Device)"), and CUDA's own kernels that
#: run a graph's memcpy or memset node ("memcpy128")
_NAMED = (("memcpy", re.compile(r"Memcpy|memcpy\d*$")), ("memset", re.compile(r"Memset|memset\d*$")))


def op_kind(name: str) -> str:
    """A device operation's node type, by the name the profiler gives it."""
    for kind, pattern in _NAMED:
        if pattern.match(name):
            return kind
    return "kernel"


def spans(t, name: str) -> Optional[list]:
    """The port's spans called ``name`` in the traced window, on the
    profiler's clock, or None where the program records none or the clocks
    cannot be fitted."""
    trace = port_trace()
    if trace is None or not t.device_ops:
        return None
    got = trace.on_profiler_clock(t.host_ops)
    if got is None:
        return None
    return [s for s in got if s.name == name] or None


def mean_us(t, name: str) -> Optional[float]:
    """The mean length in µs of the spans called ``name``."""
    got = spans(t, name)
    if not got:
        return None
    return sum(s.end - s.start for s in got) / len(got)


@dataclasses.dataclass
class Replay:
    """One traced replay: its capture record and its device operations."""

    record: object
    copies: List[Op]
    nodes: List[Op]
    clones: List[Op]


def _fit(ops: List[Op], record) -> Optional[Replay]:
    copies, body, clones = (ops[:record.inputs], ops[record.inputs:len(ops) - record.outputs],
                            ops[len(ops) - record.outputs:])
    if any(op_kind(name) != "memcpy" for name, _, _ in copies + clones):
        return None
    kinds: Dict[str, int] = {}
    for name, _, _ in body:
        kinds[op_kind(name)] = kinds.get(op_kind(name), 0) + 1
    if kinds != {k: n for k, n in record.nodes.items() if k in SHOWN and n}:
        return None
    return Replay(record, copies, body, clones)


def _length(record) -> Optional[int]:
    """The device operations of one replay, or None where its graph holds
    a node that is not one device operation (or was not read)."""
    nodes = record.nodes
    if nodes is None or set(nodes) - set(SHOWN) - set(SILENT):
        return None
    return record.inputs + sum(nodes.get(k, 0) for k in SHOWN) + record.outputs


def replays(t) -> Optional[List[Replay]]:
    """Each replay in the traced solve window with its device operations,
    or None where the program has no spans or records, a solve in the
    window was not a replay, or the operations do not fit the records.

    The window's operations are cut from its end (the harness waits for
    the last solve) in the order of the ``csr5.solve`` spans, into runs of
    the lengths their records give, each checked by type. The runs must
    take every operation, but where the profiler's device trace started
    late, inside the window's first replay: that replay is left out."""
    trace = port_trace()
    if trace is None or t.kind != "solve" or not t.device_ops:
        return None
    solves = spans(t, "csr5.solve")
    if not solves:
        return None
    records = trace.captures()
    plan = []
    for s in solves:
        record = records.get(s.attrs.get("program")) if s.attrs.get("mode") == "replay" else None
        n = None if record is None else _length(record)
        if n is None:
            return None
        plan.append((record, n))
    ops = sorted(t.device_ops, key=lambda o: o[1])
    out, j = [], len(ops)
    for k in range(len(plan) - 1, -1, -1):
        record, n = plan[k]
        if j < n:
            if k == 0 and all(op_kind(o[0]) == "memcpy" for o in ops[max(j - record.outputs, 0):j]):
                break  # the first replay, cut short at its start
            return None
        run = ops[j - n:j]
        # a coarse check of the cut: inside the solve's span, give or take
        # one solve (the device's clock and the host's may differ by µs)
        lo = solves[k - 1].start if k else float("-inf")
        hi = solves[k + 1].end if k + 1 < len(solves) else float("inf")
        fit = _fit(run, record) if lo <= run[0][1] and run[-1][2] <= hi else None
        if fit is None:
            return None
        out.append(fit)
        j -= n
    else:
        if j:
            return None
    return out[::-1] or None


def split(reps: List[Replay]) -> Optional[Tuple[List[List[Op]], List[Op]]]:
    """The device operations of each product in the replays ``reps``, and
    every other graph node of theirs; None unless each record places the
    calls of exactly one operator."""
    products, rest = [], []
    for r in reps:
        placed = getattr(r.record, "products", None)
        if not placed or len(placed) != 1:
            return None
        (calls,) = placed.values()
        inside = set()
        for a, b in calls:
            products.append(r.nodes[a:b])
            inside.update(range(a, b))
        rest += [op for i, op in enumerate(r.nodes) if i not in inside]
    return products, rest


def busy_us(ops: List[Op]) -> float:
    """The µs the union of ``ops`` covers."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > end:
            total += e - s
        elif e > end:
            total += e - end
        end = max(end, e)
    return total
