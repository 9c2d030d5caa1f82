"""What the exchange layer's readers share: each traced distributed
product's replay, cut from the window's device operations by the
program's capture record.

A product of ``distributed_spmv_local`` on the card under NCCL is a
captured program from its second call on: a replay copies x into the
program's kept buffer and runs the graph (the halo exchange's NCCL
kernels, then the local product), whose y the caller takes (a program
that clones its outputs counts them in its record). Each call opens a
``csr5.dist.product`` span whose attributes name its mode and program,
and the program's capture record counts the copies, nodes and clones of
one replay and places the exchange among the graph's device operations
(``benchmark_spmv_using_csr5_tpu_torch/utils/trace.py``). A program
without them (older than its distributed programs) gives nothing here,
and its readers return None.

The products of a window run back to back, the host ahead of the card,
so a replay's operations are not bounded by its own span, as a solve's
are (``replays.py``): on the one stream they run in the order of the
spans, and the harness waits for the last one, so the window's operations
are cut from its end into runs of the lengths the records give, each
checked by type as ``replays.py`` checks a solve's replay and begun after
the span before it opened. A window whose operations do not fit gives
None: it never guesses.
"""

from __future__ import annotations

from typing import List, Optional

from csr5_bench import replays

#: the span of one call of the distributed product
SPAN = "csr5.dist.product"
#: graph node types that run nothing the profiler shows: besides empty
#: nodes, the event NCCL records and waits on inside a captured exchange,
#: which orders the graph's NCCL work after the communicator's earlier work
SILENT = replays.SILENT + ("event_record", "wait_event")


def _length(record) -> Optional[int]:
    """The device operations of one replay, or None where its graph holds
    a node that is neither one device operation nor silent (or was not
    read)."""
    nodes = record.nodes
    if nodes is None or set(nodes) - set(replays.SHOWN) - set(SILENT):
        return None
    return record.inputs + sum(nodes.get(k, 0) for k in replays.SHOWN) + record.outputs


def product_spans(t, mode: Optional[str] = None) -> Optional[list]:
    """The window's ``csr5.dist.product`` spans on the profiler's clock (of
    ``mode`` only, when given), or None where there are none."""
    got = replays.spans(t, SPAN) if t.kind == "product" else None
    if got and mode is not None:
        got = [s for s in got if s.attrs.get("mode") == mode]
    return got or None


def product_replays(t) -> Optional[List[replays.Replay]]:
    """Each product of the traced window with its device operations, or
    None where the program records no spans or programs, a product in the
    window was not a replay, or the operations do not fit the records.
    Where the profiler's device trace started inside the first replay,
    that replay is left out."""
    trace = replays.port_trace()
    spans = product_spans(t)
    if trace is None or not spans:
        return None
    records = trace.captures()
    plan = []
    for s in spans:
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
            if k == 0 and all(replays.op_kind(o[0]) == "memcpy"
                              for o in ops[max(j - record.outputs, 0):j]):
                break  # the first replay, cut short at its start
            return None
        run = ops[j - n:j]
        lo = spans[k - 1].start if k else float("-inf")
        fit = replays._fit(run, record) if run[0][1] >= lo else None
        if fit is None:
            return None
        out.append(fit)
        j -= n
    else:
        if j:
            return None
    return out[::-1] or None


def exchange_ops(reps: List[replays.Replay]) -> Optional[List[List[replays.Op]]]:
    """The halo exchange's device operations in each replay, placed by its
    record's ``exchange``; None where a record does not place it."""
    out = []
    for r in reps:
        placed = getattr(r.record, "exchange", None)
        if placed is None or placed[1] <= placed[0]:
            return None
        out.append(r.nodes[placed[0]:placed[1]])
    return out
