"""Spans and capture records inside the port, on the profiler's clock.

**Recording is on exactly while a torch profiler records**: the module
reads the flag torch sets for its profiler (``torch.autograd.profiler.
_is_profiler_enabled``). There is no other switch. With recording off a
span site costs that one read and a branch (:func:`recording`).

- **Spans** (:func:`span`): a name, a start and an end on the program's
  clock (``time.perf_counter_ns``), the span open around it when it
  opened (its parent), a request id shared by a root span and every span
  under it, and the caller's attributes. They are kept in memory in a
  bounded buffer, the oldest dropped first and counted; nothing is
  written out. The port's spans:

  ============================  ==========================================
  ``csr5.solve``                one call of a solver (``utils/graphs.py``)
  ``csr5.graph.launch``         a replay's ``graph.replay()``
  ``csr5.dist.product``         one call of ``distributed_spmv_local``
                                (``parallel/distributed.py``): its rank,
                                program id, mode, halo widths and the x
                                bytes it exchanges
  ============================  ==========================================

- **One clock.** A span opened while recording first opens and closes
  empty profiler ranges named :data:`ANCHOR` (:data:`ANCHORS_AT_ONCE`,
  back to back) when none was made in the last :data:`ANCHOR_EVERY_NS`,
  with the program's clock read just before and just after each. The profiler's range lies inside those two
  readings, so each anchor bounds the offset between the two clocks. The
  range is torch's C++ ``_RecordFunctionFast``, the same user range as
  ``torch.profiler.record_function`` makes, entered without its Python
  dispatch, whose own bracket on an H100's host was no narrower than
  43 µs, where this one's is 1.40-3.04 µs.
  An anchor encloses no launch, so it makes no device event: it is one
  host event among the profiler's. :func:`on_profiler_clock` fits the
  offset and the rate from the anchors with the narrowest brackets and
  returns the spans in the profiler's microseconds.
- **Capture records** (:func:`note_capture`): one per captured program,
  kept whether or not anything records, the last :data:`MAX_CAPTURES`,
  whatever a solver's cache drops. Each holds what a replay runs on the
  device, so a reader can attribute a replay's device operations, which
  no Python sees, and the launches each of the solver's operators
  enqueued (``operator_launches``), so a solve of two operators (iterative
  refinement's K1 and K4) can be cut by operator.

Profile any call, then read the spans::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solvers.conjugate_gradient(spmv, b, iters=50)
    host = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    for s in trace.on_profiler_clock(host):
        print(s.name, s.start, s.end, s.attrs)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from torch.autograd import profiler as _profiler

#: spans kept, the oldest dropped first
MAX_SPANS = 1 << 16
#: anchors kept, the oldest dropped first (at most twenty a second)
MAX_ANCHORS = 1 << 12
#: capture records kept, the oldest dropped first
MAX_CAPTURES = 64
#: the profiler range that ties the program's clock to the profiler's
ANCHOR = "csr5.trace.anchor"
#: the least time between two anchorings
ANCHOR_EVERY_NS = 100_000_000
#: anchors made back to back at each anchoring: the first is slow to open
#: after the host has done other work, those after it are narrower
ANCHORS_AT_ONCE = 2
#: how far, in profiler microseconds, an anchor's range may lie outside
#: its bracket once the two clocks are fitted
ANCHOR_SLACK_US = 10.0
#: the anchors must span this long (profiler microseconds) for their rate
#: to be fitted; a shorter session takes the rate as 1
RATE_SPAN_US = 500_000.0


def recording() -> bool:
    """True while a torch profiler records."""
    return _profiler._is_profiler_enabled


@dataclasses.dataclass
class Span:
    """One span: ``start`` and ``end`` on the program's clock in ns (from
    :func:`spans`) or the profiler's in µs (from
    :func:`on_profiler_clock`)."""

    name: str
    start: float
    end: float
    ident: int
    parent: Optional[int]
    request: int
    attrs: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Capture:
    """What one captured program runs per replay: ``inputs`` static input
    copies, then the graph's ``nodes`` by type (read from the graph
    itself; None where it could not be read), then ``outputs`` output
    clones, all on one stream. ``launches`` are the kernel launches the
    capture enqueued, by launch counter. ``products`` holds, for each
    operator the solver was given (by argument name), where each of its
    calls lies: (first, end) positions among the graph's device
    operations, in the order they run; None where it could not be read.
    ``operator_launches`` holds, for each operator by argument name, the
    launches its calls enqueued, by launch counter (a part of
    ``launches``): which operator ran which kernel, read from the
    counters, never from the names (iterative refinement at 4 x 200:
    ``{"spmv_lo": {"csr5_spmv": 800}, "spmv_hi": {"csr5_spmv_f64": 5}}``);
    None in a record made without it. A distributed product's program also
    places its halo exchange (``exchange``, the same kind of position) and
    counts the NCCL kernels the exchange enqueued (``nccl_kernels``); None
    elsewhere."""

    program: int
    solver: str
    loops: Dict[str, int]
    inputs: int
    outputs: int
    nodes: Optional[Dict[str, int]]
    launches: Dict[str, int]
    products: Optional[Dict[str, Tuple[Tuple[int, int], ...]]]
    exchange: Optional[Tuple[int, int]] = None
    nccl_kernels: Optional[int] = None
    operator_launches: Optional[Dict[str, Dict[str, int]]] = None


class Recorder:
    """The spans, anchors and capture records of one process."""

    def __init__(self, max_spans: int = MAX_SPANS, max_captures: int = MAX_CAPTURES):
        self.spans: "collections.deque[Span]" = collections.deque(maxlen=max_spans)
        self.dropped = 0
        self.anchors: "collections.deque[Tuple[int, int]]" = collections.deque(maxlen=MAX_ANCHORS)
        self.captures: "collections.OrderedDict[int, Capture]" = collections.OrderedDict()
        self.max_captures = max_captures
        self._open: List[Span] = []
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._programs = itertools.count(1)
        self._last_anchor: Optional[int] = None

    @contextlib.contextmanager
    def span(self, name: str, attrs: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        now = time.perf_counter_ns()
        if self._last_anchor is None or now - self._last_anchor >= ANCHOR_EVERY_NS:
            self._anchor()
        parent = self._open[-1] if self._open else None
        s = Span(name, 0, 0, next(self._ids), parent and parent.ident,
                 parent.request if parent else next(self._requests), attrs)
        self._open.append(s)
        s.start = time.perf_counter_ns()
        try:
            yield attrs
        finally:
            s.end = time.perf_counter_ns()
            self._open.pop()
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(s)

    def _anchor(self) -> None:
        from torch._C._profiler import _RecordFunctionFast

        for _ in range(ANCHORS_AT_ONCE):
            t0 = time.perf_counter_ns()
            with _RecordFunctionFast(ANCHOR):
                pass
            t1 = time.perf_counter_ns()
            self.anchors.append((t0, t1))
        self._last_anchor = t1

    def note_capture(self, **fields) -> Capture:
        rec = Capture(program=next(self._programs), **fields)
        self.captures[rec.program] = rec
        while len(self.captures) > self.max_captures:
            self.captures.popitem(last=False)
        return rec


_rec = Recorder()


def span(name: str, **attrs):
    """A context manager that records the span ``name`` while a profiler
    records, and yields its attributes (a dict the body may add to), or
    None when nothing records. A hot site tests :func:`recording` first."""
    if not _profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return _rec.span(name, attrs)


def note_capture(**fields) -> Capture:
    """Keep the record of a captured program (the fields of
    :class:`Capture` but ``program``, which it assigns) and return it."""
    return _rec.note_capture(**fields)


def captures() -> Dict[int, Capture]:
    """The capture records kept, by program id."""
    return dict(_rec.captures)


def spans() -> List[Span]:
    """The spans kept, in the order they closed, on the program's clock."""
    return list(_rec.spans)


def dropped() -> int:
    """The spans dropped so far because the buffer was full."""
    return _rec.dropped


def clock_fit(host_ops: Sequence[Tuple[str, float, float]]) -> Optional[Tuple[float, float, float, float]]:
    """(a, b, bracket, spread): program ns = a + b * profiler µs, fitted on
    the anchors among ``host_ops`` (name, start µs, end µs) against the
    last as many anchors the program made, with the narrowest anchor's
    bracket and the width of the offsets every anchor allows, in µs.

    Each anchor's range lies inside its bracket, which bounds the offset
    ``a`` on both sides; ``a`` is the middle of the offsets all anchors
    allow, so the narrowest brackets decide it. The rate ``b`` is fitted on
    the middles of the narrower half of the brackets when the anchors span
    :data:`RATE_SPAN_US`, else taken as 1 (1000 ns per µs). None when
    ``host_ops`` holds no anchor, or when the anchors allow no common
    offset within :data:`ANCHOR_SLACK_US` (they are of another session than
    the program's last)."""
    prof = sorted((s, e) for name, s, e in host_ops if name == ANCHOR)
    mine = list(_rec.anchors)[-len(prof):] if prof else []
    if not prof or len(mine) < len(prof):
        return None
    widths = [t1 - t0 for t0, t1 in mine]
    cut = sorted(widths)[(len(widths) - 1) // 2]
    kept = [i for i, w in enumerate(widths) if w <= cut]
    b = 1000.0
    x = [(prof[i][0] + prof[i][1]) / 2 for i in kept]
    if max(x) - min(x) >= RATE_SPAN_US:
        y = [(mine[i][0] + mine[i][1]) / 2 for i in kept]
        mx, my = sum(x) / len(x), sum(y) / len(y)
        b = sum((u - mx) * (v - my) for u, v in zip(x, y)) / sum((u - mx) ** 2 for u in x)
    lo = max(t0 - b * s for (s, _), (t0, _) in zip(prof, mine))
    hi = min(t1 - b * e for (_, e), (_, t1) in zip(prof, mine))
    if lo > hi + ANCHOR_SLACK_US * b:
        return None
    return (lo + hi) / 2, b, min(widths) / 1e3, max(hi - lo, 0.0) / b


def on_profiler_clock(host_ops: Sequence[Tuple[str, float, float]]) -> Optional[List[Span]]:
    """The spans of the profiled session whose host events are
    ``host_ops`` (name, start µs, end µs, as ``prof.events()`` gives them):
    those opened since the first of its anchors, sorted by start, with
    ``start`` and ``end`` in the profiler's µs; None when the two clocks
    cannot be fitted (:func:`clock_fit`)."""
    fit = clock_fit(host_ops)
    if fit is None:
        return None
    a, b = fit[:2]
    n = sum(1 for name, _, _ in host_ops if name == ANCHOR)
    first = list(_rec.anchors)[-n][0]
    out = [dataclasses.replace(s, start=(s.start - a) / b, end=(s.end - a) / b)
           for s in _rec.spans if s.start >= first]
    return sorted(out, key=lambda s: s.start)
