"""Solvers as device programs: one captured CUDA graph, replayed per call.

The JAX package runs each solver as one compiled program
(``benchmark_spmv_using_csr5_tpu/models/solvers.py``: ``jax.jit`` over
``lax.fori_loop``, the loop counts and ``spmv`` static), so a whole solve
is one dispatch. The PyTorch counterpart is a CUDA graph captured once and
replayed. :func:`device_program` is the decorator that does it, applied
to a solver as ``@partial(jax.jit, static_argnames=...)`` is applied
there:

- **CPU tensors** run the body eagerly, as written. So does a call made
  while a capture runs (``torch.cuda.is_current_stream_capturing()``) or
  while another program warms up: a nested solver (iterative
  refinement's inner CG) becomes part of the caller's graph.
- **Cache key**, what JAX's jit cache keys on: every tensor argument by
  shape, dtype and device, every other argument by value (the loop
  counts, ``restart``, ``n``, ``dtype``, ``device``, ``damping``). A
  callable argument (``spmv``) is keyed by its identity and by the
  identity of each object it refers to directly (:func:`referents`: a
  closure's cells, the globals it names, a partial's arguments), so a
  closure whose matrix variable is rebound makes a new key.
- **First call of a key**: the eager body, which costs what a solve
  always cost; the key is noted. A caller that solves once, or passes a
  new ``lambda`` each time, never pays a capture.
- **Second call of a key**: copy the tensor arguments into static input
  buffers; run the body once on the device's capture stream with the loop
  counts at 1 (this loads the kernel libraries, grants their shared
  memory, creates the cuBLAS handle and its workspace, and fills the
  wrappers' per-matrix caches); capture the body with the real counts on
  that stream; then replay. Every later call copies its tensor arguments
  into the static buffers, replays, and returns clones of the outputs, so
  a later call does not overwrite an earlier result.
- **What a program holds.** Its graph reads raw addresses, so it keeps
  every tensor its capture read that the capture did not make (the
  matrix planes the kernels were handed, the static inputs:
  :class:`_Reads`) and the objects its callables refer to. It does not
  keep the callables: when one dies, every entry that names it goes, a
  program with its graph and memory pool. A solver keeps at most
  :data:`MAX_PROGRAMS` programs, the least recently used dropped first.
- **Launch counters and the capture record.** During the capture the
  kernel wrappers run their Python and add to their launch counters
  (``cuda_build.launches``), as they do for an eager launch: the counters
  count what the wrappers enqueued, eagerly or into a graph. A replay runs
  no Python, so it adds nothing. What a replay runs on the device is in
  the program's capture record (:func:`.trace.note_capture`, kept after
  the program is dropped): the static inputs it copies, the graph's nodes by type (:func:`graph_nodes`,
  read from the captured graph), the outputs it clones, the launches the
  capture enqueued (:func:`launches_between`), where each call of the
  solver's operators (its SpMVs) lies among the graph's device operations
  (:class:`_Products`, which reads each node of the growing graph once),
  and the launches each operator's calls enqueued, by launch counter, so
  a reader knows which operator ran which kernel (iterative refinement:
  K1 under ``spmv_lo``, K4 under ``spmv_hi``). The profiler is what
  counts the kernels that ran. Where ``libcuda`` cannot be read, the
  record holds None there and the solve goes on.
- **Spans** (:mod:`.trace`, while a profiler records): ``csr5.solve``
  around each call (its mode ``eager``, ``capture`` or ``replay`` and its
  program id) and ``csr5.graph.launch`` around ``graph.replay()``.
- **No fallback.** A capture or replay that fails raises; nothing is
  retried eagerly or moved to the CPU.
- **Other programs.** :func:`capture` is the warm-up and capture itself,
  given the static buffers: ``parallel/distributed.py`` captures a
  distributed product with it, whose halo exchange runs on NCCL's stream
  inside the graph and is placed in the record apart from the product.

As under ``jax.jit``, a program replays the tensors its capture read: a
matrix changed in place is read anew, one swapped in behind an object the
callable refers to (``self.A = ...`` under ``lambda v: spmv(self.A, v)``)
is not; pass a new callable for a new matrix. The decorated function's
``__wrapped__`` is its eager body, on any device, with the solvers it
calls run inline too (iterative refinement's inner CG then runs eagerly,
not as a replay).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import inspect
import threading
import types
import weakref
from collections import OrderedDict
from typing import (Any, Callable, Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
from torch.overrides import TorchFunctionMode

from . import cuda_build, trace

#: captured programs each decorated solver keeps, the least recently used
#: dropped first; each holds a memory pool with every intermediate of its
#: solve (GMRES's V: (restart + 1) * n values)
MAX_PROGRAMS = 4
#: keys called once that each decorated solver remembers, the oldest dropped
MAX_SEEN = 256

_nesting = threading.local()
#: device index -> the stream programs warm up and capture on, one per
#: device so cuBLAS allocates its workspace for it once
_streams: Dict[int, torch.cuda.Stream] = {}


def read_launches() -> Dict[str, int]:
    """Each kernel's launch counter (``cuda_build.launches``), by name."""
    return dict(cuda_build.launches)


def launches_between(before: Mapping[str, int], after: Mapping[str, int]) -> Dict[str, int]:
    """The launches counted from ``before`` to ``after``, by name, the
    counters that did not move left out."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


#: CUDA's graph node types (``CUgraphNodeType``) by value
NODE_TYPES = {
    0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
    6: "wait_event", 7: "event_record", 8: "semaphore_signal", 9: "semaphore_wait",
    10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op", 13: "conditional",
}
#: the node types that each run as one device operation
DEVICE_OPS = ("kernel", "memcpy", "memset")
_libcuda_lib: Any = None


def _libcuda() -> Optional[ctypes.CDLL]:
    """``libcuda`` with its graph queries typed, or None where it cannot be
    loaded."""
    global _libcuda_lib
    if _libcuda_lib is None:
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError:
            _libcuda_lib = False
            return None
        p, size_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        lib.cuGraphGetNodes.argtypes = [p, p, size_p]
        lib.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
        if hasattr(lib, "cuStreamGetCaptureInfo_v2"):
            lib.cuStreamGetCaptureInfo_v2.argtypes = [p, ctypes.POINTER(ctypes.c_int), p,
                                                      ctypes.POINTER(p), p, p]
        _libcuda_lib = lib
    return _libcuda_lib or None


def _nodes(lib: ctypes.CDLL, graph: int, start: int = 0) -> Optional[Tuple[int, List[int]]]:
    """(the number of nodes of the ``CUgraph`` ``graph``, the handles of
    those from the ``start``-th on), through ``libcuda``'s
    ``cuGraphGetNodes``, which lists a graph's nodes in the order they were
    added; None where it returns an error."""
    handle, num = ctypes.c_void_p(graph), ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(handle, None, ctypes.byref(num)):
        return None
    if num.value <= start:
        return num.value, []
    nodes = (ctypes.c_void_p * num.value)()
    if lib.cuGraphGetNodes(handle, nodes, ctypes.byref(num)):
        return None
    return num.value, nodes[start: num.value]


def _node_type(lib: ctypes.CDLL, node: int) -> Optional[str]:
    """A node's type (:data:`NODE_TYPES`) by ``cuGraphNodeGetType``, or None
    where it returns an error."""
    kind = ctypes.c_int()
    if lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
        return None
    return NODE_TYPES.get(kind.value, f"type_{kind.value}")


def _node_types(graph: int) -> Optional[List[str]]:
    """The type of each node of the ``CUgraph`` ``graph``, or None where
    ``libcuda`` cannot say."""
    lib = _libcuda()
    got = None if lib is None else _nodes(lib, graph)
    if got is None:
        return None
    kinds = [_node_type(lib, node) for node in got[1]]
    return None if None in kinds else kinds


def graph_nodes(graph: torch.cuda.CUDAGraph) -> Optional[Dict[str, int]]:
    """The nodes of a captured graph (kept with ``keep_graph=True``) by
    type, read from the graph itself, or None where ``libcuda`` cannot say."""
    kinds = _node_types(graph.raw_cuda_graph())
    return None if kinds is None else dict(collections.Counter(kinds))


class _Products:
    """Where each call of a solver's operators (its callable arguments, the
    SpMVs) lies in the graph ``stream`` captures: (first, end) positions
    among the graph's device operations (:data:`DEVICE_OPS`, in the order
    they were captured, which on one stream is the order they run), by
    argument name, and the kernels each call enqueued (``kernels``). The
    graph holds what every stream of the capture enqueued, a process
    group's stream among them. ``spans`` turns None where ``libcuda``
    cannot say. ``launches`` holds, by argument name, the launches that
    the operator's calls enqueued, by launch counter
    (``cuda_build.launches``), read from the counters and not from the
    graph.

    Each read of the graph takes the type of the nodes added since the
    last read only, and keeps running counts, so a capture of c calls over
    a graph of g nodes reads each node once, not c times. ``cuGraphGetNodes``
    lists the nodes in the order they were added; each read checks that
    the last node read before still stands where it stood, and reads the
    graph whole again where it does not."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = ctypes.c_void_p(stream.cuda_stream)
        self.spans: Optional[Dict[str, List[Tuple[int, int]]]] = {}
        self.kernels: Dict[str, List[int]] = {}
        self.launches: Dict[str, Dict[str, int]] = {}
        #: the nodes read so far, the last of them, and the device
        #: operations and the kernels among them
        self.read, self.last, self.ops, self.seen_kernels = 0, None, 0, 0

    def _ops(self) -> Optional[int]:
        """The device operations captured so far."""
        lib = _libcuda()
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        if (lib is None or not hasattr(lib, "cuStreamGetCaptureInfo_v2")
                or lib.cuStreamGetCaptureInfo_v2(self.stream, ctypes.byref(status), None,
                                                 ctypes.byref(graph), None, None)
                or not graph.value):
            return None
        skip = 1 if self.read else 0  # the last node read, read again as a check
        got = _nodes(lib, graph.value, self.read - skip)
        if got is not None and skip and got[1][:1] != [self.last]:
            skip = self.read = self.ops = self.seen_kernels = 0  # not grown at its end
            got = _nodes(lib, graph.value)
        if got is None:
            return None
        count, nodes = got
        for node in nodes[skip:]:
            kind = _node_type(lib, node)
            if kind is None:
                return None
            self.ops += kind in DEVICE_OPS
            self.seen_kernels += kind == "kernel"
        if nodes:
            self.read, self.last = count, nodes[-1]
        return self.ops

    def marked(self, name: str, fn: Callable) -> Callable:
        """``fn``, noting where each of its calls lies under ``name``."""
        counts = self.launches.setdefault(name, {})

        def call(*args, **kwargs):
            first = self._ops() if self.spans is not None else None
            k0 = self.seen_kernels
            before = read_launches()
            out = fn(*args, **kwargs)
            for k, n in launches_between(before, read_launches()).items():
                counts[k] = counts.get(k, 0) + n
            end = self._ops() if first is not None else None
            if end is None:
                self.spans = None
            elif self.spans is not None:
                self.spans.setdefault(name, []).append((first, end))
                self.kernels.setdefault(name, []).append(self.seen_kernels - k0)
            return out

        return call


def _inline() -> bool:
    """True where a decorated solver runs its body as written inside a
    caller's program: during a capture or another program's warm-up."""
    return getattr(_nesting, "depth", 0) > 0 or torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def _nested():
    _nesting.depth = getattr(_nesting, "depth", 0) + 1
    try:
        yield
    finally:
        _nesting.depth -= 1


def _device_of(arguments: Mapping[str, Any]) -> torch.device:
    """Where a call runs: its first tensor argument's device, else its
    ``device`` argument, else the CPU."""
    for v in arguments.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device(arguments.get("device", "cpu"))


def referents(fn: Callable) -> tuple:
    """The objects ``fn`` refers to directly: a function's closure cells
    and the globals it names, a partial's function and arguments, a bound
    method's object and function."""
    if isinstance(fn, functools.partial):
        return (fn.func, *fn.args, *fn.keywords.values())
    if inspect.ismethod(fn):
        return (fn.__self__, fn.__func__)
    if not isinstance(fn, types.FunctionType):
        return ()
    cells = []
    for cell in fn.__closure__ or ():
        try:
            cells.append(cell.cell_contents)
        except ValueError:  # a cell not bound yet
            pass
    g = fn.__globals__
    return (*cells, *(g[name] for name in fn.__code__.co_names if name in g))


class _Callable(NamedTuple):
    """A callable argument in a key: its identity and that of each of its
    :func:`referents`."""

    ident: int
    refs: Tuple[int, ...]


def _part(v: Any):
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), v.dtype, v.device)
    if callable(v):
        return _Callable(id(v), tuple(id(r) for r in referents(v)))
    return v


def _key(arguments: Mapping[str, Any]) -> tuple:
    return tuple((k, _part(v)) for k, v in arguments.items())


def _callable_ids(key: tuple) -> Iterator[int]:
    return (p.ident for _, p in key if isinstance(p, _Callable))


def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class _Reads(TorchFunctionMode):
    """The tensors a capture reads that it did not make (``read``, by id):
    the arguments of every torch function and tensor method called while
    the mode is on, ``data_ptr`` among them (the kernel wrappers hand
    those addresses to their kernels), less the results of those calls.
    A tensor made during the capture is seen as a result before it is
    used, so no intermediate is kept and the capture's pool can reuse
    its memory."""

    def __init__(self):
        super().__init__()
        self.read: Dict[int, torch.Tensor] = {}
        self._made: set = set()

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            if id(t) not in self._made:
                self.read.setdefault(id(t), t)
        out = func(*args, **kwargs)
        self._made.update(id(t) for t in _tensors(out) if id(t) not in self.read)
        return out


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


@dataclasses.dataclass
class _Program:
    """One captured solve: its graph, the static input buffers it reads
    (by argument name), the outputs it writes (in its memory pool), its
    capture record, and what its graph reads by address (``keep``)."""

    graph: torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]
    outputs: Any
    record: trace.Capture
    keep: tuple = ()

    def run(self, arguments: Mapping[str, Any]) -> None:
        """Copy the tensor arguments into the static inputs, then replay;
        the outputs are overwritten in place."""
        for k, buf in self.inputs.items():
            buf.copy_(arguments[k])
        if trace.recording():
            with trace.span("csr5.graph.launch", program=self.record.program):
                self.graph.replay()
        else:
            self.graph.replay()

    def replay(self, arguments: Mapping[str, Any]):
        """:meth:`run`, then clones of the outputs, the caller's own."""
        self.run(arguments)
        return _clone(self.outputs)


def _program(solver: str, loops: Mapping[str, int], graph, inputs: Dict[str, torch.Tensor],
             outputs: Any, nodes: Optional[Dict[str, int]], launches: Dict[str, int],
             products: Optional[Mapping[str, Sequence[Tuple[int, int]]]] = None,
             keep: tuple = (), cloned: bool = True, **fields) -> _Program:
    """A program and its capture record: the copies, nodes and clones of
    one replay (none where its caller takes the outputs themselves, not
    ``cloned``), the launches its capture enqueued and where its
    operators' calls lie (``fields``: the record's other fields, such as
    the exchange's place)."""
    record = trace.note_capture(
        solver=solver, loops=dict(loops), inputs=len(inputs),
        outputs=sum(1 for t in _tensors(outputs) if t.numel()) if cloned else 0, nodes=nodes,
        launches=dict(launches),
        products=None if products is None else {k: tuple(v) for k, v in products.items()},
        **fields)
    return _Program(graph, inputs, outputs, record, keep)


def _stream(dev: torch.device) -> torch.cuda.Stream:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _streams:
        _streams[idx] = torch.cuda.Stream(idx)
    return _streams[idx]


def _capture(body: Callable, arguments: Dict[str, Any], loops: Sequence[str],
             dev: torch.device) -> _Program:
    """Copy the tensor arguments into static inputs, warm ``body`` up with
    the loop counts at 1, then capture it whole."""
    inputs = {k: v.clone() for k, v in arguments.items() if isinstance(v, torch.Tensor)}
    # a callable stays out (its death drops the program) unless it cannot
    # be watched; the objects it refers to stay in, so no key's ids recur
    fns = [v for v in arguments.values() if callable(v)]
    keep = (*(r for fn in fns for r in referents(fn)), *(fn for fn in fns if not _watchable(fn)))
    return capture(body, {**arguments, **inputs}, inputs, dev,
                   loops={k: arguments[k] for k in loops}, keep=keep)


def _skipped(*_args, **_kwargs) -> None:
    """An operator left out of a warm-up."""


def capture(body: Callable, call: Dict[str, Any], inputs: Dict[str, torch.Tensor],
            dev: torch.device, *, loops: Optional[Mapping[str, int]] = None, keep: tuple = (),
            exchange: Optional[str] = None, cloned: bool = True) -> _Program:
    """``body(**call)`` as a program: warmed up once on the device's capture
    stream (the ``loops`` counts at 1), then captured whole on it and
    instantiated. ``inputs`` are the static buffers, among ``call``'s
    tensors, that a replay copies its arguments into; the callables of
    ``call`` are the operators whose calls the record places. A program
    that is only :meth:`_Program.run`, its outputs taken as they are, is
    not ``cloned``: its record counts no clones.

    ``exchange`` names the operator that exchanges over NCCL, on its
    process group's stream: its one call is placed in the record's
    ``exchange`` and the kernels it enqueued in ``nccl_kernels``, not in
    ``products``. The warm-up leaves it out: run there, it would be one
    exchange more than the peers make, and every later one would pair with
    the wrong peer call. So its process group must have made its
    communicator before (an eager call of the same exchange), and it
    captures in thread-local mode, since the group's watchdog thread
    queries events meanwhile."""
    loops = dict(loops or {})
    warm = {**call, **{k: min(v, 1) for k, v in loops.items()}}
    if exchange is not None:
        warm[exchange] = _skipped
    stream = _stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with _nested():
        with torch.cuda.stream(stream):
            body(**warm)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = read_launches()
        reads, products = _Reads(), _Products(stream)
        marked = {k: products.marked(k, v) for k, v in call.items() if callable(v)}
        mode = "global" if exchange is None else "thread_local"
        with torch.cuda.graph(graph, stream=stream, capture_error_mode=mode), reads:
            outputs = body(**{**call, **marked})
        counted = launches_between(before, read_launches())
    nodes = graph_nodes(graph)
    graph.instantiate()
    placed, fields = products.spans, {"operator_launches": products.launches}
    if exchange is not None:
        spans = None if placed is None else placed.pop(exchange, None)
        fields.update(exchange=None if spans is None else spans[0],
                      nccl_kernels=None if spans is None else products.kernels[exchange][0])
    return _program(body.__name__, loops, graph, inputs, outputs, nodes, counted, placed,
                    (*keep, *reads.read.values()), cloned, **fields)


def _watchable(obj: Any) -> bool:
    try:
        weakref.ref(obj)
    except TypeError:
        return False
    return True


class _Cache:
    """A decorated solver's programs by key (at most ``max_programs``,
    least recently used first out) and the keys called once (at most
    ``max_seen``). Each callable named in a key is watched: when it dies,
    every entry that names it goes."""

    def __init__(self, max_programs: int = MAX_PROGRAMS, max_seen: int = MAX_SEEN):
        self.programs: "OrderedDict[tuple, _Program]" = OrderedDict()
        self.seen: "OrderedDict[tuple, None]" = OrderedDict()
        self.max_programs, self.max_seen = max_programs, max_seen
        self._watched: set = set()

    def get(self, key: tuple) -> Optional[_Program]:
        prog = self.programs.get(key)
        if prog is not None:
            self.programs.move_to_end(key)
        return prog

    def first_call(self, key: tuple, callables: Sequence[Callable]) -> bool:
        """Note a call of ``key``, which has no program: True on its first
        call (it runs eagerly), False on its second (it is captured)."""
        if key in self.seen:
            del self.seen[key]
            return False
        self.seen[key] = None
        if len(self.seen) > self.max_seen:
            self.seen.popitem(last=False)
        for fn in callables:
            if id(fn) not in self._watched and _watchable(fn):
                weakref.finalize(fn, self._forget, id(fn)).atexit = False
                self._watched.add(id(fn))
        return True

    def put(self, key: tuple, prog: _Program) -> _Program:
        self.programs[key] = prog
        while len(self.programs) > self.max_programs:
            self.programs.popitem(last=False)
        return prog

    def _forget(self, ident: int) -> None:
        self._watched.discard(ident)
        for entries in (self.programs, self.seen):
            for k in [k for k in entries if ident in _callable_ids(k)]:
                entries.pop(k, None)

    def clear(self) -> None:
        self.programs.clear()
        self.seen.clear()


def device_program(*, loops: Sequence[str] = ()) -> Callable:
    """Run the decorated solver, on CUDA tensors, eagerly on the first
    call of a key and as one CUDA graph captured on its second call and
    replayed on every later one; on CPU tensors, as its eager body.
    ``loops`` names the arguments that are loop counts: the warm-up
    before a capture runs them at 1."""

    def wrap(body: Callable) -> Callable:
        sig = inspect.signature(body)
        missing = [k for k in loops if k not in sig.parameters]
        if missing:
            raise ValueError(f"device_program({body.__name__}): no argument named {missing}")
        cache = _Cache()

        @functools.wraps(body)
        def eager(*args, **kwargs):
            with _nested():
                return body(*args, **kwargs)

        def solve(arguments, dev, on_card, args, kwargs, attrs=None):
            prog, mode = None, "eager"
            if on_card:
                key = _key(arguments)
                prog = cache.get(key)
                if prog is not None:
                    mode = "replay"
                elif not cache.first_call(key, [v for v in arguments.values() if callable(v)]):
                    mode = "capture"
            if attrs is not None:
                attrs.update(mode=mode, program=None)
            if mode == "eager":
                return eager(*args, **kwargs)
            with torch.cuda.device(dev):
                if mode == "capture":
                    prog = cache.put(key, _capture(body, arguments, loops, dev))
                if attrs is not None:
                    attrs["program"] = prog.record.program
                return prog.replay(arguments)

        @functools.wraps(body)
        def run(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            arguments = dict(bound.arguments)
            dev = _device_of(arguments)
            on_card = dev.type == "cuda" and torch.cuda.is_available()
            if on_card and _inline():
                return body(*args, **kwargs)
            if not trace.recording():
                return solve(arguments, dev, on_card, args, kwargs)
            with trace.span("csr5.solve", solver=body.__name__) as attrs:
                return solve(arguments, dev, on_card, args, kwargs, attrs)

        run.__wrapped__ = eager
        run.cache = cache
        run.cache_clear = cache.clear
        run.cache_size = lambda: len(cache.programs)
        return run

    return wrap
