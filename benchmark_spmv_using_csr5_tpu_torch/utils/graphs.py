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
- **Launch counters.** During the capture the kernel wrappers run their
  Python and add to their counters, but no kernel runs; during a replay
  the kernels run and no Python does. So each graph records the launches
  its capture counted (:func:`launches_between`), takes them back out of
  the counters and adds them once per replay (:func:`add_launches`):
  ``bench.harness.kernel_launches()`` keeps counting the kernels that ran.
  What replays added is tallied apart in :data:`credited`.
- **No fallback.** A capture or replay that fails raises; nothing is
  retried eagerly or moved to the CPU.

As under ``jax.jit``, a program replays the tensors its capture read: a
matrix changed in place is read anew, one swapped in behind an object the
callable refers to (``self.A = ...`` under ``lambda v: spmv(self.A, v)``)
is not; pass a new callable for a new matrix. The decorated function's
``__wrapped__`` is its eager body, on any device, with the solvers it
calls run inline too (iterative refinement's inner CG then runs eagerly,
not as a replay).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import threading
import types
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

#: counter name -> (module, attribute): the launch counter of each kernel
Counters = Mapping[str, Tuple[Any, str]]

#: captured programs each decorated solver keeps, the least recently used
#: dropped first; each holds a memory pool with every intermediate of its
#: solve (GMRES's V: (restart + 1) * n values)
MAX_PROGRAMS = 4
#: keys called once that each decorated solver remembers, the oldest dropped
MAX_SEEN = 256

_nesting = threading.local()
#: the launches replays have added to the counters, by counter: no wrapper
#: counted these, so ``read_launches()`` less ``credited`` is what the
#: wrappers counted at a launch
credited: Dict[str, int] = {}
#: device index -> the stream programs warm up and capture on, one per
#: device so cuBLAS allocates its workspace for it once
_streams: Dict[int, torch.cuda.Stream] = {}


def kernel_counters() -> Dict[str, Tuple[Any, str]]:
    """The launch counters of the port's kernels: name -> (module,
    attribute), each a plain int the kernel's wrapper adds one to per
    launch."""
    from ..ops import bandmm_kernel, bigslice_kernel, csr5_f64, csr5_kernel, dia_kernel

    return {
        "csr5_spmv": (csr5_kernel, "launches"),
        "csr5_spmv_packed": (csr5_kernel, "packed_launches"),
        "csr5_sliced": (bigslice_kernel, "launches"),
        "csr5_spmv_f64": (csr5_f64, "launches"),
        "csr5_spmm": (csr5_kernel, "spmm_launches"),
        "csr5_spmm_packed": (csr5_kernel, "spmm_packed_launches"),
        "dia_spmv": (dia_kernel, "spmv_launches"),
        "dia_spmm": (dia_kernel, "spmm_launches"),
        "bandmm_spmm": (bandmm_kernel, "launches"),
    }


def read_launches(counters: Optional[Counters] = None) -> Dict[str, int]:
    """Each counter's value, by name (default: :func:`kernel_counters`)."""
    counters = kernel_counters() if counters is None else counters
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def launches_between(before: Mapping[str, int], after: Mapping[str, int]) -> Dict[str, int]:
    """The launches counted from ``before`` to ``after``, by name, the
    counters that did not move left out."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def add_launches(
    delta: Mapping[str, int], times: int = 1, counters: Optional[Counters] = None
) -> None:
    """Add ``times`` x ``delta`` to the counters (``times = -1`` takes a
    capture's counts back out; ``1`` credits one replay)."""
    counters = kernel_counters() if counters is None else counters
    for name, n in delta.items():
        mod, attr = counters[name]
        setattr(mod, attr, getattr(mod, attr) + times * n)


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
    (by argument name), the outputs it writes (in its memory pool), the
    kernel launches of one replay, and what its graph reads by address
    (``keep``)."""

    graph: torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]
    outputs: Any
    launches: Dict[str, int]
    keep: tuple = ()

    def replay(self, arguments: Mapping[str, Any]):
        for k, buf in self.inputs.items():
            buf.copy_(arguments[k])
        self.graph.replay()
        add_launches(self.launches)
        for k, n in self.launches.items():
            credited[k] = credited.get(k, 0) + n
        return _clone(self.outputs)


def _stream(dev: torch.device) -> torch.cuda.Stream:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _streams:
        _streams[idx] = torch.cuda.Stream(idx)
    return _streams[idx]


def _capture(body: Callable, arguments: Dict[str, Any], loops: Sequence[str],
             dev: torch.device) -> _Program:
    """Warm ``body`` up with the loop counts at 1, then capture it whole."""
    inputs = {k: v.clone() for k, v in arguments.items() if isinstance(v, torch.Tensor)}
    call = {**arguments, **inputs}
    warm = {**call, **{k: min(call[k], 1) for k in loops}}
    stream = _stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with _nested():
        with torch.cuda.stream(stream):
            body(**warm)
        graph = torch.cuda.CUDAGraph()
        before = read_launches()
        reads = _Reads()
        try:
            with torch.cuda.graph(graph, stream=stream), reads:
                outputs = body(**call)
        finally:
            counted = launches_between(before, read_launches())
            add_launches(counted, -1)  # the capture ran nothing
    # a callable stays out (its death drops the program) unless it cannot
    # be watched; the objects it refers to stay in, so no key's ids recur
    fns = [v for v in arguments.values() if callable(v)]
    keep = (*(r for fn in fns for r in referents(fn)), *(fn for fn in fns if not _watchable(fn)))
    return _Program(graph, inputs, outputs, counted, (*keep, *reads.read.values()))


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

        @functools.wraps(body)
        def run(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            arguments = dict(bound.arguments)
            dev = _device_of(arguments)
            if dev.type != "cuda" or not torch.cuda.is_available():
                return eager(*args, **kwargs)
            if _inline():
                return body(*args, **kwargs)
            key = _key(arguments)
            prog = cache.get(key)
            if prog is None:
                callables = [v for v in arguments.values() if callable(v)]
                if cache.first_call(key, callables):
                    return eager(*args, **kwargs)
                with torch.cuda.device(dev):
                    prog = cache.put(key, _capture(body, arguments, loops, dev))
            with torch.cuda.device(dev):
                return prog.replay(arguments)

        run.__wrapped__ = eager
        run.cache = cache
        run.cache_clear = cache.clear
        run.cache_size = lambda: len(cache.programs)
        return run

    return wrap
