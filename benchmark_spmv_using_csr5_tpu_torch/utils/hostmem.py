"""Host-memory allocation helpers for this platform's write pathology.

Copied unchanged from ``benchmark_spmv_using_csr5_tpu/utils/hostmem.py``:
the JAX package cannot be imported without jax and flax, which the
port does not depend on.

Measured (NOTES.md): the FIRST write to a fresh large (>~30 MB)
anonymous numpy mapping runs at ~8 MB/s on this host unless it goes
through memset/memcpy — ``np.empty`` + a C++ or SIMD store loop costs
tens of seconds per 100 MB (native tile transpose: 16.6 s into
``np.empty`` vs 0.14 s into a prefaulted buffer, same call). Prefault
with ``np.zeros`` + ``.fill(0)`` (memset faults pages at GB/s), then
in-place writes run at full speed. Slice-assignment/memcpy into lazy
``np.zeros`` pages is also fast; scattered or SIMD first writes are not.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def prefaulted(shape, dtype) -> np.ndarray:
    """A zeroed numpy buffer whose pages are already faulted in (safe to
    first-write with scattered/SIMD stores at full speed)."""
    a = np.zeros(shape, dtype=dtype)
    a.fill(0)
    return a


# ---------------------------------------------------------------------------
# Process-lifetime buffer arena.
#
# Even prefaulted buffers pay the first-touch cost once per allocation, and
# glibc's reuse of freed large mappings is state-dependent on this host —
# the SAME conversion measured 2.1 s and 25.1 s in one process (BENCH_r02),
# and a fresh-process 437 MB first-touch runs at ~90 MB/s vs ~9 GB/s into a
# kept buffer. Conversion-scale scratch therefore comes from a tag-keyed
# arena that never frees: each tag holds one growing buffer reused across
# calls, making conversion time deterministic. Callers MUST NOT hold two
# live views of the same tag, and must copy out (e.g. jnp.asarray) anything
# that outlives the next call with that tag.
# ---------------------------------------------------------------------------

_ARENA: Dict[str, np.ndarray] = {}


def arena_take(shape, dtype, tag: str, zero: bool = True) -> np.ndarray:
    """A reusable buffer of ``shape``/``dtype`` keyed by ``tag``.

    Returns a view over a kept byte buffer (grown as needed, never freed);
    ``zero=True`` memsets it (fast: pages are already faulted). The view is
    only valid until the next ``arena_take`` with the same tag.
    """
    dtype = np.dtype(dtype)
    shape = (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)
    need = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    buf = _ARENA.get(tag)
    if buf is None or buf.nbytes < need:
        buf = prefaulted(max(need, 1), np.uint8)
        _ARENA[tag] = buf
    view = buf[:need].view(dtype).reshape(shape)
    if zero:
        view.fill(0)
    return view


def arena_bytes() -> int:
    """Total bytes currently held by the arena (observability)."""
    return sum(b.nbytes for b in _ARENA.values())


def arena_clear() -> None:
    """Drop every arena buffer (tests / memory-pressure escape hatch)."""
    _ARENA.clear()


def chunked_random_integers(rng, lo, hi, out, chunk=1 << 21):
    """``rng.integers`` into a prefaulted buffer in cache-sized chunks
    (the one-shot call writes a fresh slow buffer)."""
    n = out.shape[0]
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        out[s:e] = rng.integers(lo, hi, size=e - s)
    return out
