"""The port's solvers against the JAX package's, on the matrices of
``tests/test_solvers.py``.

Both sides run CSR5 SpMV (the port's plain version here, the JAX XLA
executor there) on the same matrix and right-hand side. The two sum in
another order, so iterates drift apart by rounding; each check states how
far:

- CG, BiCGSTAB, PageRank (float64): x within 1e-10 of the JAX x, relative
  to its largest entry;
- iterative refinement (float32 inner CG on K1's plain version, float64
  residual on K4's): residual <= 1e-10 and at least 10x below float32-only
  CG, x within 1e-10 of the JAX x;
- GMRES and Lanczos (float32): x within 1e-4, the extreme Ritz values
  within 1e-4 relative;
- power iteration: the start vectors differ (a torch.Generator against a
  JAX PRNGKey), so only the eigenvalue is compared, at rtol 1e-4 as the
  JAX test holds it against scipy (2e-4 against the JAX value). The top
  eigenvalues of that matrix lie close together and the port's start
  vector converges more slowly than the JAX one: 2000 iterations to the
  JAX test's 300 (measured: 5.7e-5 after 2000, 4.9e-4 after 300).

GMRES's least squares (:func:`solvers.hessenberg_lstsq`, Givens rotations
in tensor ops) is held to ``jnp.linalg.lstsq`` on well-conditioned random
Hessenbergs and on broken-down ones, at rtol 1e-5 (float32) and 1e-12
(float64) of the largest coefficient; GMRES where Arnoldi breaks down
exactly (A = I, b an eigenvector) must give the JAX x. The CUDA-graph
path needs a card (``chip_smoke.py`` phase 11); here each decorated
solver runs its eager body, and the launch counters and the capture
record, the replay's buffers and the cache (eager first call, capture on the second,
entries dropped with their callable, the bound on programs, the tensors
a capture keeps) are checked with the counters, a stand-in card and a
stand-in graph.
"""

import types
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import eigsh

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu.models.solvers as jsolvers
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.bench import harness
from benchmark_spmv_using_csr5_tpu_torch.models import solvers
from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_f64, csr5_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import graphs, synth, trace


def _spd(m=120, seed=0):
    """``tests/test_solvers.py::_spd``: (A + A^T)/2 plus a diagonal shift."""
    a = synth.banded(m, 5, dtype=np.float64, seed=seed)
    a = (a + a.T) * 0.5 + sp.eye(m) * (np.abs(a).sum(axis=1).max() + 1.0)
    return sp.csr_matrix(a)


def _ops(a_sp):
    """(port spmv, JAX spmv) on one matrix, float64 planes kept as such."""
    host = (a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape)
    vdt = torch.float64 if a_sp.dtype == np.float64 else None
    a5p = P.build_csr5(host, value_dtype=vdt, device="cpu")
    a5j = J.build_csr5(J.csr_from_scipy(a_sp))
    return (lambda v: P.csr5_spmv(a5p, v)), (lambda v: J.csr5_spmv_xla(a5j, v))


def _close(x, x_ref, rtol):
    x, x_ref = np.asarray(x, np.float64), np.asarray(x_ref, np.float64)
    assert np.abs(x - x_ref).max() <= rtol * np.abs(x_ref).max()


def test_cg_matches_jax():
    a = _spd()
    b = np.ones(a.shape[0])
    sp_p, sp_j = _ops(a)
    x, res = solvers.conjugate_gradient(sp_p, torch.from_numpy(b), iters=200)
    xj, _ = jsolvers.conjugate_gradient(sp_j, b, iters=200)
    assert float(res) < 1e-6
    np.testing.assert_allclose(a @ x.numpy(), b, atol=1e-5)
    _close(x, xj, 1e-10)


def test_bicgstab_matches_jax():
    a = _spd(seed=3)
    a = sp.csr_matrix(a + sp.diags(np.linspace(0, 0.5, a.shape[0])))
    b = np.ones(a.shape[0])
    sp_p, sp_j = _ops(a)
    x, _ = solvers.bicgstab(sp_p, torch.from_numpy(b), iters=200)
    xj, _ = jsolvers.bicgstab(sp_j, b, iters=200)
    np.testing.assert_allclose(a @ x.numpy(), b, atol=1e-5)
    _close(x, xj, 1e-10)


def test_iterative_refinement_reaches_f64_accuracy():
    a64 = _spd(m=150, seed=7)
    a32 = a64.astype(np.float32)
    b = np.ones(150)
    hi_p, hi_j = _ops(a64)
    lo_p, lo_j = _ops(a32)
    bt = torch.from_numpy(b)
    x32, _ = solvers.conjugate_gradient(lo_p, bt.float(), iters=300)
    assert x32.dtype == torch.float32
    res32 = np.linalg.norm(a64 @ x32.double().numpy() - b)
    x_ir, res_ir = solvers.iterative_refinement(lo_p, hi_p, bt, outer_iters=4, inner_iters=100)
    assert x_ir.dtype == torch.float64
    assert float(res_ir) < 1e-10 and float(res_ir) < res32 / 10
    assert np.linalg.norm(a64 @ x_ir.numpy() - b) < 1e-10
    xj, _ = jsolvers.iterative_refinement(lo_j, hi_j, jnp.asarray(b), outer_iters=4,
                                          inner_iters=100)
    _close(x_ir, xj, 1e-10)


def test_power_iteration_dominant_eig():
    a = _spd(m=80, seed=5)
    sp_p, sp_j = _ops(a)
    gen = torch.Generator().manual_seed(0)
    lam, v = solvers.power_iteration(sp_p, a.shape[0], iters=2000, generator=gen,
                                     dtype=torch.float64, device="cpu")
    lam_j, _ = jsolvers.power_iteration(sp_j, a.shape[0], iters=300, dtype=jnp.float64)
    lam_ref = eigsh(a, k=1, which="LM", return_eigenvectors=False)[0]
    np.testing.assert_allclose(float(lam), lam_ref, rtol=1e-4)
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=2e-4)
    assert v.dtype == torch.float64 and abs(float(torch.linalg.vector_norm(v)) - 1) < 1e-12


def test_pagerank_matches_jax():
    m = 100
    a = sp.random(m, m, 0.05, random_state=7, format="csr")
    a.data[:] = 1.0
    out = np.asarray(a.sum(axis=1)).ravel()
    scale = np.divide(1.0, out, out=np.zeros_like(out), where=out > 0)
    t = sp.csr_matrix(sp.diags(scale) @ a).T.tocsr()
    sp_p, sp_j = _ops(t)
    pr = solvers.pagerank(sp_p, m, iters=100, dtype=torch.float64, device="cpu").numpy()
    pr_j = np.asarray(jsolvers.pagerank(sp_j, m, iters=100, dtype=jnp.float64))
    assert pr.shape == (m,) and (pr >= 0).all()
    np.testing.assert_allclose(pr.sum(), 1.0, atol=1e-4)
    _close(pr, pr_j, 1e-10)


def test_gmres_nonsymmetric():
    rng = np.random.default_rng(7)
    m = 200
    a = sp.csr_matrix(
        sp.diags(
            [rng.uniform(4, 5, m), rng.uniform(-1, 1, m - 1), rng.uniform(-1, 1, m - 3)],
            [0, 1, -3],
        )
    ).astype(np.float32)
    b = rng.uniform(-1, 1, m).astype(np.float32)
    sp_p, sp_j = _ops(a)
    x, res = solvers.gmres(sp_p, torch.from_numpy(b), restart=25, outer_iters=4)
    xj, _ = jsolvers.gmres(sp_j, b, restart=25, outer_iters=4)
    assert float(res) < 1e-3
    np.testing.assert_allclose(a @ x.numpy(), b, atol=1e-3)
    _close(x, xj, 1e-4)


def test_lanczos_extremal_eigs():
    m = 150
    a = sp.csr_matrix(
        sp.diags([2 * np.ones(m), -np.ones(m - 1), -np.ones(m - 1)], [0, 1, -1])
    ).astype(np.float32)
    v0 = np.random.default_rng(3).uniform(-1, 1, m).astype(np.float32)
    sp_p, sp_j = _ops(a)
    al, be, evals = solvers.lanczos(sp_p, torch.from_numpy(v0), iters=40)
    _, _, evals_j = jsolvers.lanczos(sp_j, jnp.asarray(v0), iters=40)
    lam_max = 2 - 2 * np.cos(np.pi * m / (m + 1))
    assert al.shape == be.shape == (40,)
    assert abs(float(evals[-1]) - lam_max) < 0.01 * lam_max
    evals_j = np.asarray(evals_j)
    for k in (0, -1):
        assert abs(float(evals[k]) - evals_j[k]) <= 1e-4 * lam_max


@pytest.mark.parametrize("solver", ["power_iteration", "pagerank"])
def test_solver_vectors_default_to_the_card(monkeypatch, solver):
    """Vectors a solver makes itself go to the card unless the caller
    names the CPU; without a card that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(solvers, solver)(lambda v: v, 8)


def _hessenberg(rng, k, dtype, broken):
    """A random upper Hessenberg (k + 1, k) with a dominant diagonal; when
    ``broken``, Arnoldi's breakdown at a random column j: H[j + 1, j] = 0
    and every column after j zero."""
    H = np.triu(rng.uniform(-1, 1, (k + 1, k)), -1)
    H[np.arange(k), np.arange(k)] += 4.0
    if broken:
        j = int(rng.integers(0, k))
        H[j + 1, j] = 0.0
        H[:, j + 1 :] = 0.0
    return H.astype(dtype)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("broken", [False, True], ids=["full_rank", "broken_down"])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)],
                         ids=["float32", "float64"])
def test_hessenberg_lstsq_matches_jax(dtype, rtol, broken, seed):
    rng = np.random.default_rng(seed)
    for k in (1, 2, 7, 20, 30):
        H = _hessenberg(rng, k, dtype, broken)
        g = np.zeros(k + 1, dtype)
        g[0] = rng.uniform(0.5, 2.0)  # GMRES's beta * e1
        for rhs in (g, rng.uniform(-1, 1, k + 1).astype(dtype)):
            y = solvers.hessenberg_lstsq(torch.from_numpy(H), torch.from_numpy(rhs))
            y_j = np.asarray(jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(rhs))[0])
            assert y.dtype == torch.from_numpy(H).dtype and y.shape == (k,)
            _close(y, y_j, rtol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", ["identity", "eigenvector"])
def test_gmres_breakdown_matches_jax(case, dtype):
    """Arnoldi breaks down at its first column: A = I with b = ones(64)
    (V[0] = 1/8 exactly, so w - h V[0] is exactly 0), or a diagonal A
    with b a unit vector. H then has a zero subdiagonal and zero columns
    after the first; the JAX x is b / d."""
    n = 64
    d = np.ones(n) if case == "identity" else np.linspace(1.0, 3.0, n)
    b = np.ones(n) if case == "identity" else np.eye(n)[7] * 2.0
    d, b = d.astype(dtype), b.astype(dtype)
    dt, dj = torch.from_numpy(d), jnp.asarray(d)
    x, res = solvers.gmres(lambda v: dt * v, torch.from_numpy(b), restart=10, outer_iters=2)
    x_j, _ = jsolvers.gmres(lambda v: dj * v, jnp.asarray(b), restart=10, outer_iters=2)
    assert bool(torch.isfinite(x).all()) and float(res) == 0.0
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_j))
    np.testing.assert_allclose(x.numpy(), b / d, rtol=1e-6)


def test_gmres_never_waits_on_the_host(monkeypatch):
    """GMRES's body, the least squares included, copies nothing to the
    host and reads no value there: each way a tensor reaches the host
    raises during the call."""
    rng = np.random.default_rng(5)
    m = 60
    a = np.diag(rng.uniform(4, 5, m)) + np.triu(rng.uniform(-1, 1, (m, m)), 1) * 0.1
    at = torch.from_numpy(a)
    b = torch.from_numpy(rng.uniform(-1, 1, m))

    def host(*_a, **_k):
        raise AssertionError("GMRES reached the host")

    for name in ("cpu", "item", "tolist", "numpy", "__float__", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, host)
    x, res = solvers.gmres(lambda v: at @ v, b, restart=8, outer_iters=3)
    monkeypatch.undo()
    np.testing.assert_allclose(a @ x.numpy(), b.numpy(), atol=1e-8)
    assert float(res) < 1e-8


def _fake_counters():
    mods = {k: types.SimpleNamespace(n=v) for k, v in (("k1", 3), ("k4", 0), ("k5", 7))}
    return mods, {k: (mod, "n") for k, mod in mods.items()}


def _stand_in(replay=lambda: None):
    """A stand-in graph: what its ``replay`` runs."""
    return types.SimpleNamespace(replay=replay)


def test_launch_bookkeeping_of_a_capture_and_its_replays(monkeypatch):
    """What a capture enqueued stays in the counters (a wrapper counts what
    it enqueues, eagerly or into a graph) and goes into the program's
    capture record, with where its operator's calls lie; a replay runs no
    wrapper, so it adds nothing to the counters."""
    mods, counters = _fake_counters()
    before = graphs.read_launches(counters)
    assert before == {"k1": 3, "k4": 0, "k5": 7}
    mods["k1"].n += 300  # the wrappers' Python during the capture
    mods["k4"].n += 6
    counted = graphs.launches_between(before, graphs.read_launches(counters))
    assert counted == {"k1": 300, "k4": 6}  # k5 did not move
    prog = graphs._program("cg", {"iters": 50}, _stand_in(), {}, torch.zeros(2), {"kernel": 9},
                           counted, {"spmv": [(0, 2), (5, 6)]})
    for _ in range(3):
        prog.replay({})
    assert graphs.read_launches(counters) == {"k1": 303, "k4": 6, "k5": 7}
    rec = prog.record
    assert rec.launches == {"k1": 300, "k4": 6} and rec.products == {"spmv": ((0, 2), (5, 6))}
    assert (rec.solver, rec.loops, rec.inputs, rec.outputs) == ("cg", {"iters": 50}, 0, 1)


def test_kernel_counters_are_the_harness_counters(monkeypatch):
    """One table names every kernel's counter: the harness reads it, and
    a capture's launches, the counters' moves from its start to its end,
    are read from the counters the wrappers add to."""
    assert harness.kernel_launches() == graphs.read_launches()
    monkeypatch.setattr(csr5_kernel, "launches", 20)
    monkeypatch.setattr(csr5_f64, "launches", 4)
    assert harness.kernel_launches()["csr5_spmv"] == 20
    before = graphs.read_launches()
    csr5_kernel.launches += 5
    csr5_f64.launches += 2
    assert graphs.launches_between(before, harness.kernel_launches()) == {
        "csr5_spmv": 5, "csr5_spmv_f64": 2}


def test_replay_refills_its_inputs_and_clones_its_outputs(monkeypatch):
    """A replay copies the call's tensors into the static buffers the graph
    reads and returns clones: a second call does not overwrite the first
    call's result. Its capture record counts the copies and the clones
    each replay adds to the graph's nodes. A stand-in graph doubles the
    static input into the static output."""
    monkeypatch.setattr(csr5_kernel, "launches", 0)
    inp = {"b": torch.zeros(4)}
    out = (torch.zeros(4), torch.zeros(()))

    def replay():
        out[0].copy_(2 * inp["b"])
        out[1].copy_(inp["b"].sum())

    prog = graphs._program("cg", {"iters": 1}, _stand_in(replay), inp, out, {"kernel": 2},
                           {"csr5_spmv": 3})
    b1, b2 = torch.arange(4.0), torch.ones(4)
    y1, s1 = prog.replay({"spmv": None, "b": b1})
    y2, s2 = prog.replay({"spmv": None, "b": b2})
    assert torch.equal(y1, 2 * b1) and float(s1) == 6.0
    assert torch.equal(y2, 2 * b2) and float(s2) == 4.0
    assert y1.data_ptr() != out[0].data_ptr() and csr5_kernel.launches == 0
    assert (prog.record.inputs, prog.record.outputs, prog.record.nodes) == (1, 2, {"kernel": 2})


def test_cache_key_and_device():
    """The key holds each tensor's shape, dtype and device (not its
    values), a callable by its identity and that of each object it refers
    to, and every other argument by value; the device is the first
    tensor's, else the ``device`` argument's."""
    A = torch.eye(5)
    spmv = lambda v: A @ v  # noqa: E731
    k1 = graphs._key({"spmv": spmv, "b": torch.zeros(5), "iters": 3})
    assert k1 == graphs._key({"spmv": spmv, "b": torch.ones(5), "iters": 3})
    assert k1 != graphs._key({"spmv": lambda v: v, "b": torch.zeros(5), "iters": 3})
    assert k1 != graphs._key({"spmv": spmv, "b": torch.zeros(6), "iters": 3})
    assert k1 != graphs._key({"spmv": spmv, "b": torch.zeros(5, dtype=torch.float64), "iters": 3})
    assert k1 != graphs._key({"spmv": spmv, "b": torch.zeros(5), "iters": 4})
    A = 2 * torch.eye(5)  # the closure's matrix rebound: a new key
    assert k1 != graphs._key({"spmv": spmv, "b": torch.zeros(5), "iters": 3})
    assert list(graphs._callable_ids(k1)) == [id(spmv)]
    assert graphs._device_of({"spmv": spmv, "b": torch.zeros(2)}) == torch.device("cpu")
    assert graphs._device_of({"spmv": spmv, "n": 4, "device": "cuda"}).type == "cuda"


def test_referents_of_each_kind_of_callable():
    """What a callable refers to directly: a closure's cells and the
    globals it names, a partial's function and arguments, a bound
    method's object and function; nothing for a builtin."""
    import functools

    A = torch.eye(3)
    f = lambda v: P.csr5_spmv(A, v)  # noqa: E731
    refs = graphs.referents(f)
    assert any(r is A for r in refs) and any(r is P for r in refs)
    part = functools.partial(torch.mv, A)
    assert graphs.referents(part) == (torch.mv, A)
    holder = types.SimpleNamespace()
    bound = types.MethodType(lambda self, v: v, holder)
    assert graphs.referents(bound)[0] is holder
    assert graphs.referents(len) == ()


def _toy_program(monkeypatch):
    """A decorated toy solver ``scale(f, b, iters) = f(b) * iters`` on a
    stand-in card: every call counts as a CUDA call, a capture builds a
    program whose stand-in graph computes ``2 * b * iters`` from its
    static input. Returns (scale, body calls, captures)."""
    import contextlib

    calls, captures = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_device_of", lambda arguments: torch.device("cuda", 0))

    def capture(body, arguments, loops, dev):
        captures.append(tuple(loops))
        inp = {"b": arguments["b"].clone()}
        out = torch.zeros_like(inp["b"])
        iters = arguments["iters"]
        graph = _stand_in(lambda: out.copy_(2 * inp["b"] * iters))
        return graphs._program("scale", {"iters": iters}, graph, inp, out, None, {})

    monkeypatch.setattr(graphs, "_capture", capture)

    @graphs.device_program(loops=("iters",))
    def scale(f, b, iters=2):
        calls.append(iters)
        return f(b) * iters

    return scale, calls, captures


def test_first_call_is_eager_and_the_second_captures(monkeypatch):
    """A key's first call runs the eager body and captures nothing; its
    second captures and replays; later calls only replay, each from its
    own inputs, each result its own tensor."""
    scale, calls, captures = _toy_program(monkeypatch)
    f = lambda v: 2 * v  # noqa: E731
    b = torch.ones(3)
    y1 = scale(f, b)
    assert calls == [2] and captures == [] and scale.cache_size() == 0
    y2 = scale(f, 3 * b)
    assert calls == [2] and captures == [("iters",)] and scale.cache_size() == 1
    y3 = scale(f, 5 * b)
    assert calls == [2] and len(captures) == 1
    assert torch.equal(y1, 4 * b) and torch.equal(y2, 12 * b) and torch.equal(y3, 20 * b)
    scale(f, b, iters=3)  # another loop count: a new key, eager again
    assert calls == [2, 3] and len(captures) == 1


def test_a_new_lambda_per_call_never_captures_and_a_dead_one_drops_its_program(monkeypatch):
    """The callables in a key are watched, not held: twenty solves with a
    new lambda each leave no entry, and a kept callable's program goes
    when the callable dies."""
    scale, calls, captures = _toy_program(monkeypatch)
    b = torch.ones(4)
    for k in range(20):
        scale(lambda v: 2 * v, b)
    assert len(calls) == 20 and captures == []
    assert scale.cache_size() == 0 and len(scale.cache.seen) == 0
    f = lambda v: 2 * v  # noqa: E731
    for _ in range(3):
        scale(f, b)
    assert scale.cache_size() == 1 and len(captures) == 1
    del f
    assert scale.cache_size() == 0 and len(scale.cache.seen) == 0


def test_cache_is_bounded_least_recently_used_first():
    """A solver keeps at most ``max_programs`` programs, dropping the least
    recently used, and at most ``max_seen`` keys called once; a callable
    that cannot be watched is still taken."""
    class Unwatchable:
        __slots__ = ()

        def __call__(self, v):
            return v

    f = Unwatchable()
    with pytest.raises(TypeError):
        weakref.ref(f)
    keys = [graphs._key({"spmv": f, "iters": k}) for k in range(5)]
    cache = graphs._Cache(max_programs=2, max_seen=3)
    progs = [object() for _ in range(3)]
    cache.put(keys[0], progs[0])
    cache.put(keys[1], progs[1])
    assert cache.get(keys[0]) is progs[0]  # now the most recent
    cache.put(keys[2], progs[2])
    assert list(cache.programs) == [keys[0], keys[2]]
    assert all(cache.first_call(k, [f]) for k in keys)
    assert list(cache.seen) == keys[2:]
    assert cache.first_call(keys[4], [f]) is False and keys[4] not in cache.seen


def test_capture_keeps_what_it_read_not_what_it_made():
    """The tensors a capture holds are those it read and did not make: the
    matrix planes the spmv read and the right-hand side, none of the
    solver's intermediates."""
    import dataclasses

    a = _spd(m=60, seed=4)
    a5 = P.build_csr5((a.indptr, a.indices, a.data, a.shape), value_dtype=torch.float64,
                      device="cpu")
    b = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, 60))
    planes = {id(getattr(a5, f.name)) for f in dataclasses.fields(a5)
              if isinstance(getattr(a5, f.name), torch.Tensor)}
    reads = graphs._Reads()
    with reads:
        solvers.gmres.__wrapped__(lambda v: P.csr5_spmv(a5, v), b, 5, 2)
    held = set(reads.read)
    assert id(b) in held and id(a5.val_tiles) in held and id(a5.col_idx_tiles) in held
    assert held <= planes | {id(b)}


def test_replays_are_tallied_apart(monkeypatch):
    """A replay's launches are tallied apart from the wrappers' counters:
    the counters stay where the capture left them, and the capture record
    of the program, times its replays, is what ran."""
    monkeypatch.setattr(csr5_kernel, "launches", 7)
    prog = graphs._program("pagerank", {"iters": 7}, _stand_in(), {}, torch.zeros(1),
                           {"kernel": 40, "memset": 1}, {"csr5_spmv": 7})
    prog.replay({})
    prog.replay({})
    assert csr5_kernel.launches == 7
    assert trace.captures()[prog.record.program].launches == {"csr5_spmv": 7}


def test_nested_programs_run_inline():
    """Inside another program's warm-up or capture a decorated solver
    runs its body as written (iterative refinement's inner CG joins the
    outer graph); a loop count the solver does not have is refused."""
    with graphs._nested():
        with graphs._nested():
            assert graphs._inline()
        assert graphs._inline()
    assert graphs._nesting.depth == 0
    with pytest.raises(ValueError, match="no argument named"):
        graphs.device_program(loops=("iters",))(lambda spmv, b, n=3: b)


#: the seven solvers' device programs (power iteration and Lanczos keep
#: their host draw and eigvalsh outside theirs)
DEVICE_PROGRAMS = (
    "conjugate_gradient", "bicgstab", "iterative_refinement", "power_iteration_loop",
    "pagerank", "gmres", "lanczos_loop",
)


def _solver_calls():
    """Each decorated solver with CPU arguments: (name, function, args)."""
    a = _spd(m=90, seed=2)
    host = (a.indptr, a.indices, a.data, a.shape)
    a64 = P.build_csr5(host, value_dtype=torch.float64, device="cpu")
    a32 = P.build_csr5(host, value_dtype=torch.float32, device="cpu")
    hi = lambda v: P.csr5_spmv(a64, v)  # noqa: E731
    lo = lambda v: P.csr5_spmv(a32, v)  # noqa: E731
    b = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, 90))
    return {
        "conjugate_gradient": (hi, b, 40),
        "bicgstab": (hi, b, 30),
        "iterative_refinement": (lo, hi, b, 3, 20),
        "power_iteration_loop": (hi, b, 50),
        "pagerank": (hi, 90, 0.85, 20, torch.float64, "cpu"),
        "gmres": (hi, b, 10, 3),
        "lanczos_loop": (hi, b, 12),
    }


@pytest.mark.parametrize("name", DEVICE_PROGRAMS)
def test_cpu_path_is_the_eager_body(name):
    """Each of the seven device programs keeps its eager body as
    ``__wrapped__``, and on CPU tensors the call is that body."""
    fn = getattr(solvers, name)
    body = fn.__wrapped__
    assert body is not fn and body.__name__ == name and callable(fn.cache_clear)
    args = _solver_calls()[name]
    out, ref = fn(*args), body(*args)
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
