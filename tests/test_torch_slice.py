"""The port's CLI paths as a whole, on the CPU, against the JAX pipeline.

``cli.run`` loads the matrix, reorders it, picks the format, converts it,
checks y against scipy at the reference's 1 % gate and times it, as the
JAX CLI does: CSR5, DIA (SpMV and SpMM), HYB5, ``--format auto`` and
``--reorder rcm|auto``, SpMM (``--spmm K``) through csr5, dia, bandblock
and auto, ``--dtype float64`` (CSR5 SpMV on a float64 plane, K4's plain
version here) and ``--autotune``. The CLI runs on the card unless given
``--backend torch``, which every run here passes. On these
integer-valued inputs the check must give max rel err 0.0, and y must
equal the JAX pipeline's y on the same seed (``default_rng(0)``; the
JAX package under x64 for float64), exactly.
"""

import argparse
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu.ops.bandmm as jbb
import benchmark_spmv_using_csr5_tpu.ops.dia as jdia
import benchmark_spmv_using_csr5_tpu.ops.hyb as jhyb
import benchmark_spmv_using_csr5_tpu.ops.select as jsel
import benchmark_spmv_using_csr5_tpu.utils.reorder as jreorder
from benchmark_spmv_using_csr5_tpu.bench import cli as jcli
from benchmark_spmv_using_csr5_tpu.bench.harness import run_benchmark as jax_run_benchmark
from benchmark_spmv_using_csr5_tpu.ops.csr5_spmv import csr5_spmm_xla, csr5_spmv_xla
from benchmark_spmv_using_csr5_tpu_torch.bench import cli, harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "example.mtx")


@pytest.mark.parametrize("argv", [[EXAMPLE], ["--synthetic", "banded:3000:27"]])
def test_slice_matches_jax_pipeline(argv):
    res = cli.run(argv + ["--num-run", "2", "--backend", "torch"])
    assert res.check_ok and res.max_rel_err == 0.0
    assert res.backend == "torch" and res.device == "cpu"
    assert res.pct_hbm_streamed is None and res.pct_getb_of_hbm is None  # a host time has no roofline
    assert "roofline not measured" in res.report()

    rp, ci, v, shape, name = jcli.load_matrix(
        argparse.Namespace(
            matrix=argv[0] if len(argv) == 1 else None,
            synthetic=argv[1] if len(argv) == 2 else None,
            dtype="float32",
        )
    )
    jres = jax_run_benchmark(name, rp, ci, v, shape, num_run=2)
    assert jres.check_ok and jres.max_rel_err == 0.0
    assert res.storage == jres.storage == "bfloat16"
    assert (res.nnz, res.sigma) == (jres.nnz, jres.sigma)
    x = np.random.default_rng(0).integers(1, 10, size=shape[1]).astype(np.float32)
    y_jax = np.asarray(csr5_spmv_xla(jres.matrix, x))
    np.testing.assert_array_equal(res.y.numpy(), y_jax)


@pytest.mark.parametrize(
    "extra,item",
    [
        (["--dtype", "float64"], "item 7"),
        (["--spmm", "4"], "item 8"),
        (["--format", "bandblock"], "item 8"),
        (["--autotune"], "item 2"),
        (["--format", "auto", "--spmm", "4"], "item 8"),
        (["--format", "hyb", "--spmm", "4"], "item 8"),
    ],
)
def test_cli_unported_choices_raise(extra, item):
    """Choices the port did not run yet raised here naming their ROADMAP
    item. Every one is ported now (item 8, SpMM, first; items 7 and 2,
    float64 and the autotuned build, after it) and does what the JAX CLI does
    on example.mtx: SpMM in the format it picks, the band-block gate's
    exit, HYB5's SpMV-only exit, float64 CSR5 SpMV on a float64 plane and
    the re-tuned sigma."""
    argv = [EXAMPLE, "--num-run", "1", "--backend", "torch"] + extra
    if item != "item 8":
        res = cli.run(argv)
        jfmt, _, y_jax = _jax_cli_y([EXAMPLE] + extra)
        assert res.format == jfmt == "csr5" and res.check_ok and res.max_rel_err == 0.0
        want = "float64" if item == "item 7" else "bfloat16"
        assert res.storage == want and res.y.dtype == getattr(torch, res.dtype)
        np.testing.assert_array_equal(res.y.numpy(), y_jax)
    elif "hyb" in extra:
        with pytest.raises(SystemExit, match="supports SpMV only"):
            cli.run(argv)
    elif "bandblock" in extra:
        with pytest.raises(SystemExit, match="no bounded column windows"):
            cli.run(argv)
    else:
        res = cli.run(argv)
        jfmt, _, y_jax = _jax_cli_y([EXAMPLE] + extra)
        assert res.format == jfmt and res.num_rhs == 4
        assert res.check_ok and res.max_rel_err == 0.0
        np.testing.assert_array_equal(res.y.numpy(), y_jax)


def _jax_cli_y(argv):
    """The JAX CLI's path for ``argv`` (``cli.py:106-168``, ``_run_dia``,
    ``_run_hyb``): the same loading, reordering and format choice, with
    the Pallas DIA kernel in interpret mode and the XLA CSR5 executor.
    Returns (format, name, y) for x from ``default_rng(0)``."""
    args = cli.parse_args(argv)
    rp, ci, v, shape, name = jcli.load_matrix(args)
    if args.reorder == "auto":
        plan = jsel.select_plan(rp, ci, shape)
        if plan.reorder is not None:
            (rp, ci, v, shape), _ = jsel.apply_plan((rp, ci, v, shape), plan)
            name = f"{name}+{plan.reorder}"
    elif args.reorder != "none":
        a_perm, _ = jreorder.reorder_for_locality(
            sp.csr_matrix((v, ci, rp), shape=shape), method=args.reorder
        )
        rp, ci, v = a_perm.indptr, a_perm.indices, a_perm.data
        name = f"{name}+{args.reorder}"
    host = (rp, ci, v, shape)
    fmt = args.format
    if fmt == "auto":
        fmt = jsel.select_format(rp, ci, shape)
        if args.spmm > 1:  # the JAX CLI's multi-rhs choice (cli.py:139-147)
            if jbb.build_bandblock(host) is not None:
                fmt = "bandblock"
            elif fmt != "dia":
                fmt = "csr5"
    rng = np.random.default_rng(0)
    if fmt == "bandblock":  # _run_bandblock (cli.py:171-215)
        x = rng.integers(1, 10, (shape[1], max(args.spmm, 1))).astype(np.float32)
        y = jbb.bandmm_spmm(jbb.build_bandblock(host), x, interpret=True)
    elif fmt == "csr5" and args.spmm > 1:  # run_benchmark(num_rhs=K) on the CPU
        x = rng.integers(1, 10, (shape[1], args.spmm)).astype(np.float32)
        a5 = J.build_csr5(host, J.CSR5Config(sigma=J.compute_sigma(shape[0], len(v))))
        y = csr5_spmm_xla(a5, x)
    elif fmt == "dia":
        x = rng.integers(1, 10, (shape[1], args.spmm) if args.spmm > 1 else shape[1])
        d = jdia.build_dia(host)
        fn = jdia.dia_spmm if args.spmm > 1 else jdia.dia_spmv
        y = fn(d, x.astype(np.float32), interpret=True)
    elif fmt == "hyb":
        x = rng.integers(1, 10, shape[1]).astype(np.float32)
        y = jhyb.hyb_spmv(jhyb.build_hyb(host), x, csr5_backend="xla", interpret=True)
    else:  # run_benchmark: float64 values stay float64 under x64
        x = rng.integers(1, 10, shape[1]).astype(v.dtype)
        cfg = J.CSR5Config(sigma=J.compute_sigma(shape[0], len(v), args.sigma))
        if args.autotune and args.sigma == J.AUTO_TUNED_SIGMA:
            a5 = J.build_csr5_autotuned(host, cfg)
        else:
            a5 = J.build_csr5(host, cfg)
        y = csr5_spmv_xla(a5, x)
    return fmt, name, np.asarray(y)


@pytest.mark.parametrize(
    "argv,fmt",
    [
        (["--synthetic", "banded:3000:27", "--format", "dia"], "dia"),
        (["--synthetic", "banded:3000:27", "--format", "dia", "--spmm", "4"], "dia"),
        (["--synthetic", "fem:3000", "--format", "hyb"], "hyb"),
        (["--synthetic", "banded:3000:27", "--format", "auto"], "dia"),
        (["--synthetic", "fem:3000", "--format", "auto"], "hyb"),
        (["--synthetic", "scatband:3000:12:1800", "--reorder", "rcm"], "csr5"),
        (["--synthetic", "powerlaw:3000:8", "--reorder", "auto", "--format", "auto"], "csr5"),
    ],
    ids=["dia", "dia-spmm4", "hyb", "auto-dia", "auto-hyb", "rcm", "reorder-auto"],
)
def test_cli_format_paths_match_jax(argv, fmt):
    """Each format and reorder path of the CLI checks PASS with max rel
    err 0.0 on the CPU and gives the JAX CLI path's y, exactly."""
    res = cli.run(argv + ["--num-run", "2", "--backend", "torch"])
    assert res.check_ok and res.max_rel_err == 0.0
    assert res.backend == "torch" and res.format == fmt
    jfmt, jname, y_jax = _jax_cli_y(argv)
    assert (res.format, res.name) == (jfmt, jname)
    assert res.y.shape == y_jax.shape
    np.testing.assert_array_equal(res.y.numpy(), y_jax)
    if cli.parse_args(argv).format == "auto":
        assert f"auto-selected format: {fmt}" in res.report()
    assert not any(res.launches.values())  # no kernel runs on the CPU


@pytest.mark.parametrize(
    "argv,fmt,kernel",
    [
        (["--synthetic", "banded:3000:27", "--spmm", "8"], "csr5", "csr5_spmm"),
        (["--synthetic", "banded:3000:27", "--format", "bandblock", "--spmm", "8"],
         "bandblock", "bandmm_spmm"),
        (["--synthetic", "banded:3000:27", "--format", "bandblock"], "bandblock", "bandmm_spmm"),
        (["--synthetic", "banded:3000:27", "--format", "auto", "--spmm", "8"],
         "bandblock", "bandmm_spmm"),
        (["--synthetic", "powerlaw:3000:8", "--format", "auto", "--spmm", "8"], "csr5", "csr5_spmm"),
        (["--synthetic", "banded:3000:3", "--format", "auto", "--spmm", "8"], "dia", "dia_spmm"),
        (["--synthetic", "fem:3000", "--format", "auto", "--spmm", "5"], None, None),
    ],
    ids=["csr5", "bandblock", "bandblock-spmv", "auto-banded", "auto-scattered",
         "auto-tridiag", "auto-fem"],
)
def test_cli_spmm_paths_match_jax(argv, fmt, kernel):
    """``--spmm K`` through every format the CLI routes it to, with
    ``--backend torch``: PASS with max rel err 0.0, the format the JAX CLI
    picks, and the JAX CLI path's Y, exactly."""
    res = cli.run(argv + ["--num-run", "2", "--backend", "torch"])
    assert res.check_ok and res.max_rel_err == 0.0 and res.backend == "torch"
    jfmt, jname, y_jax = _jax_cli_y(argv)
    assert (res.format, res.name) == (jfmt, jname)
    if fmt is not None:
        assert res.format == fmt
    R = cli.parse_args(argv).spmm
    assert res.num_rhs == R and res.y.shape == y_jax.shape == (res.m, R)
    np.testing.assert_array_equal(res.y.numpy(), y_jax)
    if kernel is not None:
        assert kernel in res.launches and not any(res.launches.values())
    assert ("SpMM" if R > 1 or res.format == "bandblock" else "SpMV") in res.report()


@pytest.mark.parametrize("fmt", ["hyb", "auto"])
def test_cli_hyb_spmm_refused_like_jax(fmt):
    """Both CLIs refuse ``--format hyb --spmm K > 1`` with the JAX
    message; ``--format auto --spmm K`` never picks hyb in either."""
    argv = ["--synthetic", "fem:3000", "--format", fmt, "--spmm", "4", "--num-run", "1"]
    if fmt == "hyb":
        with pytest.raises(SystemExit, match=r"--format hyb supports SpMV only \(--spmm 1\)"):
            jcli.main(argv)
        with pytest.raises(SystemExit, match=r"--format hyb supports SpMV only \(--spmm 1\)"):
            cli.run(argv + ["--backend", "torch"])
    else:
        res = cli.run(argv + ["--backend", "torch"])
        assert res.format != "hyb" and res.format == _jax_cli_y(argv)[0]


def test_cli_dia_rejects_unstructured_matrix():
    with pytest.raises(SystemExit, match="not diagonal-structured"):
        cli.run(["--synthetic", "powerlaw:2000:8", "--format", "dia", "--num-run", "1",
                 "--backend", "torch"])


def test_cli_reorder_requires_square():
    args = cli.parse_args(["--reorder", "rcm", "--backend", "torch"])
    a = sp.csr_matrix(np.ones((2, 3), np.float32))
    with pytest.raises(SystemExit, match="square"):
        cli.run_matrix(args, "rect", a.indptr, a.indices, a.data, a.shape)


def test_cli_cuda_backend_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run([EXAMPLE, "--backend", "cuda"])


def test_harness_rejects_float64_values():
    """The harness refused float64 values until K4 was ported. Now CSR5
    SpMV takes them on a float64 plane; the formats and SpMM with no
    float64 kernel still refuse them, naming the format, and never narrow
    to float32."""
    rp, ci = np.array([0, 1]), np.array([0], np.int32)
    res = harness.run_benchmark("f64", rp, ci, np.ones(1), (1, 1), num_run=1, device="cpu")
    assert res.check_ok and res.storage == "float64" and res.y.dtype == torch.float64
    assert "csr5_spmv_f64" in res.launches
    runs = {
        "dia": lambda v: harness.run_dia("f64", rp, ci, v, (1, 1), device="cpu"),
        "hyb": lambda v: harness.run_hyb("f64", rp, ci, v, (1, 1), device="cpu"),
        "bandblock": lambda v: harness.run_bandblock("f64", rp, ci, v, (1, 1), device="cpu"),
        "csr5 --spmm 2": lambda v: harness.run_benchmark(
            "f64", rp, ci, v, (1, 1), num_rhs=2, device="cpu"),
    }
    for fmt, go in runs.items():
        with pytest.raises(SystemExit, match=f"--format {fmt}.* has no float64 kernel"):
            go(np.ones(1))


def test_cli_main_prints_report(capsys):
    assert cli.main([EXAMPLE, "--num-run", "1", "--backend", "torch"]) == 0
    out = capsys.readouterr().out
    assert "Check... PASS!" in out and "[torch, bfloat16, cpu]" in out


@pytest.mark.parametrize("argv", [[EXAMPLE], ["--synthetic", "banded:3000:27"]])
def test_cli_float64_matches_jax_pipeline(argv):
    """``--dtype float64`` (CSR5 SpMV on a float64 plane, the plain
    version of K4 on the CPU) checks PASS with max rel err 0.0 and gives
    the JAX pipeline's float64 y under x64, exactly."""
    argv = argv + ["--dtype", "float64"]
    res = cli.run(argv + ["--num-run", "2", "--backend", "torch"])
    assert res.check_ok and res.max_rel_err == 0.0 and res.format == "csr5"
    assert res.storage == "float64" and res.dtype == "float64"
    assert res.y.dtype == torch.float64 and res.matrix.val_tiles.dtype == torch.float64
    jfmt, jname, y_jax = _jax_cli_y(argv)
    assert y_jax.dtype == np.float64 and (res.format, res.name) == (jfmt, jname)
    np.testing.assert_array_equal(res.y.numpy(), y_jax)


@pytest.mark.parametrize(
    "extra,fmt",
    [
        (["--format", "dia"], "dia"),
        (["--format", "hyb"], "hyb"),
        (["--format", "bandblock"], "bandblock"),
        (["--format", "auto"], "dia"),
        (["--spmm", "4"], "csr5"),
    ],
    ids=["dia", "hyb", "bandblock", "auto-dia", "spmm4"],
)
def test_cli_float64_without_kernel_exits(extra, fmt):
    """Every float64 combination but CSR5 SpMV exits naming the format
    that has no float64 kernel, as the JAX DIA path does; nothing is
    narrowed to float32."""
    argv = ["--synthetic", "banded:3000:27", "--dtype", "float64", "--backend", "torch"]
    with pytest.raises(SystemExit, match=f"--format {fmt}.* has no float64 kernel"):
        cli.run(argv + extra)


@pytest.mark.parametrize("synthetic", ["fem:3000", "powerlaw:3000:20", "scatband:3000:12:1800"])
def test_cli_autotune_picks_jax_sigma(synthetic):
    """``--autotune`` re-tunes sigma as the JAX CLI does (32 -> 16,
    16 -> 8, and 8 kept on these scattered matrices), with the same y."""
    argv = ["--synthetic", synthetic, "--autotune"]
    res = cli.run(argv + ["--num-run", "1", "--backend", "torch"])
    args = cli.parse_args(argv)
    rp, ci, v, shape, _ = jcli.load_matrix(args)
    cfg = J.CSR5Config(sigma=J.compute_sigma(shape[0], len(v)))
    a5j = J.build_csr5_autotuned((rp, ci, v, shape), cfg, value_dtype="auto")
    assert res.sigma == a5j.sigma and res.matrix.sigma == a5j.sigma
    assert res.check_ok and res.max_rel_err == 0.0
    np.testing.assert_array_equal(res.y.numpy(), _jax_cli_y(argv)[2])


def test_default_device_is_the_card(monkeypatch):
    """With no device named, a builder, the harness and the CLI ask for
    the card; without one they raise, naming the device argument or the
    backend, and never carry on on the CPU."""
    import benchmark_spmv_using_csr5_tpu_torch as P

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = sp.csr_matrix(np.eye(4, dtype=np.float32))
    for build in (P.build_csr5, P.build_dia, P.build_hyb, P.build_bandblock,
                  P.build_csr5_autotuned):
        with pytest.raises(RuntimeError, match="device='cuda'.*no CUDA device"):
            build(a)
    with pytest.raises(RuntimeError, match="device='cuda'.*no CUDA device"):
        P.SpMVHandle(4, 4)
    with pytest.raises(RuntimeError, match="device='cuda'.*no CUDA device"):
        harness.run_benchmark("eye", a.indptr, a.indices, a.data, a.shape)
    with pytest.raises(RuntimeError, match="--backend auto: no CUDA device"):
        cli.run([EXAMPLE])
