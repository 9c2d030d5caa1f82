"""The port's suite runner (``bench/suite.py``), mirroring
``tests/test_bench_summary.py``: the compact last line stays under 1024
bytes at any number of cases and names its byte models, ``check`` folds
every case, a case that raises is recorded and gives exit code 1, the
cumulative record goes to ``--out``, ``CASES`` is ``bench.py``'s list
less ``dist1_banded500k``, and the module imports without jax."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark_spmv_using_csr5_tpu_torch.bench import case_runner, suite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(name, **kw):
    rec = {
        "name": name,
        "spmv_ms": 0.04202,
        "gflops": 666.4,
        "nnz_per_sec": 3.3e11,
        "pct_hbm_streamed": 65.1,
        "pct_getb_of_hbm": 122.2,
        "streamed_bytes": 91_300_000,
        "bytes_model": "streamed: the planes the kernel reads + x + y; getB: 4 B index + 4 B value",
        "l2_resident": False,
        "l2_flushed": False,
        "storage": "bfloat16",
        "check_ok": True,
        "max_rel_err": 0.0,
        "convert_ms": 1234.5,
        "convert_phases_ms": {f"phase{i}": 100.0 + i for i in range(9)},
        "launches": {"csr5_spmv": 252},
    }
    rec.update(kw)
    return rec


def _results(n):
    names = [suite.PRIMARY] + [f"case{i}" for i in range(max(n - 1, 0))]
    return {k: _case(k) for k in names[:n]}


@pytest.mark.parametrize("n", [0, 1, 17, 40])
def test_summary_fits_in_1024_bytes(n):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    s = suite.summary(_results(n), 17, card, suite.DEFAULT_OUT)
    line = json.dumps(s)
    assert len(line) < 1024, (n, len(line))
    assert "cases" not in s and s["cases_done"] == n and s["cases_total"] == 17
    assert s["card"] == card and s["l2_flushed"] is False
    assert "streamed" in s["bytes_model"] and "getB" in s["bytes_model"]
    assert s["full"] == os.path.join("chiprun_out", "bench_torch_full.json")
    if n:
        assert s["pct_hbm_streamed"] == 65.1 and s["pct_getb_of_hbm"] == 122.2
        assert s["storage"] == "bfloat16" and s["primary_ms"] == 0.04202 and s["check"] is True
        assert "error" not in s
    else:
        assert s["check"] is False and s["error"] == "primary case did not land"
    # no field from the TPU's 819 GB/s survives
    assert "819" not in line and "pct_roofline" not in line


def test_check_folds_every_case():
    r = _results(5)
    assert suite.summary(r, 5, "cpu", "x.json")["check"] is True
    r["case2"]["check_ok"] = False
    assert suite.summary(r, 5, "cpu", "x.json")["check"] is False
    r = _results(5)
    r["case3"] = {"name": "case3", "error": "RuntimeError: boom"}
    s = suite.summary(r, 5, "cpu", "x.json")
    assert s["check"] is False and s["cases_done"] == 4


def _fake_run_one(fail=()):
    def run_one(name, device, data_dir):
        assert str(device) == "cpu"
        if name in fail:
            raise RuntimeError(f"{name} broke")
        return _case(name)

    return run_one


def _main(monkeypatch, argv, fail=()):
    monkeypatch.setattr(case_runner, "run_one", _fake_run_one(fail))
    monkeypatch.setattr(case_runner, "prewarm_arena", lambda names: None)
    return suite.main(argv)


def test_record_goes_to_out_and_lines_stream(tmp_path, monkeypatch, capsys):
    out = tmp_path / "rec" / "full.json"
    names = ["banded500k", "dia_tridiag500k", "hybmix400k"]
    rc = _main(monkeypatch, names + ["--device", "cpu", "--out", str(out)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["name"] for x in lines[:-1]] == names
    last = json.loads(lines[-1])
    assert last["check"] is True and last["cases_done"] == 3 and last["cases_total"] == 3
    assert last["card"] == "cpu" and last["full"] == str(out)
    rec = json.loads(out.read_text())
    assert list(rec["cases"]) == names and rec["check"] is True
    assert rec["cases"]["hybmix400k"]["launches"] == {"csr5_spmv": 252}


def test_errored_case_gives_exit_code_1(tmp_path, monkeypatch, capsys):
    out = tmp_path / "full.json"
    names = ["banded500k", "scrambled300k", "powerlaw200k"]
    rc = _main(monkeypatch, names + ["--device", "cpu", "--out", str(out)], fail={"scrambled300k"})
    assert rc == 1
    lines = capsys.readouterr().out.strip().splitlines()
    bad = json.loads(lines[1])
    assert bad == {"name": "scrambled300k", "error": "RuntimeError: scrambled300k broke"}
    assert json.loads(lines[2])["name"] == "powerlaw200k"  # the suite went on
    last = json.loads(lines[-1])
    assert last["check"] is False and last["cases_done"] == 2
    assert json.loads(out.read_text())["cases"]["scrambled300k"]["error"]


def test_failed_check_gives_exit_code_1(tmp_path, monkeypatch):
    def run_one(name, device, data_dir):
        return _case(name, check_ok=name != "df64_banded500k")

    monkeypatch.setattr(case_runner, "run_one", run_one)
    monkeypatch.setattr(case_runner, "prewarm_arena", lambda names: None)
    argv = ["banded500k", "df64_banded500k", "--device", "cpu", "--out", str(tmp_path / "f.json")]
    assert suite.main(argv) == 1


def test_unknown_case_is_refused(monkeypatch):
    with pytest.raises(SystemExit, match="dist1_banded500k"):
        _main(monkeypatch, ["dist1_banded500k", "--device", "cpu"])


def test_cases_are_bench_py_less_dist1():
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    cases = next(
        ast.literal_eval(node.value)
        for node in tree.body
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "CASES" for t in node.targets)
    )
    assert len(cases) == 18
    assert suite.CASES == [c for c in cases if c != "dist1_banded500k"]
    assert len(suite.CASES) == 17 and suite.PRIMARY == "banded500k" == suite.CASES[0]
    # every case has a runner
    known = set(case_runner._suite()) | set(case_runner._mtx_suite()) | {
        "dia_tridiag500k", "dia_banded2M", "spmm16_banded500k", "spmmf8_banded500k", "hybmix400k",
    }
    assert set(suite.CASES) == known


def test_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None; "
        "sys.modules['benchmark_spmv_using_csr5_tpu'] = None; "
        "import benchmark_spmv_using_csr5_tpu_torch.bench.suite as s; "
        "import benchmark_spmv_using_csr5_tpu_torch.utils.checkpoint, "
        "benchmark_spmv_using_csr5_tpu_torch.utils.debug; print(len(s.CASES))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "17"
