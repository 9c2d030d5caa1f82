"""``BENCHMARK.json`` against the benchmark's contract: keys, names,
units, lengths, and every file a cell names present under ``paths``."""

import json
import re
from pathlib import Path

import pytest

from csr5_bench import harness, yardstick

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in SPEC["command"])


def test_run_seconds_fits_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert (ROOT / "csr5_bench" / "generators" / f"{cfg['generator']}.py").exists()
        assert cfg["byte_model"] in yardstick.BYTE_MODELS
        assert cfg["precision"] in harness.PLANES


def test_workloads():
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (ROOT / "csr5_bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "csr5_bench" / "limits" / f"{w['name']}.json").exists()


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_metric_names_and_units():
    names = [m["name"] for m in _metrics()]
    assert len(set(names)) == len(names)
    for m in _metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in SPEC["workloads"]}


def test_end_to_end():
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


def test_per_layer():
    assert 1 <= len(SPEC["per_layer"]) <= 128
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert "bound" not in m and _line(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "csr5_bench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_enough(cell):
    c = harness.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:  # what a per-layer metric moves, its cells report
        assert m["moves"] in names


def test_files_named_from_names():
    for path in (ROOT / "csr5_bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert PATH.match(str(Path(path).relative_to(ROOT))), path
