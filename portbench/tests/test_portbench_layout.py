"""BENCHMARK.json and the files it names: every cell, configuration and
metric resolves to its file by name, and a new one needs new files and
entries only."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.lib import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200
    spec = json.loads((ROOT / "portbench" / "cells"
                       / f"{cell['name']}.json").read_text())
    driver = ROOT / "portbench" / "drivers" / f"{spec['driver']}.py"
    module = harness.load_module(driver, "layout_" + spec["driver"])
    for fn in ("setup", "step", "release", "readings"):
        assert callable(getattr(module, fn)), fn
    assert (ROOT / "portbench" / "configs"
            / f"{cell['config']}.json").is_file()
    assert spec["limits"], "a cell's check needs limits"
    reported = [m for m in BENCH["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]])
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("portbench/")
    data = json.loads(path.read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    path = ROOT / "portbench" / "metrics" / f"{metric['name']}.py"
    module = harness.load_module(path, "layout_m_" + metric["name"]
                                 .replace(".", "_"))
    assert callable(module.read)
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e and "\n" not in metric["layer"]
        if metric["name"].endswith("_roofline") or "_roofline." in \
                metric["name"]:
            assert metric["unit"] == "%"


def test_new_cell_config_and_metric_need_new_files_only(tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric added as
    files plus BENCHMARK.json entries, in a copy, run on the CPU with no
    edit to any file the benchmark has."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "configs" / "tinydb.json").write_text(json.dumps({
        "source": "test", "reduced": [], "families": 8,
        "train_per_family": 4, "test_per_family": 4, "dim": 32,
        "centroid_scale": 10.0, "metric": "cosine"}))
    (pb / "cells" / "tinydb.sq8.json").write_text(json.dumps({
        "driver": "allvsall", "units_per_call": 64, "k": 40,
        "recall_target": 0.98, "check_queries": 8,
        "limits": {"miss_share": 0.02, "score_abs_err": 1e-3}}))
    for name in ("passes", "passes_traced"):
        (pb / "metrics" / f"{name}.py").write_text(
            "def read(run):\n    return float(len(run.calls))\n")
    bench["configs"].append({"name": "tinydb", "source": "test",
                             "file": "portbench/configs/tinydb.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tinydb.sq8", "config": "tinydb",
                               "traffic": "sq8", "chips": 1, "why": "test"})
    bench["end_to_end"].append({
        "name": "passes", "unit": "1", "better": "higher", "bound": 0.05,
        "source": "host_clock", "workloads": ["tinydb.sq8"]})
    bench["per_layer"].append({
        "name": "passes_traced", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "passes",
        "workloads": ["tinydb.sq8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
        "from portbench.lib import harness;"
        "assert str(harness.ROOT) == sys.argv[1], harness.ROOT;"
        "r = [harness.run_cell('tinydb.sq8', 3, 0.5, t, 'cpu')"
        " for t in (False, True)];"
        "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"], (plain, traced)
    assert set(plain["metrics"]) == {"passes", "setup_s"}
    assert set(traced["metrics"]) == {"passes_traced"}
    assert traced["metrics"]["passes_traced"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before, "no file the benchmark had may change"


def test_committed_metrics_list_committed_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
