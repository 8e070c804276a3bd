"""Every cell runs end to end on the CPU at tiny sizes (the program's plain
versions): one result line with the keys the contract names, correct; and
the run leaves no JAX module loaded."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from portbench.lib import harness
from portbench.tests.tiny import BENCH, OVERRIDES

CELLS = sorted(OVERRIDES)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_prints_one_result_line(cell, traced, capsys):
    result = harness.run_cell(cell, 2**33 + 5, 0.5, traced, "cpu",
                              overrides=OVERRIDES[cell], bench=BENCH)
    out = io.StringIO()
    with redirect_stdout(out):
        harness.print_result(result)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown", "setup_phases", "checks"}
    phases = list(line["setup_phases"].values())
    assert phases == sorted(phases) and phases[-1] > 0
    assert line["correct"] is True, line
    assert line["attempted"] > 0 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-len(line["checks"]):] == [
        f"check {k} = {c['value']} (limit {c['limit']})"
        for k, c in line["checks"].items()]


def test_same_seed_same_inputs():
    a = harness.run_cell("pfam20.allvsall_sq8", 77, 0.2, False, "cpu",
                         overrides=OVERRIDES["pfam20.allvsall_sq8"])
    b = harness.run_cell("pfam20.allvsall_sq8", 77, 0.2, False, "cpu",
                         overrides=OVERRIDES["pfam20.allvsall_sq8"])
    assert a["checks"] == b["checks"]


def test_no_card_no_result():
    """run.py exits non-zero and prints nothing on stdout without a card."""
    out = subprocess.run(
        [sys.executable, str(harness.ROOT / "portbench" / "run.py"),
         "--workload", "pfam20.allvsall_sq8", "--seed", "1", "--seconds",
         "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(harness.ROOT / "build")})
    assert out.returncode != 0 and out.stdout == ""


def test_run_loads_no_jax():
    """A dry run in a fresh process leaves no module named jax, jaxlib,
    flax or knn_for_homology_tpu (whole top-level names) loaded."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from portbench.lib import harness;"
        "from portbench.tests.tiny import BENCH, OVERRIDES;"
        "harness.run_cell('prott5xl.mix', 1, 0.2, False, 'cpu',"
        " overrides=OVERRIDES['prott5xl.mix']);"
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "knn_for_homology_tpu_torch_x", sys)
    assert "knn_for_homology_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
