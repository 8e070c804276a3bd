"""On the card, at each cell's own sizes: a short run is correct, and the
control (the reference one precision step down, on three seeds) fails the
cell's limits. Run there with

    python -m pytest -p no:cacheprovider -q -m cuda portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest

from portbench.lib import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_its_control_is_not(cell, card):
    seeds = "1000003,1000033,1000037"
    out = subprocess.run(
        [sys.executable, str(harness.ROOT / "portbench" / "calibrate.py"),
         "--workload", cell, "--seconds", "3", "--seeds", seeds,
         "--control-seeds", seeds],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(s) for s in out.stdout.strip().splitlines()]
    limits = json.loads((harness.ROOT / "portbench" / "cells"
                         / f"{cell}.json").read_text())["limits"]
    for line in lines[:-1]:
        assert line["correct"], line
        assert any(not float(v) <= limits[k]
                   for k, v in line["control"].items()), line
