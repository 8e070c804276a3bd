"""The port's headline bench (knn_for_homology_tpu_torch/bench.py) on the
CPU at --quick size: one JSON line on stdout with the key set the
repository's bench.py emits (bench.py:256-288), recalls in (0.9, 1]."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from knn_for_homology_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]
CONFIG_KEYS = {"db_tile", "query_block", "r_slots", "storage", "dtype",
               "recall_target", "reps", "timing"}


def _expected_keys(modes, hi=True):
    """bench.py's result keys for `modes` (the first is the headline)."""
    keys = {"metric", "value", "unit", "vs_baseline", "config"}
    for mode in modes:
        keys |= {f"{mode}_qps", f"{mode}_vs_baseline"}
    approx = [m for m in modes if m != "exact"]
    if modes[0] in approx:
        keys.add("recall_vs_exact")
    keys |= {f"{m}_recall" for m in approx if m != modes[0]}
    if hi:
        keys |= {"hi_recall_qps", "hi_recall_vs_baseline", "hi_recall",
                 "hi_recall_target"}
    return keys


def _recalls(result):
    return [v for k, v in result.items()
            if k == "recall_vs_exact" or k.endswith("recall")]


def test_cli_quick_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "knn_for_homology_tpu_torch.bench", "--quick",
         "--device", "cpu", "--reps", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    result = json.loads(lines[0])
    modes = ["sq8-pq", "approx", "exact", "sq8-sym"]
    assert set(result) == _expected_keys(modes)
    assert result["metric"] == "flat_sq8-pq_allvsall_n2048_k100_qps"
    assert result["unit"] == "queries/s" and result["value"] > 0
    assert CONFIG_KEYS <= set(result["config"])
    assert result["config"]["device"] == "cpu"
    assert result["config"]["storage"] == "sq8-sym"
    recalls = _recalls(result)
    assert len(recalls) == 4 and all(0.9 < r <= 1.0 for r in recalls)


@pytest.mark.parametrize(
    "argv,modes,hi",
    [
        (["--modes", "exact,sq8", "--hi-recall-target", "0"],
         ["exact", "sq8"], False),
        (["--modes", "approx", "--dtype", "float32"], ["approx"], True),
    ],
)
def test_run_keys_follow_the_modes(argv, modes, hi):
    args = bench.parse_args(["--quick", "--device", "cpu", "--reps", "1"]
                            + argv)
    result = bench.run(args)
    assert set(result) == _expected_keys(modes, hi)
    assert result["config"]["r_slots"] >= 1
    assert all(0.9 < r <= 1.0 for r in _recalls(result))


def test_unknown_mode_is_rejected():
    with pytest.raises(SystemExit):
        bench.parse_args(["--modes", "approx,ivf"])
