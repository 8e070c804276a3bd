"""Benchmark of knn_for_homology_tpu_torch on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints one JSON line (correct, attempted,
failed, metrics, device[, breakdown], checks); exits non-zero with no
result where the cell's cards are missing. See portbench/lib/harness.py.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# caches of anything the run might compile stay inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(
    ROOT / "build" / "portbench" / "torch_extensions")
# a library that could load JAX by itself is told not to
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

from portbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
