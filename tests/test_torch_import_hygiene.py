"""The PyTorch port must import neither jax nor anything of the JAX package
(knn_for_homology_tpu), directly or through anything it imports, and must
not touch CUDA or build kernels at import time (the CPU tests import every
module). The same holds for chip_smoke.py, which runs on a machine without
jax. Runs in a clean subprocess because this test process has imported jax
long ago."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "knn_for_homology_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
MODULES = sorted(
    ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
    for p in PORT.rglob("*.py")
)

CHECK = """
import sys
import torch
for name in {modules!r} + ["chip_smoke"]:
    __import__(name)
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "knn_for_homology_tpu")
)
assert not leaked, leaked
assert not torch.cuda.is_initialized(), "a module initialised CUDA at import"
from knn_for_homology_tpu_torch.ops import _build
assert not _build._LIB, "a module loaded the kernel library at import"
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
print("OK", len({modules!r}))
"""


def test_port_modules_are_all_listed():
    assert "knn_for_homology_tpu_torch.pipelines.benchmark" in MODULES
    assert "knn_for_homology_tpu_torch.ops.align_cuda" in MODULES
    for name in ("ops.ivf_cuda", "ops.slab_cuda", "search.ivf",
                 "pipelines.pfam_proteins", "data.pfam", "eval.analysis",
                 "eval.render", "utils.io"):
        assert f"knn_for_homology_tpu_torch.{name}" in MODULES, name
    assert len(MODULES) >= 15


def test_port_imports_no_jax_and_no_cuda():
    out = subprocess.run(
        [sys.executable, "-c", CHECK.format(modules=MODULES)],
        capture_output=True, text=True, timeout=300,
        cwd=PORT.parent,
    )
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


# importing jax or the JAX package: forbidden in the port and in the smoke
IMPORTS = [
    r"^\s*(import|from)\s+jax\b",
    r"^\s*(import|from)\s+knn_for_homology_tpu(\.|\s|$)",
]


@pytest.mark.parametrize(
    "pattern",
    IMPORTS + [
        r"torch\.compile\b",
        r"scaled_dot_product_attention",
        r"cpp_extension\.load\b",
    ],
)
def test_port_source_has_no_forbidden_construct(pattern):
    hits = [
        str(p) for p in PORT.rglob("*.py")
        if re.search(pattern, p.read_text(), flags=re.MULTILINE)
    ]
    assert not hits, hits


# chip_smoke.py may time scaled_dot_product_attention as a yardstick, so
# only the import rules apply to it
@pytest.mark.parametrize("pattern", IMPORTS)
def test_chip_smoke_imports_neither_jax_nor_the_jax_package(pattern):
    assert not re.search(pattern, SMOKE.read_text(), flags=re.MULTILINE)
