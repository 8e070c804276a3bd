"""The PyTorch port must import no jax, directly or through anything it
imports, and must not touch CUDA or build kernels at import time (the CPU
tests import every module). Runs in a clean subprocess because this test
process has imported jax long ago."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "knn_for_homology_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
    for p in PORT.rglob("*.py")
)

CHECK = """
import sys
import torch
for name in {modules!r}:
    __import__(name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
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
    assert len(MODULES) >= 15


def test_port_imports_no_jax_and_no_cuda():
    out = subprocess.run(
        [sys.executable, "-c", CHECK.format(modules=MODULES)],
        capture_output=True, text=True, timeout=300,
        cwd=PORT.parent,
    )
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


@pytest.mark.parametrize(
    "pattern",
    [
        r"^\s*(import|from)\s+jax\b",
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
