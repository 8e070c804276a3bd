"""The PyTorch port must import neither jax nor anything of the JAX package
(knn_for_homology_tpu), directly or through anything it imports, and must
not touch CUDA or build kernels at import time (the CPU tests import every
module). The same holds for chip_smoke.py, which runs on a machine without
jax. Runs in a clean subprocess because this test process has imported jax
long ago."""

import ast
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
from knn_for_homology_tpu_torch.interop import native
assert not native._TRIED, "a module built the native I/O library at import"
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
print("OK", len({modules!r}))
"""


def test_port_modules_are_all_listed():
    assert "knn_for_homology_tpu_torch.pipelines.benchmark" in MODULES
    assert "knn_for_homology_tpu_torch.ops.align_cuda" in MODULES
    for name in ("ops.ivf_cuda", "ops.slab_cuda", "search.ivf",
                 "pipelines.pfam_proteins", "data.pfam", "eval.analysis",
                 "eval.render", "utils.io", "ops.lsh", "search.lsh",
                 "search.cli", "data.fixtures", "data.cath", "data.scop",
                 "data.slices", "data.builders", "eval.overlap",
                 "utils.artifacts", "pipelines.pfam_domains",
                 "pipelines.cath", "pipelines.harness",
                 "pipelines.slices_pipeline", "pipelines.reverse",
                 "pipelines.layer_mix", "__main__", "search.graph",
                 "pipelines.reproduce", "utils.threefry", "models.elmo",
                 "models.bert", "models.xlnet", "models.unirep",
                 "models.plus_rnn", "models.cpcprot", "models.module",
                 "parallel.__init__", "parallel.mesh", "parallel.sharded",
                 "parallel.scale", "parallel.encoder_sharding", "entry",
                 "interop.native.__init__"):
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


# the benchmark runs the port on the same machine: its files import neither
# jax nor the JAX package, and its plain references nothing of the port
BENCH_FILES = sorted(
    p.relative_to(ROOT).as_posix()
    for part in ("drivers", "lib", "metrics", "reference")
    for p in (ROOT / "portbench" / part).glob("*.py"))


@pytest.mark.parametrize("path", BENCH_FILES)
def test_benchmark_imports_neither_jax_nor_the_jax_package(path):
    text = (ROOT / path).read_text()
    for pattern in IMPORTS:
        assert not re.search(pattern, text, flags=re.MULTILINE), pattern
    if "/reference/" in path:
        assert not re.search(r"^\s*(import|from)\s+knn_for_homology_tpu_torch",
                             text, flags=re.MULTILINE)
        assert "knn_for_homology_tpu_torch" not in text


def test_benchmark_files_listed():
    assert "portbench/reference/xlnet.py" in BENCH_FILES
    assert "portbench/drivers/embed_xlnet.py" in BENCH_FILES
    assert "portbench/drivers/graph_online.py" in BENCH_FILES


def _imported_modules(path: Path):
    """Absolute names of the modules a file imports, relative imports
    resolved against its package."""
    package = ".".join(path.relative_to(PORT.parent).parent.parts)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            if node.level:
                base = base[:len(base) - node.level + 1]
            else:
                base = []
            name = ".".join(base + ([node.module] if node.module else []))
            yield name
            yield from (f"{name}.{alias.name}" for alias in node.names)


def test_ops_import_no_models():
    """The kernels and their plain versions (ops/) sit below the models
    that call them: no module under ops/ imports models/."""
    models = "knn_for_homology_tpu_torch.models"
    ops = sorted((PORT / "ops").glob("*.py"))
    assert len(ops) >= 15
    hits = [(p.name, name) for p in ops for name in _imported_modules(p)
            if name == models or name.startswith(models + ".")]
    assert not hits, hits
    # the walk resolves what the models import from ops/
    assert "knn_for_homology_tpu_torch.ops.short_cuda" in set(
        _imported_modules(PORT / "models" / "t5.py"))
