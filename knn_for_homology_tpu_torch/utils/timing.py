"""Wall-clock tracing with the reference's sidecar-file contract.

The reference persists phase timings as sidecar ``*.time.txt`` files next to
the artifacts they describe, and later consumes them as data for figures
(reference: seqvec_search/main.py:43-49, cath/search.py:42-50,
pfam/embed_t5_fp16.py:41-51, seqvec_search/figures/mmseqs_benchmark.py:35-37).
We keep that contract.
"""

import logging
import time
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)


class Timer:
    """Context manager measuring wall time; optionally writes a sidecar file."""

    def __init__(self, name: str = "", sidecar: Optional[Path] = None):
        self.name = name
        self.sidecar = sidecar
        self.seconds: float = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.time()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.time() - self._start
        if self.name:
            logger.info("%s took %fs", self.name, self.seconds)
        if self.sidecar is not None:
            write_time_sidecar(self.sidecar, self.seconds)


def write_time_sidecar(path: Path, seconds: float) -> None:
    """Sidecar format: the bare float, as the reference writes it
    (reference: cath/search.py:49-50)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(str(seconds))

