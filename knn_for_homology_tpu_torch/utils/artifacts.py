"""Artifact store: file-existence idempotency + content-keyed caching.

The reference's checkpoint/resume story is pervasive write-once-skip-if-
present behaviour (SURVEY.md §5: embeddings, indexes, mmseqs DBs with mtime
checks, cached hit/E-value npy, metadata caches). This module centralises
that pattern and adds deterministic content keys so a cache entry is only
reused when its inputs are unchanged.
"""

import hashlib
import json
import logging
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def content_key(**inputs: Any) -> str:
    """Deterministic hex key from JSON-serialisable inputs; arrays hash by
    bytes + shape/dtype."""
    digest = hashlib.sha256()
    for name in sorted(inputs):
        value = inputs[name]
        digest.update(name.encode())
        if isinstance(value, np.ndarray):
            digest.update(str((value.shape, str(value.dtype))).encode())
            digest.update(np.ascontiguousarray(value).tobytes())
        elif isinstance(value, Path):
            stat = value.stat()
            digest.update(f"{value}:{stat.st_size}:{stat.st_mtime_ns}".encode())
        else:
            digest.update(json.dumps(value, sort_keys=True, default=str).encode())
    return digest.hexdigest()[:16]


def cached_array(
    path: Path,
    compute: Callable[[], np.ndarray],
    key: Optional[str] = None,
) -> np.ndarray:
    """Load `path` if present (and, when `key` given, its recorded content
    key matches); otherwise compute, save, and return. Mirrors the
    reference's cached hit/E-value arrays
    (reference: pfam/proteins_shared.py:33-39)."""
    path = Path(path)
    key_file = path.with_suffix(path.suffix + ".key")
    if path.is_file() and (
        key is None or (key_file.is_file() and key_file.read_text() == key)
    ):
        return np.load(path)
    result = np.asarray(compute())
    path.parent.mkdir(parents=True, exist_ok=True)
    # np.save(str) appends .npy when missing; a file handle keeps the exact
    # name so the existence check above finds it again
    with open(path, "wb") as fp:
        np.save(fp, result)
    if key is not None:
        key_file.write_text(key)
    return result


def cached_json(
    path: Path, compute: Callable[[], Dict], key: Optional[str] = None
) -> Dict:
    path = Path(path)
    if path.is_file():
        data = json.loads(path.read_text())
        if key is None or data.get("__key__") == key:
            data.pop("__key__", None)
            return data
    result = dict(compute())
    path.parent.mkdir(parents=True, exist_ok=True)
    stored = dict(result)
    if key is not None:
        stored["__key__"] = key
    path.write_text(json.dumps(stored))
    return result


def skip_if_exists(path: Path) -> bool:
    """The reference's plain existence check (e.g. cath/embed_all.py:54-56)."""
    exists = Path(path).is_file()
    if exists:
        logger.info("%s already done, skipping", path)
    return exists
