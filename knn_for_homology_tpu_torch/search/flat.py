"""Exact flat index (port of knn_for_homology_tpu/search/flat.py).

API mirrors the search semantics the reference drives through FAISS:
  * ``knn_search`` ↔ ``faiss_search`` (reference: seqvec_search/main.py:22-50);
  * ``FlatIndex.search_self`` ↔ all-vs-all with self-hit stripping
    (reference: cath/search.py:13-26): ask k+1, drop the first column;
  * fp16/bf16 inputs are cast to fp32 before search.

Backends, all routed by ops/topk.py:flat_topk (the kernels on a CUDA
device, their plain versions on the CPU):
  * "auto"   — exact: kernel A for k ≤ 32, kernel B for k > 32;
  * "plain"  — exact, the plain PyTorch top-k on either device;
  * "approx" — flat_topk(approx=True) at config.recall_target: kernel D
               for k > 32, the exact kernel A for k ≤ 32;
  * "sq8"    — packed segment-top-R over int8 storage + per-row scales
               (kernel F for cosine / ip, E for l2), quantised once and
               cached until the next add().
"""

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_HITS, SearchConfig
from ..device import resolve_device
from ..ops.distance import METRICS, finalize_scores, l2_normalize
from ..ops.packed_cuda import quantize_database
from ..ops.topk import flat_topk, plain_topk
from ..utils.trace import span

BACKENDS = ("auto", "plain", "approx", "sq8")


class FlatIndex:
    """Brute-force index over device-resident fp32 vectors."""

    def __init__(
        self,
        metric: str = "cosine",
        config: Optional[SearchConfig] = None,
        backend: str = "auto",
        device="cuda",
    ):
        if metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        self.metric = metric
        self.config = config or SearchConfig(metric=metric)
        self.backend = backend
        self.device = resolve_device(device)
        self._db: Optional[torch.Tensor] = None
        self._db_sq8 = None  # quantize-once cache of the sq8 backend

    @property
    def ntotal(self) -> int:
        return 0 if self._db is None else self._db.shape[0]

    @property
    def dim(self) -> Optional[int]:
        return None if self._db is None else self._db.shape[1]

    def _to_device(self, x) -> torch.Tensor:
        x = np.asarray(x)
        with span("flat.h2d") as sp:
            if sp:
                sp.count(bytes=x.nbytes)
            x = torch.as_tensor(x).to(self.device, torch.float32)
        if self.metric == "cosine":
            x = l2_normalize(x)
        return x.contiguous()

    def add(self, vectors: np.ndarray) -> "FlatIndex":
        """Install database vectors (cast to fp32; cosine: normalised once
        here, not per query)."""
        v = self._to_device(vectors)
        self._db = v if self._db is None else torch.cat([self._db, v], 0)
        self._db_sq8 = None  # vectors changed: invalidate the sq8 cache
        return self

    def _topk(self, q: torch.Tensor, k: int):
        if self.backend == "plain":
            return plain_topk(
                self._db, q, k, metric=self.metric,
                db_tile=self.config.db_tile,
            )
        db, metric = self._db, self.metric
        if self.backend == "sq8":
            if self._db_sq8 is None:
                self._db_sq8 = quantize_database(self._db)
            # stored rows are normalised for cosine: ip ranks them alike
            db = self._db_sq8
            metric = "ip" if metric == "cosine" else metric
        return flat_topk(
            db, q, k, metric=metric, approx=self.backend != "auto",
            recall_target=self.config.recall_target,
            db_tile=self.config.db_tile,
        )

    def search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores [Q, k], ids [Q, k]) in the FAISS convention:
        cosine/ip descending inner products; l2 ascending squared
        distances; missing hits are id -1."""
        if self._db is None:
            raise ValueError("index is empty; call add() first")
        with span("flat.search"):
            return self._search_prepared(self._to_device(queries), k)

    def _search_prepared(self, q: torch.Tensor, k: int):
        sims, ids = self._topk(q, k)
        scores = finalize_scores(sims, self.metric)
        with span("flat.d2h") as sp:
            out = scores.cpu().numpy(), ids.cpu().numpy()
            if sp:
                sp.count(bytes=out[0].nbytes + out[1].nbytes)
        return out

    # --- persistence payload (see search/io.py) ---
    def state(self) -> dict:
        return {
            "kind": "flat",
            "metric": self.metric,
            "vectors": self._db.cpu().numpy()
            if self._db is not None
            else np.zeros((0, 0), dtype=np.float32),
        }

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "FlatIndex":
        index = cls(metric=str(state["metric"]), device=device)
        vectors = state["vectors"]
        if vectors.size:
            # stored vectors are already normalised for cosine; install raw
            index._db = torch.as_tensor(
                np.asarray(vectors, dtype=np.float32)
            ).to(index.device).contiguous()
        return index

    def search_self(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """All-vs-all with self-hit stripping: ask k+1, drop column 0
        (reference: cath/search.py:13-26). Returns (ids, scores) — the
        reference's order for this call."""
        q = l2_normalize(self._db) if self.metric == "cosine" else self._db
        scores, ids = self._search_prepared(q.contiguous(), k + 1)
        return ids[:, 1:], scores[:, 1:]


def knn_search(
    haystack,
    queries: np.ndarray,
    hits: int = DEFAULT_HITS,
    metric: str = "cosine",
    backend: str = "auto",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Analogue of the reference's ``faiss_search``
    (reference: seqvec_search/main.py:22-50): returns (ids, scores,
    seconds). ``haystack`` is a raw [N, d] array or a built index with a
    ``search`` method."""
    start = time.time()
    if hasattr(haystack, "search"):
        index = haystack
    else:
        index = FlatIndex(metric=metric, backend=backend, device=device)
        index.add(haystack)
    scores, ids = index.search(np.asarray(queries), hits)
    return ids, scores, time.time() - start
