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

Copies, chosen by the query count: a search of one block (`_block_rows`)
copies its queries up and its results down in one synchronous copy each; a
larger one runs block by block, and on a CUDA device stages each block
through one of two page-locked buffers and copies it up on a side stream
while the card searches the block before, and copies each block's results
down on that stream into page-locked arrays of the call's own.
"""

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_HITS, SearchConfig
from ..device import resolve_device
from ..ops.distance import METRICS, finalize_scores, l2_normalize
from ..ops.packed_cuda import packed_plan, quantize_database
from ..ops.topk import APPROX_EXACT_K, QUERY_BLOCK, flat_topk, plain_topk
from ..utils.trace import span

BACKENDS = ("auto", "plain", "approx", "sq8")

# host<->card bytes (queries up, results down) a block of a blocked search
# aims at: few launches a block, and a short first copy up and last copy
# down, the two that no search kernel hides
BLOCK_BYTES = 256 << 20


class FlatIndex:
    """Brute-force index over device-resident fp32 vectors."""

    # search calls by copy route (module docstring), as the kernels count
    # their launches
    copy_routes = {"pipelined": 0, "direct": 0}

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
        return self._prepare(x)

    def _prepare(self, x: torch.Tensor) -> torch.Tensor:
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

    def _block_rows(self, k: int) -> int:
        """Queries a block of a blocked search: a whole multiple of the
        route's own query block (packed_topk's for the packed route, else
        plain_topk's), so each block launches the kernels the whole call
        would, as near BLOCK_BYTES of copies as that allows."""
        if self.backend == "sq8" or (
            self.backend == "approx" and k > APPROX_EXACT_K
        ):
            inner = packed_plan(self.ntotal, min(k, self.ntotal),
                                recall_target=self.config.recall_target)[2]
        else:
            inner = QUERY_BLOCK
        return inner * max(1, BLOCK_BYTES // (inner * (4 * self.dim + 8 * k)))

    def search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores [Q, k], ids [Q, k]) in the FAISS convention:
        cosine/ip descending inner products; l2 ascending squared
        distances; missing hits are id -1.

        The arrays are this call's own. Where the search spans several
        blocks on a CUDA device, their memory is page-locked and stays so
        until the caller drops them: a caller that keeps many large
        results keeps that much pinned host memory."""
        if self._db is None:
            raise ValueError("index is empty; call add() first")
        queries = np.asarray(queries)
        block = self._block_rows(k)
        with span("flat.search"):
            if len(queries) <= block:
                FlatIndex.copy_routes["direct"] += 1
                return self._search_prepared(self._to_device(queries), k)
            FlatIndex.copy_routes["pipelined"] += 1
            side = self._side_stream()
            with span("flat.h2d") as sp:
                if sp:
                    sp.count(bytes=queries.nbytes)
                results = self._search_blocks(
                    self._upload(queries, block, side), k, side)
            return self._download(results, side)

    def _search_block(self, q: torch.Tensor, k: int):
        sims, ids = self._topk(q, k)
        return finalize_scores(sims, self.metric), ids

    def _search_prepared(self, q: torch.Tensor, k: int):
        scores, ids = self._search_block(q, k)
        with span("flat.d2h") as sp:
            out = scores.cpu().numpy(), ids.cpu().numpy()
            if sp:
                sp.count(bytes=out[0].nbytes + out[1].nbytes)
        return out

    def _side_stream(self) -> Optional[torch.cuda.Stream]:
        """The stream a blocked search copies on, None off a CUDA device."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.Stream(self.device)

    def _upload(self, queries: np.ndarray, block: int, side):
        """Yields the queries on the device a block at a time, ready to
        search. With a side stream each block is staged into one of two
        page-locked buffers, copied up on that stream, and the current
        stream waits for the copy, so the host stages block i + 1 while the
        card searches block i; the generator ends once the last copy is
        done."""
        starts = range(0, len(queries), block)
        if side is None:
            for s in starts:
                host = torch.as_tensor(queries[s : s + block])
                yield self._prepare(host.to(self.device, torch.float32))
            return
        compute = torch.cuda.current_stream(self.device)
        staging = [
            torch.empty((block, queries.shape[1]), dtype=torch.float32,
                        pin_memory=True)
            for _ in range(2)
        ]
        copied = []
        for i, s in enumerate(starts):
            host = torch.as_tensor(queries[s : s + block])
            if i >= 2:
                copied[i - 2].synchronize()  # the buffer's last copy is done
            buf = staging[i % 2][: len(host)]
            buf.copy_(host)
            with torch.cuda.stream(side):
                q = buf.to(self.device, non_blocking=True)
                copied.append(side.record_event())
            compute.wait_event(copied[-1])
            q.record_stream(compute)  # allocated on the side stream
            yield self._prepare(q)
        copied[-1].synchronize()

    def _search_blocks(self, blocks, k: int, side) -> list:
        """(scores, ids, done) of each query block: the block's results on
        the device and, with a side stream, an event on the current stream
        after them."""
        results = []
        for q in blocks:
            scores, ids = self._search_block(q, k)
            done = None
            if side is not None:
                done = torch.cuda.current_stream(self.device).record_event()
            results.append((scores, ids, done))
        return results

    def _download(self, results: list, side):
        """The blocks' results in one (scores, ids) pair of host arrays,
        allocated for this call: page-locked, each block copied on the
        side stream once its event has passed, where there is one."""
        rows = sum(len(scores) for scores, _, _ in results)
        with span("flat.d2h") as sp:
            out = [
                torch.empty((rows,) + x.shape[1:], dtype=x.dtype,
                            pin_memory=side is not None)
                for x in results[0][:2]
            ]
            start = 0
            for scores, ids, done in results:
                at = slice(start, start + len(scores))
                start += len(scores)
                if side is None:
                    out[0][at], out[1][at] = scores, ids
                    continue
                side.wait_event(done)
                with torch.cuda.stream(side):
                    out[0][at].copy_(scores, non_blocking=True)
                    out[1][at].copy_(ids, non_blocking=True)
            if side is not None:
                side.synchronize()
            if sp:
                sp.count(bytes=out[0].nbytes + out[1].nbytes)
        return out[0].numpy(), out[1].numpy()

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
        q, block = q.contiguous(), self._block_rows(k + 1)
        if len(q) <= block:
            FlatIndex.copy_routes["direct"] += 1
            scores, ids = self._search_prepared(q, k + 1)
        else:
            FlatIndex.copy_routes["pipelined"] += 1
            side = self._side_stream()
            blocks = (q[s : s + block] for s in range(0, len(q), block))
            scores, ids = self._download(
                self._search_blocks(blocks, k + 1, side), side)
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
