"""LSH index — the FAISS IndexLSH replacement (port of
knn_for_homology_tpu/search/lsh.py).

Usage parity with the reference's index builds
(reference: seqvec_search/create_index.py:33-47 — 1024 bits default;
pfam/proteins_search.py:26-27 — 2048 bits; k=1000 queries
pfam/search.py:37). Scores returned are Hamming distances (ascending),
matching FAISS's convention.

The sketches stay on the index's device as int8 ±1 [N, nbits] (128 MiB at
131072 rows × 1024 bits). `state()` / `from_state()` keep the JAX package's
.npz layout (kind, dim, nbits, seed, packed_signs), so an index written by
either package loads in the other.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.lsh import (
    compute_signs,
    hamming_topk,
    pack_signs,
    projection_matrix,
    unpack_signs,
)

# rows sketched per upload: 16384 x 1024 fp32 is 64 MiB
ADD_ROWS = 16384


class LSHIndex:
    def __init__(
        self, dim: int, nbits: int = 1024, seed: int = 1234, device="cuda"
    ):
        self.dim = dim
        self.nbits = nbits
        self.seed = seed
        self.device = resolve_device(device)
        self.projection = projection_matrix(dim, nbits, seed)
        self._projection = torch.from_numpy(self.projection).to(self.device)
        self._signs: Optional[torch.Tensor] = None  # int8 ±1 [N, nbits]

    @property
    def ntotal(self) -> int:
        return 0 if self._signs is None else self._signs.shape[0]

    def signs_of(self, vectors: np.ndarray) -> torch.Tensor:
        """int8 ±1 sketches [N, nbits] of host rows, on the index's device."""
        vectors = np.asarray(vectors, dtype=np.float32)
        parts = [
            compute_signs(
                torch.from_numpy(vectors[start : start + ADD_ROWS]).to(
                    self.device
                ),
                self._projection,
            )
            for start in range(0, vectors.shape[0], ADD_ROWS)
        ]
        if not parts:
            return torch.zeros(
                (0, self.nbits), dtype=torch.int8, device=self.device
            )
        return torch.cat(parts, dim=0)

    def add(self, vectors: np.ndarray) -> "LSHIndex":
        signs = self.signs_of(vectors)
        self._signs = (
            signs
            if self._signs is None
            else torch.cat([self._signs, signs], dim=0)
        )
        return self

    def search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (hamming distances [Q, k] ascending, ids [Q, k])."""
        if self._signs is None:
            raise ValueError("index is empty; call add() first")
        dist, ids = hamming_topk(self._signs, self.signs_of(queries), k)
        return dist.cpu().numpy(), ids.cpu().numpy()

    # --- persistence payload (see search/io.py) ---
    def state(self) -> dict:
        return {
            "kind": "lsh",
            "dim": self.dim,
            "nbits": self.nbits,
            "seed": self.seed,
            "packed_signs": pack_signs(self._signs.cpu().numpy())
            if self._signs is not None
            else np.zeros((0, self.nbits // 8), dtype=np.uint8),
        }

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "LSHIndex":
        index = cls(
            int(state["dim"]), int(state["nbits"]), int(state["seed"]),
            device=device,
        )
        packed = state["packed_signs"]
        if packed.shape[0]:
            index._signs = torch.from_numpy(
                unpack_signs(packed, index.nbits)
            ).to(index.device)
        return index
