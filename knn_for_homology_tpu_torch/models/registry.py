"""Embedder registry (port of knn_for_homology_tpu/models/registry.py,
the ProtT5 and AA-composition embedders).

Uniform interface, as in the reference's embedder-by-name registry
(reference: cath/embed.py:34-46):

  embed_per_residue(sequences) → iterator of [L_i, d] arrays
  embed_pooled(sequences)      → [N, d] mean-pooled vectors
  reduce_per_protein(emb)      → mean over residues

The other ten encoders of the JAX package are not ported yet (ROADMAP).
"""

from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_TOKEN_BATCH, MAX_SEQ_LEN
from ..device import resolve_device
from . import t5
from .batching import Batch, make_batches, pad_tokens
from .pooling import l2_then_mean_pool, mean_pool


class EmbedderBase:
    name: str = "base"
    dim: int = 0

    def embed_per_residue(
        self, sequences: Sequence[str]
    ) -> Iterator[np.ndarray]:
        raise NotImplementedError

    @staticmethod
    def reduce_per_protein(per_residue: np.ndarray) -> np.ndarray:
        """Mean over the residue axis (reference: cath/embed.py:91-94)."""
        return np.asarray(per_residue, dtype=np.float32).mean(axis=0)

    def embed_pooled(self, sequences: Sequence[str]) -> np.ndarray:
        if not sequences:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack(
            [self.reduce_per_protein(e) for e in self.embed_per_residue(sequences)]
        )


class ProtT5Embedder(EmbedderBase):
    """ProtT5 encoder with token-budget batching + optional L2 pooling
    variant (reference: pfam/embed_t5_fp16.py, pfam/embed_t5_l2.py:69-71),
    on `device` (the card unless the caller passes "cpu")."""

    name = "ProtT5 XL U50"
    dim = 1024

    def __init__(
        self,
        checkpoint: Optional[Path] = None,
        config: Optional[t5.T5Config] = None,
        params: Optional[t5.Params] = None,
        token_budget: int = DEFAULT_TOKEN_BATCH,
        max_len: int = MAX_SEQ_LEN,
        l2_per_residue: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.vocab = None  # default = published prot_t5 layout
        if params is not None:
            config = config or t5.PROTT5_XL
        elif checkpoint is not None:
            from .convert import load_t5_checkpoint

            config, params, self.vocab = load_t5_checkpoint(
                checkpoint, self.device
            )
        else:
            raise ValueError(
                f"{self.name}: no checkpoint installed — pass `checkpoint=` "
                "(a converted .npz) or explicit params"
            )
        self.config = config
        self.encoder = t5.T5Encoder(config, params).to(self.device)
        self.dim = config.d_model
        self.token_budget = token_budget
        self.max_len = max_len
        self.l2_per_residue = l2_per_residue

    def _tokens(self, batch: Batch):
        """(ids, mask, residue mask) on the device; the residue mask drops
        EOS, so pooling averages residues only."""
        tokens = [t5.tokenize(s, self.vocab) for s in batch.sequences]
        ids, mask = pad_tokens(tokens, batch.padded_len, t5.PAD_ID)
        res_mask = mask.copy()
        for row, seq in enumerate(batch.sequences):
            res_mask[row, len(seq) :] = False
        return tuple(
            torch.from_numpy(a).to(self.device) for a in (ids, mask, res_mask)
        )

    def _run_batch(self, batch: Batch) -> List[np.ndarray]:
        ids, mask, _ = self._tokens(batch)
        hidden = self.encoder(ids, mask).float().cpu().numpy()
        return [hidden[row, : len(seq)] for row, seq in enumerate(batch.sequences)]

    def pooled_batch(self, batch: Batch) -> torch.Tensor:
        """[rows, d] fp32 pooled vectors of one batch, on the device."""
        ids, mask, res_mask = self._tokens(batch)
        pool = l2_then_mean_pool if self.l2_per_residue else mean_pool
        return pool(self.encoder(ids, mask), res_mask)

    def embed_per_residue(self, sequences):
        results: List[Optional[np.ndarray]] = [None] * len(sequences)
        for batch in make_batches(sequences, self.token_budget, self.max_len):
            for idx, out in zip(batch.indices, self._run_batch(batch)):
                results[idx] = out
        yield from results

    def embed_pooled(self, sequences: Sequence[str]) -> np.ndarray:
        """Pooled on the device (masked mean; the L2 variant normalises
        first), returned in input order."""
        if not sequences:
            return np.zeros((0, self.dim), dtype=np.float32)
        results: List[Optional[np.ndarray]] = [None] * len(sequences)
        for batch in make_batches(sequences, self.token_budget, self.max_len):
            pooled = self.pooled_batch(batch).cpu().numpy()
            for idx, row in zip(batch.indices, pooled):
                results[idx] = row
        return np.stack(results)


class AACompositionEmbedder(EmbedderBase):
    """Amino-acid-composition baseline (reference: cath/embed_all.py:23-44).

    The fixed 25-letter extended alphabet keeps train and test (embedded in
    separate CLI invocations) in one vector space. Unknown characters map
    to 'X'.
    """

    name = "AA Composition"
    DEFAULT_ALPHABET = "ABCDEFGHIKLMNOPQRSTUVWXYZ"  # sorted, stable

    def __init__(self, alphabet: Optional[str] = None):
        self.alphabet = alphabet or self.DEFAULT_ALPHABET
        self.dim = len(self.alphabet)

    def _table(self):
        table = {aa: i for i, aa in enumerate(self.alphabet)}
        fallback = table.get("X", 0)
        return table, fallback

    def embed_pooled(self, sequences: Sequence[str]) -> np.ndarray:
        table, fallback = self._table()
        out = np.zeros((len(sequences), len(self.alphabet)), dtype=np.float32)
        for row, seq in enumerate(sequences):
            for aa in seq.upper():
                out[row, table.get(aa, fallback)] += 1.0
            out[row] /= max(len(seq), 1)
        return out

    def embed_per_residue(self, sequences):
        table, fallback = self._table()
        eye = np.eye(len(self.alphabet), dtype=np.float32)
        for seq in sequences:
            yield np.stack([eye[table.get(aa, fallback)] for aa in seq.upper()])


# name → constructor (reference: cath/embed.py:34-46, cath/embed_all.py:23-44)
EMBEDDERS = {
    "ProtT5 XL U50": ProtT5Embedder,
    "AA Composition": AACompositionEmbedder,
}


def get_embedder(name: str, **kwargs) -> EmbedderBase:
    if name not in EMBEDDERS:
        raise KeyError(
            f"unknown embedder {name!r}; available: {sorted(EMBEDDERS)}"
        )
    return EMBEDDERS[name](**kwargs)
