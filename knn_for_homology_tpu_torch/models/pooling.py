"""Per-protein / per-domain pooling of per-residue embeddings (port of
knn_for_homology_tpu/models/pooling.py).

Reference semantics:
  * mean over the residue axis = reduce_per_protein
    (reference: cath/embed.py:91-94, pfam/embed_t5_fp16.py:47)
  * per-residue L2-normalisation *before* pooling — the "L2" ProtT5 variant
    (reference: pfam/embed_t5_l2.py:69-71)
  * per-domain pooling of a slice [start-1:stop] of the residue axis
    (reference: pfam/embed_pfam_seqvec.py:29-40; 1-based inclusive ranges)
"""

from typing import Sequence, Tuple

import numpy as np
import torch


def mean_pool(per_residue: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, d], mask [B, L] → [B, d] fp32 mean over real residues (fp32
    sums, count clamped at 1)."""
    m = mask.float()[..., None]
    total = torch.sum(per_residue.float() * m, dim=1)
    count = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return total / count


def l2_then_mean_pool(per_residue: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L2-normalise each residue vector, then mean-pool (the L2 variant)."""
    x = per_residue.float()
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    x = x / torch.where(norm > 0, norm, torch.ones_like(norm))
    return mean_pool(x, mask)


def pool_domain_range(
    per_residue: np.ndarray, start: int, stop: int
) -> np.ndarray:
    """Mean over the 1-based inclusive residue range [start, stop]
    (reference: pfam/embed_pfam_seqvec.py:29-40 uses embedding[start-1:stop])."""
    return np.asarray(per_residue)[start - 1 : stop].mean(axis=0)


def pool_domains(
    per_residue: np.ndarray, ranges: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """[n_domains, d] pooled domain vectors from one protein's residues."""
    return np.stack([pool_domain_range(per_residue, s, e) for s, e in ranges])
