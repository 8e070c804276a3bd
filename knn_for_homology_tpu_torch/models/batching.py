"""Length-sorted token-budget batching with static shapes.

Reference semantics (pfam/embed_t5_fp16.py:29-50): cut sequences to 3096
residues, sort by length descending, batch by a residue budget, embed, then
un-sort. On TPU we additionally bucket the padded length (round up to a
multiple of 128) so XLA compiles one program per bucket instead of one per
batch.
"""

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_TOKEN_BATCH, MAX_SEQ_LEN


def round_up(x: int, multiple: int = 128) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass
class Batch:
    indices: List[int]  # positions in the original sequence list
    sequences: List[str]
    padded_len: int  # bucketed static length (incl. room for EOS)


def cut_sequences(
    sequences: Sequence[str], max_len: int = MAX_SEQ_LEN
) -> List[str]:
    """Hard truncation, as the reference applies before embedding
    (reference: pfam/embed_t5_fp16.py:29-35)."""
    return [s[:max_len] for s in sequences]


def make_batches(
    sequences: Sequence[str],
    token_budget: int = DEFAULT_TOKEN_BATCH,
    max_len: int = MAX_SEQ_LEN,
    bucket: int = 128,
) -> List[Batch]:
    """Greedy descending-length batches under `batch_rows × padded_len ≤
    token_budget` (padded cost is what the device actually pays)."""
    cut = cut_sequences(sequences, max_len)
    order = np.argsort([-len(s) for s in cut], kind="stable")
    batches: List[Batch] = []
    current: List[int] = []
    current_pad = 0
    for idx in order:
        idx = int(idx)
        pad = round_up(len(cut[idx]) + 1, bucket)  # +1 for EOS
        new_pad = max(current_pad, pad)
        if current and (len(current) + 1) * new_pad > token_budget:
            batches.append(
                Batch(current, [cut[i] for i in current], current_pad)
            )
            current, current_pad = [], 0
            new_pad = pad
        current.append(idx)
        current_pad = new_pad
    if current:
        batches.append(Batch(current, [cut[i] for i in current], current_pad))
    return batches


def pad_tokens(
    token_lists: List[np.ndarray], padded_len: int, pad_id: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (ids [B, padded_len] int32, mask [B, padded_len] bool)."""
    b = len(token_lists)
    ids = np.full((b, padded_len), pad_id, dtype=np.int32)
    mask = np.zeros((b, padded_len), dtype=bool)
    for row, toks in enumerate(token_lists):
        ids[row, : len(toks)] = toks
        mask[row, : len(toks)] = True
    return ids, mask


def unsort(arrays: List[np.ndarray], indices: List[int], total: int) -> List:
    """Restore original order from batched results
    (reference: pfam/embed_t5_fp16.py:49 un-sorting)."""
    out: List = [None] * total
    for idx, arr in zip(indices, arrays):
        out[idx] = arr
    return out


def embed_in_batches(
    sequences: Sequence[str],
    embed_batch: Callable[[Batch], List[np.ndarray]],
    token_budget: int = DEFAULT_TOKEN_BATCH,
    max_len: int = MAX_SEQ_LEN,
) -> List[np.ndarray]:
    """Run `embed_batch` over token-budget batches; results in input order."""
    batches = make_batches(sequences, token_budget, max_len)
    results: List[np.ndarray] = [None] * len(sequences)
    for batch in batches:
        outs = embed_batch(batch)
        for idx, out in zip(batch.indices, outs):
            results[idx] = out
    return results
