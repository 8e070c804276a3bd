"""LSH binary-sketch ops — random hyperplane signs + Hamming top-k (port of
knn_for_homology_tpu/ops/lsh.py).

Replaces FAISS IndexLSH (reference: seqvec_search/create_index.py:41,
pfam/search.py:27, pfam/proteins_search.py:26-27 — 1024/2048-bit sketches).

The Hamming distance between sign sketches s ∈ {-1,+1} is
(nbits − s_q·s_db)/2, so the search is a ±1 inner product followed by an
exact top-k. This is XLA code in the JAX package, not a Pallas kernel, and
torch ops here:

  * on a CUDA tensor, `hamming_topk` takes `hamming_topk_int`: the product
    as `torch._int_mm` (int8 → int32, exact) over blocks of queries, and one
    `torch.topk` a block over a unique key per entry,
    ((ip + nbits) << id_bits) | (2^id_bits − 1 − id), int32 where it fits,
    so the order is fixed: distance ascending, lower id first on ties — the
    JAX package's `lax.top_k` rule;
  * on a CPU tensor, `hamming_topk_plain`: the ±1 product in fp32 (exact for
    sums up to 2^24; TF32 is off) inside `ops/topk.py:streaming_topk`, whose
    stable merge keeps the same tie order. It runs on the card too, as the
    card route's plain reference; `hamming_topk_int` runs on the CPU too.

Sketches are persisted bit-packed (numpy packbits) and expanded to int8 ±1.
"""

from typing import Tuple

import numpy as np
import torch

from .topk import streaming_topk

# Largest key block [QB, N] of the card route, counted at 8 bytes a key:
# 4 GiB keeps a 131072-row index at 4096 queries a block
KEY_BLOCK_BYTES = 4 << 30
# torch._int_mm on CUDA takes m > 16 and k, n multiples of 8
_INT_MM_MIN_M, _INT_MM_ALIGN = 24, 8


def projection_matrix(dim: int, nbits: int, seed: int = 1234) -> np.ndarray:
    """Random Gaussian hyperplanes [dim, nbits]; fixed seed → reproducible
    index (the reference relies on FAISS's internal fixed RNG the same way)."""
    rng = np.random.RandomState(seed)
    return rng.randn(dim, nbits).astype(np.float32)


def compute_signs(x: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """int8 sign sketch [N, nbits] of the rows of x: an fp32 product on x's
    device, then >= 0 → +1, else −1."""
    proj = x.to(torch.float32) @ projection
    one = torch.ones((), dtype=torch.int8, device=x.device)
    return torch.where(proj >= 0, one, -one)


def pack_signs(signs: np.ndarray) -> np.ndarray:
    """int8 ±1 [N, nbits] → packed uint8 [N, nbits/8] (persistence format)."""
    bits = (np.asarray(signs) > 0).astype(np.uint8)
    return np.packbits(bits, axis=1)


def unpack_signs(packed: np.ndarray, nbits: int) -> np.ndarray:
    bits = np.unpackbits(np.asarray(packed), axis=1)[:, :nbits]
    return (bits.astype(np.int8) * 2 - 1).astype(np.int8)


def _check_signs(db_signs: torch.Tensor, q_signs: torch.Tensor):
    if db_signs.dim() != 2 or q_signs.dim() != 2 or (
        db_signs.shape[1] != q_signs.shape[1]
    ):
        raise ValueError(
            f"need db [N, nbits] and queries [Q, nbits], got"
            f" {tuple(db_signs.shape)} and {tuple(q_signs.shape)}"
        )
    if db_signs.dtype != torch.int8 or q_signs.dtype != torch.int8:
        raise TypeError("sign sketches are int8 ±1")
    if db_signs.device != q_signs.device:
        raise ValueError("db and query sketches must be on one device")


def _pad_hamming(hamming, ids, k):
    """Pad [Q, k'] results to k columns with (+inf, −1)."""
    short = k - hamming.shape[1]
    if short <= 0:
        return hamming, ids
    q = hamming.shape[0]
    return (
        torch.cat([hamming, hamming.new_full((q, short), float("inf"))], 1),
        torch.cat([ids, ids.new_full((q, short), -1)], 1),
    )


def hamming_topk_plain(
    db_signs: torch.Tensor,
    q_signs: torch.Tensor,
    k: int,
    db_tile: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest Hamming distances on either device: the ±1 product in
    fp32 as streaming_topk's similarity, one db tile at a time.

    db_signs [N, nbits] int8 ±1, q_signs [Q, nbits] int8 ±1. Returns
    (hamming [Q, k] float32 ascending, ids [Q, k] int32), (+inf, −1) for
    missing hits — FAISS's convention of returning distances as floats."""
    _check_signs(db_signs, q_signs)
    n, nbits = db_signs.shape
    k_eff = min(k, n)
    ips, ids = streaming_topk(
        db_signs,
        q_signs.to(torch.float32),
        k_eff,
        metric="ip",
        db_tile=db_tile,
        sim_fn=lambda q, tile: q @ tile.to(q.dtype).T,
    )
    return _pad_hamming((nbits - ips) * 0.5, ids, k)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def key_dtype(n: int, nbits: int) -> torch.dtype:
    """The narrowest key of the card route: int32 where the product's
    ip + nbits (0 .. 2·nbits) and an id (0 .. n − 1) fit in its 31 value
    bits (131072 rows at 2048 bits take 30), else int64."""
    bits = (2 * nbits).bit_length() + max(1, (n - 1).bit_length())
    return torch.int32 if bits <= 31 else torch.int64


def hamming_topk_int(
    db_signs: torch.Tensor,
    q_signs: torch.Tensor,
    k: int,
    dtype: torch.dtype = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The card route, on either device: the ±1 product as `torch._int_mm`
    over blocks of queries, then one `torch.topk` a block over unique keys
    ((ip + nbits) << id_bits) | (2^id_bits − 1 − id), of `dtype` (default:
    `key_dtype(N, nbits)`; int32 keys are built in place in the product's
    buffer). Same contract as hamming_topk_plain, bit-equal results."""
    _check_signs(db_signs, q_signs)
    n, nbits = db_signs.shape
    q_n = q_signs.shape[0]
    k_eff = min(k, n)
    dtype = key_dtype(n, nbits) if dtype is None else dtype
    id_bits = max(1, (n - 1).bit_length())
    id_mask = (1 << id_bits) - 1
    # zero columns add nothing to a product, zero rows are cut off below
    nb_pad = _round_up(nbits, _INT_MM_ALIGN) - nbits
    n_pad = _round_up(n, _INT_MM_ALIGN) - n
    db = torch.nn.functional.pad(db_signs, (0, nb_pad, 0, n_pad))
    q = torch.nn.functional.pad(q_signs, (0, nb_pad))
    qb = max(_INT_MM_MIN_M, KEY_BLOCK_BYTES // (8 * max(n, 1)))
    qb = _round_up(min(qb, max(q_n, 1)), _INT_MM_ALIGN)
    low = id_mask - torch.arange(n, dtype=dtype, device=db.device)
    hamming = torch.empty((q_n, k_eff), dtype=torch.float32, device=db.device)
    ids = torch.empty((q_n, k_eff), dtype=torch.int32, device=db.device)
    for start in range(0, q_n, qb):
        block = q[start : start + qb]
        m = block.shape[0]
        rows = max(_INT_MM_MIN_M, _round_up(m, _INT_MM_ALIGN))
        block = torch.nn.functional.pad(block, (0, 0, 0, rows - m))
        key = torch._int_mm(block, db.t())[:m, :n].to(dtype)
        key += nbits
        key <<= id_bits
        key |= low
        top, _ = torch.topk(key, k_eff, dim=1)
        del key  # free this block before the next one's product
        ip = (top >> id_bits) - nbits
        hamming[start : start + m] = (nbits - ip) * 0.5
        ids[start : start + m] = id_mask - (top & id_mask)
    return _pad_hamming(hamming, ids, k)


def hamming_topk(
    db_signs: torch.Tensor,
    q_signs: torch.Tensor,
    k: int,
    db_tile: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest Hamming distances: `hamming_topk_int` on CUDA
    tensors, `hamming_topk_plain` on CPU ones (`db_tile` shapes only that).
    Returns (hamming [Q, k] float32 ascending, ids [Q, k] int32)."""
    if q_signs.device.type == "cuda":
        return hamming_topk_int(db_signs, q_signs, k)
    return hamming_topk_plain(db_signs, q_signs, k, db_tile)
