"""Typed configuration — consolidates the reference's scattered constants.

The reference spreads its configuration over module constants and editable
script globals (reference: seqvec_search/constants.py:3-4,
seqvec_search/utils.py:14, pfam/slices/slices_shared.py:8-9). We keep the
same defaults as a semantic contract but put them in one typed place.
"""

from dataclasses import dataclass

# reference: seqvec_search/constants.py:3
DEFAULT_HITS: int = 13

# reference: seqvec_search/utils.py:14
E_VALUE_CUTOFF: float = 10000.0

# reference: pfam/slices/slices_shared.py:8-9 (600-aa windows, 200 overlap)
SLICE_SIZE: int = 600
SLICE_OVERLAP: int = 200

# reference: pfam/embed_t5_fp16.py:29 (hard length cutoff for embedding)
MAX_SEQ_LEN: int = 3096

# reference: pfam/embed_t5_fp16.py:19 (token-budget batching default)
DEFAULT_TOKEN_BATCH: int = 7000

# Sentinel E-value used when padding ragged hit lists to rectangles
# (reference: seqvec_search/mmseqs/_read_results_db.py:178-196).
SENTINEL_E_VALUE: float = 100000.0

# Fixed seeds used throughout the reference (semantic contract):
# make_pfam_subset default (reference: seqvec_search/make_pfam_subset.py:108-112)
PFAM_SUBSET_SEED: int = 532741831
# Pfam20 "subset10" instance (reference: pfam/pfam_shared.py:38)
SUBSET10_SEED: int = 2020
# small-random fixture (reference: test-data/small-random/generate_arrays.py)
SMALL_RANDOM_SEED: int = 7


@dataclass(frozen=True)
class SearchConfig:
    """Knobs of the exact/ANN search engines.

    Defaults mirror the reference's FAISS usage: 1024-bit LSH
    (reference: seqvec_search/create_index.py:33), 2048-bit LSH for full
    sequences (reference: pfam/proteins_search.py:26-27), HNSW M=42 /
    efSearch=256 (reference: pfam/proteins_search.py:30-31), k=1000 for
    full-sequence queries (reference: pfam/search.py:37).
    """

    hits: int = DEFAULT_HITS
    metric: str = "cosine"  # cosine | ip | l2
    db_tile: int = 8192  # database rows scanned per top-k merge step
    query_block: int = 1024  # queries processed per kernel invocation
    lsh_bits: int = 1024
    graph_degree: int = 42  # ~ HNSW M
    beam_width: int = 256  # ~ HNSW efSearch
    approx: bool = False  # use jax.lax.approx_max_k instead of exact top-k
    recall_target: float = 0.95


@dataclass(frozen=True)
class EncoderConfig:
    """Knobs of the embedding layer (reference: pfam/embed_t5_fp16.py:16-23)."""

    max_len: int = MAX_SEQ_LEN
    token_batch: int = DEFAULT_TOKEN_BATCH
    dtype: str = "bfloat16"  # reference used fp16 CUDA; bf16 is the TPU native
