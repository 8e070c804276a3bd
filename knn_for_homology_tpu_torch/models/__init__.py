from . import t5
from .batching import cut_sequences, embed_in_batches, make_batches, pad_tokens
from .pooling import (
    l2_then_mean_pool,
    mean_pool,
    pool_domain_range,
    pool_domains,
)
from .registry import (
    AACompositionEmbedder,
    EMBEDDERS,
    EmbedderBase,
    ProtT5Embedder,
    get_embedder,
)

__all__ = [
    "t5",
    "cut_sequences",
    "embed_in_batches",
    "make_batches",
    "pad_tokens",
    "mean_pool",
    "l2_then_mean_pool",
    "pool_domain_range",
    "pool_domains",
    "EMBEDDERS",
    "EmbedderBase",
    "ProtT5Embedder",
    "AACompositionEmbedder",
    "get_embedder",
]
