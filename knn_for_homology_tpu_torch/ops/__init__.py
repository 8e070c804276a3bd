"""Distance, top-k and alignment ops; CUDA kernels with plain twins.

The names the JAX package's `ops` exports, where the port has them:
`align_pairs`, `sw_scores` and `sw_scores_grouped` run kernel C (or its
plain version), `exact_topk` / `exact_topk_traced` kernel B, `beam_expand`
kernel K and `flat_topk` routes to kernels A, B and D-F.
"""

from .align import align_hits, align_pairs, sw_scores, sw_scores_grouped
from .distance import METRICS, finalize_scores, l2_normalize, similarity_block
from .exact_cuda import exact_topk, exact_topk_traced
from .lsh import hamming_topk
from .slab_cuda import beam_expand, pack_neighbours
from .topk import flat_topk, oneshot_topk, streaming_topk

__all__ = [
    "align_hits",
    "align_pairs",
    "sw_scores",
    "sw_scores_grouped",
    "exact_topk",
    "exact_topk_traced",
    "beam_expand",
    "pack_neighbours",
    "flat_topk",
    "oneshot_topk",
    "hamming_topk",
    "l2_normalize",
    "similarity_block",
    "finalize_scores",
    "METRICS",
    "streaming_topk",
]
