"""The flagship forward step: sequences' tokens → ProtT5 encoder → masked
mean-pool → l2 → top-k neighbours in a database (the counterpart of
__graft_entry__.py's `forward_step`, the JAX package's one-jit program).

    sims, ids = forward_step(encoder, db, token_ids, mask, k=13)

`encoder` is a models/t5.py:T5Encoder; `db` [N, d] holds L2-normalised
fp32 rows on the encoder's device. Inner product of normalised vectors is
cosine similarity; sims [B, k] fp32 descending, ids [B, k] int32.
"""

import torch

from .models.pooling import mean_pool
from .models.t5 import T5Encoder
from .ops.distance import l2_normalize
from .ops.topk import oneshot_topk


@torch.no_grad()
def forward_step(
    encoder: T5Encoder,
    db: torch.Tensor,
    token_ids: torch.Tensor,
    mask: torch.Tensor,
    k: int = 13,
):
    hidden = encoder(token_ids, mask)
    pooled = l2_normalize(mean_pool(hidden, mask))
    return oneshot_topk(db, pooled, k, metric="ip")
