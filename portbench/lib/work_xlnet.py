"""Operations and bytes of ProtXLNet's work, from shapes and the program's
counts alone (lib/work.py's frozen formulas, for the relative-position
encoder). Frozen: encoder_mfu.xlnet and relattn_roofline.xlnet divide these
by measured device time.
"""

from .peaks import bound_s
from .work import BF16


def xlnet_layer_params(cfg: dict) -> int:
    """Weights of one ProtXLNet layer that every token multiplies: q, k,
    v, o and the two feed-forward matrices (W_r multiplies the positions,
    counted apart; biases and norms are not products)."""
    d, inner = cfg["d_model"], cfg["n_head"] * cfg["d_head"]
    return 4 * d * inner + 2 * d * cfg["d_inner"]


def xlnet_model_flops(residues: int, residues_sq: int, cfg: dict) -> float:
    """Model FLOPs of encoding proteins with these sums of real lengths n
    and of n²: per residue and layer 2 x the layer weights, plus 6·L·H·d_head
    for the content term, the position term and PV over the real length L
    (two FLOPs a product each); per protein and layer the projection of
    its 2n relative positions, 2·2n·d_model·H·d_head, at its own length."""
    layers, d = cfg["n_layer"], cfg["d_model"]
    inner = cfg["n_head"] * cfg["d_head"]
    per_res = layers * (2 * xlnet_layer_params(cfg) + 4 * d * inner)
    return float(residues * per_res + 6 * inner * layers * residues_sq)


def relattn_bound_s(batch: int, heads: int, length: int, d_head: int) -> float:
    """One relative-position attention call (kernel L) over [B, H, L,
    d_head] bf16 q, k, v: 6·B·H·L²·d_head operations (content, position
    and PV products); q, k, v and the context once, R [2L, H, d_head] once
    and the [B, L] mask."""
    ops = 6 * batch * heads * length * length * d_head
    nbytes = (BF16 * (4 * batch * heads * length * d_head
                      + 2 * length * heads * d_head) + batch * length)
    return bound_s(ops, "bf16", nbytes)
