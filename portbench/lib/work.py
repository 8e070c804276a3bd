"""Operations and bytes of the work the cells run, from shapes alone.

Frozen formulas: the rooflines and the model FLOP share divide these by
measured device time, so a later change to the program cannot change what
they count.
"""

from .peaks import PEAK_OPS, bound_s

BF16 = 2  # bytes
# Smith-Waterman cell in int32: substitution lookup + add, two gap updates
# of two ops each, a four-way max, the running best: ~10 scalar ops,
# counted over real cells (sum of len(q) * len(t) over the pairs)
SW_OPS_PER_CELL = 10


def t5_layer_params(cfg: dict) -> int:
    """Weights of one encoder layer that every token multiplies: q, k, v, o
    and the two FFN matrices (norm scales and the position bias are left
    out: they are not products)."""
    d, inner = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"]
    return 4 * d * inner + 2 * d * cfg["d_ff"]


def t5_model_flops(lengths, cfg: dict) -> float:
    """Model FLOPs of encoding proteins of these real lengths: 2 x the layer
    weights per residue, plus 4 x L x H x d_kv per residue and layer for
    attention over the real length L (QK^T and PV, two FLOPs a product)."""
    layers = cfg["num_layers"]
    per_res = 2 * layers * t5_layer_params(cfg)
    attn = 4 * cfg["num_heads"] * cfg["d_kv"] * layers
    return float(sum(n * per_res + attn * n * n for n in lengths))


def ffn_bound_s(tokens: int, d: int, f: int) -> float:
    """One fused FFN call over `tokens` rows: two bf16 GEMMs (4·T·d·f
    operations); x, both weight matrices and the output once."""
    ops = 4 * tokens * d * f
    nbytes = BF16 * (2 * tokens * d + 2 * d * f + d)
    return bound_s(ops, "bf16", nbytes)


def attention_bound_s(batch: int, heads: int, length: int, d_kv: int) -> float:
    """One attention call over [B, H, L, d_kv] bf16 q, k, v: 4·B·H·L²·d_kv
    operations; q, k, v and the context once, the mask and the fp32
    [H, 2L-1] offset table once."""
    ops = 4 * batch * heads * length * length * d_kv
    nbytes = (BF16 * 4 * batch * heads * length * d_kv + batch * length
              + 4 * heads * (2 * length - 1))
    return bound_s(ops, "bf16", nbytes)


def int8_search_bound_s(queries: int, rows: int, d: int, k: int) -> float:
    """An int8 x int8 all-pairs product of `queries` by `rows` at width d,
    2·Q·N·d operations; the int8 rows and queries once, their scales, and
    the [Q, k] fp32 scores and int32 ids once."""
    ops = 2 * queries * rows * d
    nbytes = (queries + rows) * (d + 4) + queries * k * 8
    return bound_s(ops, "int8", nbytes)


def sw_bound_s(cells: int) -> float:
    """Real DP cells at SW_OPS_PER_CELL int32 operations each."""
    return cells * SW_OPS_PER_CELL / PEAK_OPS["int32"]
