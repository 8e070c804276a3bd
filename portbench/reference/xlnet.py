"""Plain ProtXLNet (XLNet-UniRef100) in float32, one protein at a time.

Follows transformers' XLNetModel as bio_embeddings runs it for ProtXLNet
(attn_type "bi", clamp_len -1, bi_data false, no memory): the token
embedding, then per layer the content stream's relative attention

    score(i, j) = ((q_i + r_w)·k_j + (q_i + r_r)·R[L - i + j]) / sqrt(d_head)

with R = sinusoid(L ... -L+1) · W_r aligned by XLNet's reshape shift
(`rel_shift`), the softmax, p·v and the output projection, a post
LayerNorm with bias, then a feed-forward block with biases and exact GELU
and a post LayerNorm again. The sinusoid is built in float32 as
transformers builds it. The protein is tokenised as ProtXLNet's tokenizer
does (one token a residue, U Z O B as X, then <sep> <cls> at the end);
pooling is the mean over the residues, the two specials left out. No
padding, no kernels, no batching: it imports nothing of the program.

Departure: the segment term ef is left out. XLNetModel computes it only
when token_type_ids are given, and bio_embeddings gives none, so the
published model embeds without it too.

`quant` rounds both operands of every product first: the control runs the
same reference with fp8 (e4m3) operands, the precision one step below the
configuration's bf16.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

# ProtXLNet's sentencepiece ids: <unk> 0, <cls> 3, <sep> 4, then residues
RESIDUES = "LAGVESIKRDTPNQFYMHCWXUBZO"
VOCAB = {aa: i + 7 for i, aa in enumerate(RESIDUES)}
UNK, CLS, SEP = 0, 3, 4


def tokens(sequence: str) -> list:
    seq = sequence.upper()
    return ([VOCAB.get("X" if aa in "UZOB" else aa, UNK) for aa in seq]
            + [SEP, CLS])


def positional(length: int, d_model: int, device) -> torch.Tensor:
    """[2L, d_model] sinusoid of the relative positions L ... -L+1
    (XLNetModel.relative_positional_encoding, attn_type "bi")."""
    freq = torch.arange(0, d_model, 2.0, device=device)
    inv_freq = 1.0 / torch.pow(10000, freq / d_model)
    pos = torch.arange(length, -length, -1.0, device=device)
    sinusoid = torch.einsum("i,d->id", pos, inv_freq)
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1)


def rel_shift(x: torch.Tensor, klen: int) -> torch.Tensor:
    """XLNetRelativeAttention.rel_shift_bnij on [H, L, 2L]: column j of row
    i ends up holding column L - i + j."""
    h, i, j = x.shape
    x = x.reshape(h, j, i)[:, 1:, :].reshape(h, i, j - 1)
    return x[:, :, :klen]


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-row scale (amax / 448), back to
    float32: the precision of an fp8 path that scales its tensors."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def products(quant=None):
    """torch.matmul, or with `quant` rounding both operands first (the
    second along its reduced axis)."""
    if quant is None:
        return torch.matmul
    return lambda a, b: torch.matmul(quant(a), quant(b.transpose(-1, -2))
                                     .transpose(-1, -2))


def attention(q, k, v, r, r_w, r_r, mm=torch.matmul) -> torch.Tensor:
    """[H, L, dh] context of one protein's [H, L, dh] q, k, v and its
    [H, 2L, dh] projected sinusoid r, with the biases r_w, r_r [H, dh]."""
    n, dh = q.shape[1], q.shape[2]
    ac = mm(q + r_w[:, None], k.transpose(-1, -2))
    bd = rel_shift(mm(q + r_r[:, None], r.transpose(-1, -2)), n)
    probs = torch.softmax((ac + bd) / math.sqrt(dh), dim=-1)
    return mm(probs, v)


def layer_qkvr(x, layer: dict, cfg: dict, mm=torch.matmul):
    """q, k, v [H, L, dh] and r [H, 2L, dh] of one layer's float32 input
    x [L, d_model] and float32 weights."""
    d, h, dh = cfg["d_model"], cfg["n_head"], cfg["d_head"]
    n = x.shape[0]
    q, k, v = (mm(x, layer[w].reshape(d, h * dh)).view(n, h, dh)
               .transpose(0, 1) for w in ("q", "k", "v"))
    r = mm(positional(n, d, x.device), layer["r"].reshape(d, h * dh))
    return q, k, v, r.view(2 * n, h, dh).transpose(0, 1)


def encode_many(weights: dict, sequences, cfg: dict, quant=None,
                layers=None) -> list:
    """[L + 2, d_model] float32 hidden states of each protein (<sep> <cls>
    last) after the first `layers` layers (all by default), layer by layer:
    each layer's weights are widened to float32 once for all the
    proteins."""
    dev = weights["embedding"].device
    d, h, dh = cfg["d_model"], cfg["n_head"], cfg["d_head"]
    eps = cfg["layer_norm_eps"]
    mm = products(quant)
    emb = weights["embedding"].float()
    xs = [emb[torch.tensor(tokens(s), device=dev)] for s in sequences]
    for layer in weights["layers"][:layers]:
        p = {k: v.float() for k, v in layer.items()}
        wo = p["o"].reshape(d, h * dh)
        for i, x in enumerate(xs):
            n = x.shape[0]
            q, k, v, r = layer_qkvr(x, p, cfg, mm)
            ctx = attention(q, k, v, r, p["r_w_bias"], p["r_r_bias"], mm)
            ctx = ctx.transpose(0, 1).reshape(n, h * dh)
            x = F.layer_norm(x + mm(ctx, wo.T), (d,), p["ln_attn"],
                             p["ln_attn_b"], eps)
            hidden = F.gelu(mm(x, p["ff_w1"]) + p["ff_b1"])  # exact (erf)
            xs[i] = F.layer_norm(x + mm(hidden, p["ff_w2"]) + p["ff_b2"],
                                 (d,), p["ln_ff"], p["ln_ff_b"], eps)
    return xs


@contextlib.contextmanager
def fp32_products():
    """Full float32 products on the card (TF32 off), restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@torch.no_grad()
def pooled(weights: dict, sequences, cfg: dict, quant=None) -> torch.Tensor:
    """[n, d_model] float32 mean over each protein's residues."""
    with fp32_products():
        hidden = encode_many(weights, sequences, cfg, quant)
        return torch.stack([x[:-2].mean(0) for x in hidden])


@torch.no_grad()
def attention_of(q, k, v, layer: dict, cfg: dict, quant=None):
    """[H, L, dh] float32 context of one protein's given q, k, v [H, L, dh]
    (widened to float32) at a layer of `weights["layers"]`: R projected
    here from the layer's W_r and the sinusoid of L, the biases the layer's,
    no padding. `quant` as in encode_many."""
    d, h, dh = cfg["d_model"], cfg["n_head"], cfg["d_head"]
    mm = products(quant)
    with fp32_products():
        p = {k_: w.float() for k_, w in layer.items()
             if k_ in ("r", "r_w_bias", "r_r_bias")}
        n = q.shape[1]
        r = mm(positional(n, d, q.device), p["r"].reshape(d, h * dh))
        r = r.view(2 * n, h, dh).transpose(0, 1)
        return attention(q.float(), k.float(), v.float(), r, p["r_w_bias"],
                         p["r_r_bias"], mm)
