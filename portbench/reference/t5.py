"""Plain ProtT5 (T5 v1.0 encoder) in float32, one protein at a time.

Follows the published T5 encoder as transformers' T5EncoderModel runs it
for ProtT5: token embedding; per layer a pre-norm (RMS, no bias)
self-attention with unscaled q.k logits plus one relative-position bias
shared by all layers (bidirectional buckets), and a pre-norm ReLU
feed-forward block, each added to the residual stream; a final RMS norm.
The protein is tokenised as ProtT5's tokenizer does (one token a residue,
U Z O B as X, then </s>); pooling is the mean over the residues, </s> left
out. No padding, no kernels, no batching: it imports nothing of the
program.

`quant` rounds both operands of every product first: the control runs the
same reference with fp8 (e4m3) operands, the precision one step below the
configuration's bf16.
"""

import math

import torch

# ProtT5's published vocabulary: <pad> 0, </s> 1, <unk> 2, then the residues
RESIDUES = "ALGVSREDTIPKFQNYMHWC"
VOCAB = {aa: i + 3 for i, aa in enumerate(RESIDUES)}
VOCAB["X"] = 23
EOS = 1
UNK = 2


def tokens(sequence: str) -> list:
    seq = sequence.upper()
    return [VOCAB.get("X" if aa in "UZOB" else aa, UNK) for aa in seq] + [EOS]


def buckets(length: int, num_buckets: int, max_distance: int, device):
    """[L, L] bucket of key position - query position (T5's bidirectional
    bucketing, computed as transformers computes it, in float32)."""
    pos = torch.arange(length, device=device)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = exact + (torch.log(n.float() / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = torch.clamp(large, max=half - 1)
    return out + torch.where(n < exact, n, large)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-row scale (amax / 448), back to
    float32: the precision of an fp8 path that scales its tensors."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def encode_many(weights: dict, sequences, cfg: dict, quant=None) -> list:
    """[L + 1, d_model] float32 hidden states of each protein (</s> last),
    layer by layer: each layer's weights are widened to float32 once for
    all the proteins."""
    dev = weights["embedding"].device
    h, dk = cfg["num_heads"], cfg["d_kv"]
    eps = cfg["layer_norm_epsilon"]
    mm = torch.matmul if quant is None else (
        lambda a, b: torch.matmul(quant(a), quant(b.transpose(-1, -2))
                                  .transpose(-1, -2)))
    rel = weights["rel_embedding"].float()
    xs, biases = [], []
    for seq in sequences:
        ids = torch.tensor(tokens(seq), device=dev)
        xs.append(weights["embedding"][ids].float())
        b = buckets(ids.shape[0], cfg["relative_attention_num_buckets"],
                    cfg["relative_attention_max_distance"], dev)
        biases.append(rel[b].permute(2, 0, 1))  # [H, L, L]
    for layer in weights["layers"]:
        a = {k: v.float() for k, v in layer["attn"].items()}
        f = {k: v.float() for k, v in layer["mlp"].items()}
        for i, x in enumerate(xs):
            length = x.shape[0]
            n = rms_norm(x, a["ln"], eps)
            q, k, v = (mm(n, a[w]).view(length, h, dk).transpose(0, 1)
                       for w in ("q", "k", "v"))
            probs = torch.softmax(mm(q, k.transpose(-1, -2)) + biases[i], -1)
            ctx = mm(probs, v).transpose(0, 1).reshape(length, h * dk)
            x = x + mm(ctx, a["o"])
            n = rms_norm(x, f["ln"], eps)
            xs[i] = x + mm(torch.relu(mm(n, f["wi"])), f["wo"])
    final = weights["final_ln"].float()
    return [rms_norm(x, final, eps) for x in xs]


@torch.no_grad()
def pooled(weights: dict, sequences, cfg: dict, quant=None) -> torch.Tensor:
    """[n, d_model] float32 mean over each protein's residues."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        hidden = encode_many(weights, sequences, cfg, quant)
        return torch.stack([x[:-1].mean(0) for x in hidden])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
