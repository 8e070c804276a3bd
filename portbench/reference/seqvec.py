"""Plain SeqVec (ELMo bi-LM) in float32, one protein at a time.

Follows ELMo as AllenNLP's ElmoEmbedder runs it for SeqVec (bilm-tf
conventions), written from the published description: each residue is a
"word" of bilm-tf character ids [begin-of-word, the residue's byte,
end-of-word, padding ...]; the character CNN embeds the characters,
convolves them with filters of widths 1-7, takes the max over positions,
then two highway layers and a linear projection to 512; the protein is
wrapped in the sentence-boundary words <S> and </S> and runs through two
layers of bidirectional LSTMs with a projection (LSTMP: 4096 cells, 512
outputs, the cell state and the projection clipped at ±3), the backward
LSTM over the protein's own words reversed, with a residual connection
around the second layer. The three layers (the character CNN's output
duplicated to 1024, then forward ‖ backward of each LSTM layer) lose the
boundary positions; SeqVec's per-protein vector ("SeqVec Sum", what
bio_embeddings' reduce gives) is the sum of the layers averaged over the
residues. No batching, no padding, no cache, no kernel: it imports nothing
of the program, and its products are float32 with TF32 off.

Departures, each on the character CNN's fixed 23 words, none on the
recurrence (no checkpoint in the repository can settle them; the
reference follows the program there):
  * a word is 8 characters wide, where AllenNLP pads words to 50; the
    max over the windows of the width-6 and width-7 filters then sees
    fewer padding windows;
  * the CNN's activation is tanh, applied before the max (the same as
    after it, tanh being monotone), where bilm-tf's published options name
    relu;
  * character ids index the embedding table as they are (256 and 257 the
    boundary characters, 258-260 begin, end and padding), where AllenNLP
    adds one to every id.

`quant` rounds the recurrent weights (W_h and W_proj of every LSTM) first:
the control runs the same reference with fp8 (e4m3) weights scaled per
column, the precision one step below the configuration's bf16, in the
place of the kernel that holds them.
"""

import contextlib

import torch

BOS_CHAR, EOS_CHAR = 256, 257
BOW, EOW, CHAR_PAD = 258, 259, 260
WORD_CHARS = 8
KNOWN = "ACDEFGHIKLMNPQRSTVWYX"


def char_ids(sequence: str) -> torch.Tensor:
    """[L + 2, WORD_CHARS] character ids of <S>, the residues (unknown
    letters as X) and </S>."""
    chars = ([BOS_CHAR]
             + [ord(aa if aa in KNOWN else "X") for aa in sequence.upper()]
             + [EOS_CHAR])
    out = torch.full((len(chars), WORD_CHARS), CHAR_PAD, dtype=torch.long)
    out[:, 0], out[:, 2] = BOW, EOW
    out[:, 1] = torch.tensor(chars)
    return out


def char_cnn(weights: dict, ids: torch.Tensor) -> torch.Tensor:
    """[words, 512] token representations of [words, WORD_CHARS] ids."""
    x = weights["char_embedding"].float()[ids]  # [words, chars, E]
    feats = []
    for conv in weights["convs"]:
        w = conv["w"].float()  # [width, E, n]
        width = w.shape[0]
        windows = x.unfold(1, width, 1)  # [words, positions, E, width]
        y = torch.einsum("spew,wen->spn", windows, w) + conv["b"].float()
        feats.append(torch.tanh(y).amax(dim=1))
    h = torch.cat(feats, dim=1)
    for hw in weights["highways"]:
        gate = torch.sigmoid(h @ hw["w_gate"].float() + hw["b_gate"].float())
        lin = torch.relu(h @ hw["w_lin"].float() + hw["b_lin"].float())
        h = gate * lin + (1.0 - gate) * h
    return h @ weights["proj_w"].float() + weights["proj_b"].float()


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """w [in, out] through float8 e4m3 with a scale a column (amax / 448),
    back to float32."""
    amax = w.abs().amax(dim=0, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def lstmp(x: torch.Tensor, cell: dict, cfg: dict, quant=None) -> torch.Tensor:
    """[n, 512] outputs of one LSTMP over x [n, 512], first word first."""
    w_x, b = cell["w_x"].float(), cell["b"].float()
    w_h, w_p = cell["w_h"].float(), cell["w_proj"].float()
    if quant is not None:
        w_h, w_p = quant(w_h), quant(w_p)
    clip_c, clip_p = cfg["cell_clip"], cfg["proj_clip"]
    h = x.new_zeros(cfg["proj_dim"])
    c = x.new_zeros(cfg["lstm_dim"])
    xw = x @ w_x + b
    out = []
    for t in range(x.shape[0]):
        i, f, g, o = (xw[t] + h @ w_h).chunk(4)
        c = torch.clamp(torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g),
                        -clip_c, clip_c)
        h = torch.clamp((torch.sigmoid(o) * torch.tanh(c)) @ w_p,
                        -clip_p, clip_p)
        out.append(h)
    return torch.stack(out)


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
def run(weights: dict, sequence: str, cfg: dict, quant=None):
    """(layers [3, L, 1024], lstm [[L + 2, 1024] of each LSTM layer]): the
    protein's three SeqVec layers, and each LSTM layer's own outputs
    (forward ‖ backward, before the residual) over <S> … </S>."""
    dev = weights["char_embedding"].device
    with fp32_products():
        x = char_cnn(weights, char_ids(sequence).to(dev))  # [L + 2, 512]
        n = x.shape[0] - 2
        layers = [torch.cat([x[1:n + 1], x[1:n + 1]], dim=-1)]
        lstm, fwd_in, bwd_in = [], x, x.flip(0)
        for li in range(cfg["n_lstm_layers"]):
            fwd = lstmp(fwd_in, weights["lstm_fwd"][li], cfg, quant)
            bwd = lstmp(bwd_in, weights["lstm_bwd"][li], cfg, quant)
            lstm.append(torch.cat([fwd, bwd.flip(0)], dim=-1))
            if li > 0 and cfg["use_skip_connections"]:
                fwd, bwd = fwd + fwd_in, bwd + bwd_in
            layers.append(torch.cat([fwd, bwd.flip(0)], dim=-1)[1:n + 1])
            fwd_in, bwd_in = fwd, bwd
        return torch.stack(layers), lstm


@torch.no_grad()
def pooled(weights: dict, sequences, cfg: dict, quant=None) -> torch.Tensor:
    """[n, 1024] float32 "SeqVec Sum" vectors: the layers' sum averaged
    over each protein's residues."""
    return torch.stack([run(weights, s, cfg, quant)[0].sum(0).mean(0)
                        for s in sequences])
