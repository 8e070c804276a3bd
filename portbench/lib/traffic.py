"""Inputs of every cell, made from the run's seed: protein lengths,
sequences, Pfam20-like clustered vectors with their families' sequences,
and ProtT5 weights.

The seed changes what is drawn and in which order, never how much work
there is: lengths come from fixed quantiles of their distribution and the
seed only permutes them, so every seed runs the same set of sizes.
"""

import math
from statistics import NormalDist

import numpy as np
import torch

AAS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def rng(seed: int, stream: int) -> np.random.Generator:
    """Host generator of one named stream of a run."""
    return np.random.default_rng([int(seed), stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    """Device generator of one named stream of a run (seeds may exceed 63
    bits: they are folded with the stream number first)."""
    lo, hi = np.random.SeedSequence([int(seed), stream]).generate_state(2)
    mixed = (int(hi) << 32 | int(lo)) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def lognormal_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """n lengths at the (i + 1/2)/n quantiles of a lognormal of this median
    and sigma, clipped to [lo, hi] (the repo's protein-length mix: median
    330, sigma 0.55, [50, 2048])."""
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    raw = np.exp(math.log(median) + sigma * np.asarray(z))
    return np.clip(np.round(raw), lo, hi).astype(np.int64)


def uniform_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """n lengths at the (i + 1/2)/n quantiles of the uniform on [lo, hi]."""
    q = (np.arange(n) + 0.5) / n
    return np.round(lo + q * (hi - lo)).astype(np.int64)


def lengths_of(mix: dict) -> np.ndarray:
    """The length set a traffic mix names: {"kind": "lognormal", "n",
    "median", "sigma", "lo", "hi"} or {"kind": "uniform", "n", "lo", "hi"}."""
    if mix["kind"] == "lognormal":
        return lognormal_lengths(mix["n"], mix["median"], mix["sigma"],
                                 mix["lo"], mix["hi"])
    if mix["kind"] == "uniform":
        return uniform_lengths(mix["n"], mix["lo"], mix["hi"])
    raise ValueError(f"unknown length mix {mix['kind']!r}")


def random_sequences(gen: np.random.Generator, lengths) -> list:
    """Uniform random residues over the 20 amino acids, one protein a
    length, in the order given."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = AAS[gen.integers(0, 20, int(lengths.sum()))].tobytes()
    ends = np.cumsum(lengths)
    return [codes[e - n:e].decode() for e, n in zip(ends, lengths)]


def clustered_vectors(seed: int, families: int, per_family: int, dim: int,
                      spread: float, device):
    """Pfam20-like vectors on the device (data/fixtures.py:make_clustered's
    shape): family centroids x `spread` plus unit Gaussian noise. Returns
    rows [families·per_family, dim] fp32; rows of family f are
    f·per_family .. (f+1)·per_family - 1."""
    gen = torch_gen(seed, 1, device)
    centroids = torch.randn((families, dim), generator=gen, device=device)
    centroids *= spread
    rows = torch.randn((families * per_family, dim), generator=gen,
                       device=device)
    rows += centroids.repeat_interleave(per_family, dim=0)
    return rows


def family_sequences(seed: int, lengths, per_family: int, mutate: float,
                     trim: float, device) -> list:
    """Each family's proteins are copies of one random ancestor with a
    `mutate` share of residues replaced at random and up to `trim` of the
    ancestor's length cut from each end (chip_smoke.write_dataset's
    families, made on the device). `lengths` are the ancestors' lengths,
    one a family. Returns the proteins, family-major: member m of family f
    at f·per_family + m."""
    lengths = np.asarray(lengths, dtype=np.int64)
    fams, per = len(lengths), per_family
    total = int(lengths.sum())
    gen = torch_gen(seed, 2, device)
    ancestors = torch.randint(0, 20, (total,), generator=gen, device=device,
                              dtype=torch.uint8)
    codes = ancestors.expand(per, total).clone()
    hit = torch.rand((per, total), generator=gen, device=device) < mutate
    fresh = torch.randint(0, 20, (per, total), generator=gen, device=device,
                          dtype=torch.uint8)
    codes = torch.where(hit, fresh, codes)
    cut = (torch.rand((fams, per, 2), generator=gen, device=device)
           * trim * torch.as_tensor(lengths, device=device)[:, None, None])
    cut = cut.long().cpu().numpy()
    raw = [AAS[row].tobytes() for row in codes.cpu().numpy()]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    members = []
    for f in range(fams):
        s, n = int(starts[f]), int(lengths[f])
        members.extend(raw[m][s + cut[f, m, 0]: s + n - cut[f, m, 1]].decode()
                       for m in range(per))
    return members


def database(cfg: dict, seed: int, device, with_sequences: bool = False
             ) -> dict:
    """A database configuration's inputs, split per family as the
    reference's Pfam20 subset10 is (its first `train_per_family` members
    train, the next `test_per_family` test): {"train", "test", "all"}
    vectors on the device ("all": every member, family-major) and, if
    asked, {"train_seqs", "test_seqs", "all_seqs"} sequences, the
    families' ancestor lengths permuted by the seed."""
    fams, dim = cfg["families"], cfg["dim"]
    n_train, n_test = cfg["train_per_family"], cfg["test_per_family"]
    per = n_train + n_test
    rows = clustered_vectors(seed, fams, per, dim, cfg["centroid_scale"],
                             device)
    by_family = rows.view(fams, per, dim)
    out = {"all": rows,
           "train": by_family[:, :n_train].reshape(-1, dim),
           "test": by_family[:, n_train:].reshape(-1, dim)}
    if with_sequences:
        lengths = rng(seed, 6).permutation(lengths_of(cfg["lengths"]))
        seqs = family_sequences(seed, lengths, per, cfg["mutate"],
                                cfg["trim"], device)
        out["all_seqs"] = seqs
        out["train_seqs"] = [s for i, s in enumerate(seqs)
                             if i % per < n_train]
        out["test_seqs"] = [s for i, s in enumerate(seqs)
                            if i % per >= n_train]
    return out


def t5_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Random ProtT5 weights in the port's tree ([in, out] matrices), drawn
    on the device in one call per kind of matrix at the published T5
    initialisation (transformers' T5PreTrainedModel._init_weights, factor
    1): q N(0, (d_model·d_kv)^-1/2), k and v d_model^-1/2, o (H·d_kv)^-1/2,
    wi d_model^-1/2, wo d_ff^-1/2, the embedding 1, the relative bias
    d_model^-1/2, norms 1. Its 1/sqrt(d_kv) in q keeps the unscaled logits
    near unit spread, as trained T5 weights keep them."""
    d, dk, h, f = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["d_ff"]
    layers, inner = cfg["num_layers"], h * dk
    gen = torch_gen(seed, 3, device)

    def draw(shape, std):
        out = torch.randn(shape, generator=gen, device=device)
        return out.mul_(std).to(dtype)

    mats = {
        "q": draw((layers, d, inner), (d * dk) ** -0.5),
        "k": draw((layers, d, inner), d ** -0.5),
        "v": draw((layers, d, inner), d ** -0.5),
        "o": draw((layers, inner, d), inner ** -0.5),
        "wi": draw((layers, d, f), d ** -0.5),
        "wo": draw((layers, f, d), f ** -0.5),
    }
    ones = torch.ones((2 * layers + 1, d), dtype=dtype, device=device)
    return {
        "embedding": draw((cfg["vocab_size"], d), 1.0),
        "rel_embedding": draw(
            (cfg["relative_attention_num_buckets"], h), d ** -0.5),
        "layers": [
            {"attn": {"ln": ones[2 * i], **{n: mats[n][i]
                                            for n in ("q", "k", "v", "o")}},
             "mlp": {"ln": ones[2 * i + 1], "wi": mats["wi"][i],
                     "wo": mats["wo"][i]}}
            for i in range(layers)
        ],
        "final_ln": ones[-1],
    }
