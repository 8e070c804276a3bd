"""The encoder's CUDA kernels (G: fused FFN, H: flash attention, I: short
attention) against their plain PyTorch versions, on the card, and the
encoder on the card against the encoder on the CPU, on the kernels and on
their plain versions swapped in for the wrappers.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_encoder.py

Tolerance: both sides round their result to bf16 once, from fp32 sums taken
in different orders (and p, for H, rounded at different running maxima), so
they may differ by an ulp or two of bf16 (2^-8 relative); every comparison
allows 2^-6 of the reference's largest magnitude (4 ulps there). An fp32
encode on the card through the plain versions differs from the CPU's only
by fp32 sums in other orders: 2^-13 of the largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.models import t5
from knn_for_homology_tpu_torch.models.t5 import offset_bias_table
from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda
from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain
from knn_for_homology_tpu_torch.ops.flash_attention import flash_attention_plain
from knn_for_homology_tpu_torch.ops.short_attention import short_attention_plain

pytestmark = pytest.mark.cuda
BF16_TOL = 2.0**-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def assert_bf16_close(got, want, tol=BF16_TOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= tol * max(scale, 1e-6), (err, scale)


def _bf16(rng, *shape, scale=1.0, device="cuda"):
    arr = (rng.randn(*shape) * scale).astype(np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=torch.bfloat16)


def _ffn_inputs(seed, t, d, f, device):
    rng = np.random.RandomState(seed)
    return (
        _bf16(rng, t, d, scale=2.0, device=device),
        _bf16(rng, d, device=device) + 1.0,
        _bf16(rng, d, f, scale=d**-0.5, device=device),
        _bf16(rng, f, d, scale=f**-0.5, device=device),
    )


# the ragged edges of G's GEMM tiles: T around the 64-row warpgroup and
# 128-row block tiles; D 128 and 256 (narrower than a 256-wide N tile);
# F = 384, a multiple of 128 but not of the 256-wide N tile
G_EDGES = [(t, d, 384) for t in (1, 63, 64, 65, 127, 129)
           for d in (128, 256, 1024)]


@pytest.mark.parametrize("t,d,f", [(1, 128, 256), (37, 256, 384),
                                   (300, 1024, 512), (7000, 1024, 16384),
                                   (7000, 128, 384)] + G_EDGES)
def test_kernel_g_matches_plain(cuda, t, d, f):
    x, ln, wi, wo = _ffn_inputs(0, t, d, f, cuda)
    before = ffn_cuda.fused_ffn_t5.launches
    got = ffn_cuda.fused_ffn_t5(x, ln, wi, wo)
    assert ffn_cuda.fused_ffn_t5.launches == before + 1
    assert_bf16_close(got, fused_ffn_plain(x, ln, wi, wo))


def test_kernel_g_repeats_bit_for_bit(cuda):
    # every block sums its whole K in one fixed order (no split-K atomics)
    x, ln, wi, wo = _ffn_inputs(5, 1000, 1024, 4096, cuda)
    first = ffn_cuda.fused_ffn_t5(x, ln, wi, wo)
    assert torch.equal(first, ffn_cuda.fused_ffn_t5(x, ln, wi, wo))


def test_kernel_g_refuses_fp32(cuda):
    x, ln, wi, wo = (a.float() for a in _ffn_inputs(0, 8, 128, 256, cuda))
    with pytest.raises(TypeError):
        ffn_cuda.fused_ffn_t5(x, ln, wi, wo)


def _attention_inputs(seed, b, h, l, device, all_masked_row=True):
    rng = np.random.RandomState(seed)
    q, k, v = (_bf16(rng, b, h, l, 128, scale=0.3, device=device)
               for _ in range(3))
    mask = np.ones((b, l), dtype=bool)
    for row in range(b):
        mask[row, max(1, l - 7 * row - 3):] = False  # ragged real lengths
    if all_masked_row and b > 1:
        mask[-1] = False
    rel = torch.from_numpy(rng.randn(32, h).astype(np.float32)).to(device)
    return q, k, v, torch.from_numpy(mask).to(device), rel.to(torch.bfloat16)


# the ragged edges of H's 64-key tiles and 128-query blocks
@pytest.mark.parametrize("b,h,l", [(1, 2, 1), (2, 3, 65), (3, 2, 127),
                                   (2, 2, 129), (3, 2, 200), (2, 2, 1025),
                                   (2, 32, 3200)])
def test_kernel_h_matches_plain(cuda, b, h, l):
    q, k, v, mask, rel = _attention_inputs(1, b, h, l, cuda)
    table = offset_bias_table(rel, l, 32, 128)
    before = flash_cuda.flash_attention_t5.launches
    got = flash_cuda.flash_attention_t5(q, k, v, mask, table)
    assert flash_cuda.flash_attention_t5.launches == before + 1
    assert_bf16_close(got, flash_attention_plain(q, k, v, mask, table, block=64))
    if b > 1:  # a row with no real key is 0, as in the Pallas kernel
        assert not got[-1].float().abs().any()


# the ragged edges of I's 64-key tiles and 64-query blocks, the route's
# limit (1024, and just under it), and the phase-3 batches (13 x 512,
# 27 x 256, 6 x 1024; 8 x 896, a 7000-token batch past 512)
@pytest.mark.parametrize("b,h,l", [(1, 2, 1), (2, 3, 63), (2, 2, 64),
                                   (3, 2, 65), (2, 3, 100), (2, 2, 127),
                                   (2, 2, 128), (2, 2, 129), (3, 2, 512),
                                   (13, 32, 512), (27, 32, 256),
                                   (6, 32, 1024), (3, 2, 1000), (2, 2, 1023),
                                   (8, 32, 896)])
def test_kernel_i_matches_plain(cuda, b, h, l):
    q, k, v, mask, rel = _attention_inputs(2, b, h, l, cuda)
    table = offset_bias_table(rel, l, 32, 128)
    before = short_cuda.short_attention_t5.launches
    got = short_cuda.short_attention_t5(q, k, v, mask, table)
    assert short_cuda.short_attention_t5.launches == before + 1
    assert_bf16_close(got, short_attention_plain(q, k, v, mask, table))
    if b > 1:  # a row with no real key softmaxes to uniform over its L keys
        mean_v = v[-1].float().mean(dim=1, keepdim=True).expand_as(got[-1])
        assert_bf16_close(got[-1].float(), mean_v)


def test_attention_blocks_per_sm(cuda):
    """I fits two blocks per SM up to its limit; H one of two warpgroups and
    a producer warp (the CUDA occupancy query)."""
    assert short_cuda.blocks_per_sm(512) >= 2
    assert short_cuda.blocks_per_sm(1024) >= 2
    assert flash_cuda.blocks_per_sm(3200) >= 1


def test_kernel_i_refuses_past_its_limit(cuda):
    q, k, v, mask, rel = _attention_inputs(3, 1, 2, 1025, cuda)
    table = offset_bias_table(rel, 1025, 32, 128)
    before = short_cuda.short_attention_t5.launches
    with pytest.raises(ValueError):
        short_cuda.short_attention_t5(q, k, v, mask, table)
    assert short_cuda.short_attention_t5.launches == before


def test_attention_kernels_refuse_other_widths(cuda):
    q, k, v, mask, rel = _attention_inputs(3, 2, 2, 64, cuda)
    table = offset_bias_table(rel, 64, 32, 128)
    with pytest.raises(ValueError):
        flash_cuda.flash_attention_t5(q[..., :64].contiguous(),
                                      k[..., :64].contiguous(),
                                      v[..., :64].contiguous(), mask, table)
    with pytest.raises(TypeError):
        flash_cuda.flash_attention_t5(q.float(), k.float(), v.float(), mask,
                                      table)


# d_kv 128 and d_model 256 are widths the kernels take, at a few layers
CARD_CONFIG = t5.T5Config(vocab_size=32, d_model=256, d_kv=128, d_ff=512,
                          num_layers=2, num_heads=2)


# the wrappers of G, H and I, kept here because a test may swap them out
WRAPPERS = (ffn_cuda.fused_ffn_t5, flash_cuda.flash_attention_t5,
            short_cuda.short_attention_t5)


def _launches():
    return tuple(fn.launches for fn in WRAPPERS)


PLAIN = {ffn_cuda: ("fused_ffn_t5", fused_ffn_plain),
         flash_cuda: ("flash_attention_t5", flash_attention_plain),
         short_cuda: ("short_attention_t5", short_attention_plain)}


def _plain_on_card(monkeypatch, *modules):
    """These kernels' wrappers swapped for their plain versions, which the
    encoder then runs on the card (it looks the wrappers up at each
    encode)."""
    for mod in modules:
        name, plain = PLAIN[mod]
        monkeypatch.setattr(mod, name, plain)


# (length, config fields, kernels whose plain versions run on the card,
# launches of G, H, I a layer)
@pytest.mark.parametrize("length,fields,plain,launches", [
    (96, {}, (short_cuda,), (1, 0, 0)),  # I's plain version + kernel G
    (96, {}, (), (1, 0, 1)),  # kernel I + kernel G
    (200, {"blockwise_above": 128}, (), (1, 1, 0)),  # kernel H + kernel G
], ids=["plain-i", "kernel-i", "kernel-h"])
def test_encode_on_card_matches_cpu(cuda, monkeypatch, length, fields, plain,
                                    launches):
    config = dataclasses.replace(CARD_CONFIG, **fields)
    params = t5.init_params(config, seed=0, device="cpu")
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(3, 24, size=(3, length)))
    mask = torch.ones((3, length), dtype=torch.bool)
    mask[1, length // 2:] = False
    want = t5.T5Encoder(config, params)(ids, mask)
    card = t5.T5Encoder(config, params).to(cuda)
    _plain_on_card(monkeypatch, *plain)
    before = _launches()
    got = card(ids.to(cuda), mask.to(cuda)).cpu()
    assert tuple(b - a for a, b in zip(before, _launches())) == tuple(
        n * config.num_layers for n in launches)
    # two layers of bf16 roundings taken in different places
    assert_bf16_close(got, want, tol=2.0**-5)


@pytest.mark.parametrize("length", [640, 1024])
def test_encode_auto_takes_kernel_i(cuda, monkeypatch, length):
    """At a padded length in (512, blockwise_above] the card's encode
    launches kernel I once a layer, held to I's plain version on the same
    card (swapped in for I's wrapper), ragged rows and a row with no real
    token."""
    params = t5.init_params(CARD_CONFIG, seed=1, device=cuda)
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.randint(3, 24, size=(4, length))).to(cuda)
    mask = torch.ones((4, length), dtype=torch.bool, device=cuda)
    mask[1, length - 77:] = False
    mask[2, 300:] = False
    mask[3] = False
    encoder = t5.T5Encoder(CARD_CONFIG, params)
    kernel_i = short_cuda.short_attention_t5
    before = kernel_i.launches
    got = encoder(ids, mask)
    assert kernel_i.launches - before == CARD_CONFIG.num_layers
    _plain_on_card(monkeypatch, short_cuda)
    before = kernel_i.launches
    want = encoder(ids, mask)
    assert kernel_i.launches == before
    assert_bf16_close(got, want)


def test_fp32_encode_on_card_refused_by_the_kernels(cuda, monkeypatch):
    """An fp32 config, which none of the kernels takes, past
    blockwise_above (L = 1100 > 1024): on the card the encoder hands
    attention to kernel H's wrapper, which refuses it (no launch, no quiet
    plain version); with the wrappers swapped for their plain versions, as
    chip_smoke.py's plain_kernels does, it encodes on the card and matches
    the CPU, ragged rows."""
    config = dataclasses.replace(CARD_CONFIG, dtype=torch.float32)
    params = t5.init_params(config, seed=2, device="cpu")
    rng = np.random.RandomState(6)
    length = 1100
    assert t5.attention_route(config, length) == "H"
    ids = torch.from_numpy(rng.randint(3, 24, size=(3, length)))
    mask = torch.ones((3, length), dtype=torch.bool)
    mask[1, 700:] = False
    mask[2, length - 77:] = False
    want = t5.T5Encoder(config, params)(ids, mask)
    card = t5.T5Encoder(config, params).to(cuda)
    before = _launches()
    with pytest.raises(TypeError, match="kernel H takes bf16"):
        card(ids.to(cuda), mask.to(cuda))
    _plain_on_card(monkeypatch, ffn_cuda, flash_cuda, short_cuda)
    got = card(ids.to(cuda), mask.to(cuda)).cpu()
    assert _launches() == before
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 2.0**-13 * float(want.abs().max()), err
