"""The encoder's CUDA kernels (G: fused FFN, H: flash attention, I: short
attention) against their plain PyTorch versions, on the card, and the
encoder on the card against the encoder on the CPU.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_encoder.py

Tolerance: both sides round their result to bf16 once, from fp32 sums taken
in different orders (and p, for H, rounded at different running maxima), so
they may differ by an ulp or two of bf16 (2^-8 relative); every comparison
allows 2^-6 of the reference's largest magnitude (4 ulps there).
"""

import dataclasses

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.models import t5
from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda
from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain
from knn_for_homology_tpu_torch.ops.flash_attention import (
    flash_attention_plain,
    offset_bias_table,
)
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
# limit, and the phase-3 batches (13 x 512, 27 x 256)
@pytest.mark.parametrize("b,h,l", [(1, 2, 1), (2, 3, 63), (2, 2, 64),
                                   (3, 2, 65), (2, 3, 100), (2, 2, 127),
                                   (2, 2, 128), (2, 2, 129), (3, 2, 512),
                                   (13, 32, 512), (27, 32, 256)])
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
    """I fits two blocks per SM at its limit; H one of two warpgroups and a
    producer warp (the CUDA occupancy query)."""
    assert short_cuda.blocks_per_sm(512) >= 2
    assert flash_cuda.blocks_per_sm(3200) >= 1


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


@pytest.mark.parametrize("length,flags", [
    (96, {}),  # dense attention + kernel G
    (96, {"use_short_kernel": True}),  # + kernel I
    (200, {"blockwise_above": 128}),  # kernel H + kernel G
])
def test_encode_on_card_matches_cpu(cuda, length, flags):
    config = dataclasses.replace(CARD_CONFIG, **flags)
    params = t5.init_params(config, seed=0, device="cpu")
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(3, 24, size=(3, length)))
    mask = torch.ones((3, length), dtype=torch.bool)
    mask[1, length // 2:] = False
    want = t5.T5Encoder(config, params)(ids, mask)
    card = t5.T5Encoder(config, params).to(cuda)
    got = card(ids.to(cuda), mask.to(cuda)).cpu()
    # two layers of bf16 roundings taken in different places
    assert_bf16_close(got, want, tol=2.0**-5)
