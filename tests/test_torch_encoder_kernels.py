"""Plain versions of kernels G, H and I (the port's ops/ffn.py,
ops/flash_attention.py, ops/short_attention.py) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs: an uneven
length, a padded token count, a ragged mask and a row with every key
masked. Also H's offset-bias table against the Toeplitz bias blocks.

Tolerances: fp32 inputs test the algorithm, |port - jax| ≤ 1e-5 (values of
order 1, fp32 sums in other orders). bf16 inputs test the model dtype: both
sides round to bf16 once at the end (and G's h and H's p in between) from
fp32 values that may differ in the last bits, so they may differ by a bf16
ulp: max difference ≤ 2^-6 of the largest |value| (2 ulps there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.ops.ffn_pallas import fused_ffn_t5
from knn_for_homology_tpu.ops.flash_attention import (
    flash_attention_t5,
    toeplitz_bias_blocks,
)
from knn_for_homology_tpu.ops.short_attention import short_attention_t5
from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda
from knn_for_homology_tpu_torch.ops.ffn import fused_ffn_plain
from knn_for_homology_tpu_torch.ops.flash_attention import (
    flash_attention_plain,
    offset_bias_table,
)
from knn_for_homology_tpu_torch.ops.short_attention import short_attention_plain

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def both(arr, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


def assert_matches(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    if dtype == "fp32":
        assert err <= 1e-5, err
    else:
        assert err <= 2.0**-6 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("tokens", [37, 300], ids=["one_tile", "padded"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_ffn_plain_matches_pallas(dtype, tokens):
    rng = np.random.RandomState(0)
    d, f = 64, 256
    x = (rng.randn(tokens, d) * 2).astype(np.float32)
    ln = (rng.rand(d) + 0.5).astype(np.float32)
    wi = (rng.randn(d, f) / np.sqrt(d)).astype(np.float32)
    wo = (rng.randn(f, d) / np.sqrt(f)).astype(np.float32)
    (jx, tx), (jl, tl), (jwi, twi), (jwo, two) = (
        both(a, dtype) for a in (x, ln, wi, wo)
    )
    # bm = 256 pads 300 tokens to 512 inside the Pallas call; bf = 128
    # gives it two d_ff steps
    want = fused_ffn_t5(jx, jl, jwi, jwo, eps=1e-6, bf=128, interpret=True)
    got = ffn_cuda.fused_ffn_t5(tx, tl, twi, two, eps=1e-6)
    assert_matches(got, want, dtype)
    assert_matches(fused_ffn_plain(tx, tl, twi, two), want, dtype)


def _attention_inputs(seed, b, h, l, dk, dtype):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, l, dk).astype(np.float32) * 0.5 for _ in range(3))
    mask = np.ones((b, l), dtype=bool)
    mask[0, l - 9:] = False
    mask[-1] = False  # a row with every key masked
    rel = (rng.randn(32, h) * 0.5).astype(np.float32)
    return (*(both(a, dtype) for a in (q, k, v)), mask, rel)


@pytest.mark.parametrize("length", [100, 128], ids=["uneven", "even"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_pallas(dtype, length):
    (jq, tq), (jk, tk), (jv, tv), mask, rel = _attention_inputs(1, 3, 2, length, 16, dtype)
    want = flash_attention_t5(
        jq, jk, jv, jnp.asarray(mask), jnp.asarray(rel, DTYPES[dtype][0]),
        block=32, interpret=True,
    )
    table = offset_bias_table(torch.from_numpy(rel).to(DTYPES[dtype][1]), length, 32, 128)
    got = flash_cuda.flash_attention_t5(tq, tk, tv, torch.from_numpy(mask), table, block=32)
    assert_matches(got, want, dtype)
    # no real key: zeros, as the Pallas kernel gives
    assert not got[-1].float().abs().any()
    # the plain version's result does not depend on its key step
    other = flash_attention_plain(tq, tk, tv, torch.from_numpy(mask), table, block=48)
    assert_matches(other, want, dtype)


@pytest.mark.parametrize("length", [100, 128], ids=["uneven", "even"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_short_plain_matches_pallas(dtype, length):
    from knn_for_homology_tpu_torch.models import t5

    (jq, tq), (jk, tk), (jv, tv), mask, rel = _attention_inputs(2, 3, 2, length, 16, dtype)
    if length % 128:
        # the Pallas call pads L to 128 with masked keys, which an all-masked
        # row would average over; the port (like models/t5.py:_attention)
        # averages over the L keys, so this case keeps one real key
        mask[-1, 0] = True
    bias = t5.position_bias(
        torch.from_numpy(rel), length, length, t5.T5Config(num_heads=2)
    )[0]
    want = short_attention_t5(jq, jk, jv, jnp.asarray(mask),
                              jnp.asarray(bias.numpy()), interpret=True)
    got = short_cuda.short_attention_t5(tq, tk, tv, torch.from_numpy(mask), bias)
    assert_matches(got, want, dtype)
    assert_matches(short_attention_plain(tq, tk, tv, torch.from_numpy(mask), bias),
                   want, dtype)


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 40)])
def test_offset_table_matches_toeplitz_blocks(num_buckets, max_distance):
    rng = np.random.RandomState(3)
    heads, block, n_blocks = 3, 32, 5
    rel = rng.randn(num_buckets, heads).astype(np.float32)
    blocks = np.asarray(toeplitz_bias_blocks(
        jnp.asarray(rel), n_blocks, n_blocks, block, num_buckets, max_distance
    ))  # [n_rel, H, block, block], r = kj - qi + n_blocks - 1
    length = n_blocks * block
    table = offset_bias_table(torch.from_numpy(rel), length, num_buckets, max_distance)
    assert table.shape == (heads, 2 * length - 1) and table.dtype == torch.float32
    qpos = np.arange(length)[:, None]
    kpos = np.arange(length)[None, :]
    dense = table.numpy()[:, kpos - qpos + length - 1]  # [H, L, L]
    for qi in range(n_blocks):
        for kj in range(n_blocks):
            np.testing.assert_array_equal(
                dense[:, qi * block:(qi + 1) * block, kj * block:(kj + 1) * block],
                blocks[kj - qi + n_blocks - 1],
            )


def test_kernel_wrappers_check_shapes():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ffn_cuda.fused_ffn_t5(x, torch.ones(8), torch.zeros(8, 16), torch.zeros(8, 16))
    q = torch.zeros(1, 2, 5, 4)
    with pytest.raises(ValueError):
        flash_cuda.flash_attention_t5(q, q, q, torch.ones(1, 5, dtype=torch.bool),
                                      torch.zeros(2, 8))
    with pytest.raises(ValueError):
        short_cuda.short_attention_t5(q, q, q, torch.ones(1, 5), torch.zeros(2, 5, 5))
