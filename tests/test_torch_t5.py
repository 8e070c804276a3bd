"""The port's ProtT5 encoder (knn_for_homology_tpu_torch/models/t5.py)
against the JAX package's, on the same numpy weights and tokens, on every
attention route and both FFN routes. The JAX side's Pallas kernels run in
interpret mode (the config flags set to True), as its own tests run them.

Tolerances:
  * fp32 configs test the algorithm: |port - jax| ≤ 1e-5 (hidden states of
    magnitude ≤ 4 after two layers; fp32 sums in other orders and other
    exp/log/rsqrt implementations stay within a few fp32 ulps);
  * bf16 configs test the model dtype: each side rounds to bf16 at the same
    places but from fp32 values that differ in the last bits, so a rounding
    may flip by one bf16 ulp and propagate. Allowed: max difference ≤ 2^-5
    of the largest |value| (4 bf16 ulps there), mean ≤ 2^-10 of it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_for_homology_tpu.models import t5 as jt5
from knn_for_homology_tpu_torch.models import t5 as tt5
from knn_for_homology_tpu_torch.models.convert import params_from_jax

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# attention routes: (length, flags); 100 > blockwise_above = 64 and is not a
# multiple of attention_chunk = 32, so the blockwise routes see a ragged edge
ROUTES = {
    "dense": (48, {}),
    "short": (48, {"use_short_kernel": True}),
    "flash": (100, {"blockwise_above": 64, "attention_chunk": 32,
                    "use_flash_kernel": True}),
    "blockwise": (100, {"blockwise_above": 64, "attention_chunk": 32,
                        "use_flash_kernel": False}),
}


def assert_matches(got: np.ndarray, want: np.ndarray, dtype: str):
    err = np.abs(got.astype(np.float32) - want.astype(np.float32))
    if dtype == "fp32":
        assert err.max() <= 1e-5, err.max()
    else:
        scale = np.abs(want.astype(np.float32)).max()
        assert err.max() <= 2.0**-5 * scale, (err.max(), scale)
        assert err.mean() <= 2.0**-10 * scale, (err.mean(), scale)


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64), (32, 256)])
def test_relative_position_bucket_integer_equal(num_buckets, max_distance):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    want = np.asarray(
        jt5.relative_position_bucket(jnp.asarray(rel), num_buckets, max_distance)
    )
    got = tt5.relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_position_bias_equal():
    rng = np.random.RandomState(0)
    rel = rng.randn(32, 4).astype(np.float32)
    config_j = dataclasses.replace(jt5.TINY, dtype=jnp.float32)
    config_t = dataclasses.replace(tt5.TINY, dtype=torch.float32)
    for q_len, k_len in ((48, 48), (7, 300)):
        want = np.asarray(jt5.position_bias(jnp.asarray(rel), q_len, k_len, config_j))
        got = tt5.position_bias(torch.from_numpy(rel), q_len, k_len, config_t)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm_equal(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    x = rng.randn(5, 64).astype(np.float32) * 3
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    want = jt5.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt), 1e-6)
    got = tt5.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale).to(tdt), 1e-6)
    # fp32: other rsqrt and mean implementations; bf16: both round the same
    # fp32 value, so equal but for a rare one-ulp flip
    assert_matches(got.float().numpy(), np.asarray(want, np.float32), dtype)
    if dtype == "bf16":
        assert (got.float().numpy() != np.asarray(want, np.float32)).mean() < 0.01


def test_tokenize_equal():
    vocab = {aa: 3 + i for i, aa in enumerate("WYVTSRQPNMLKIHGFEDCA")}
    vocab["X"] = 23
    for seq in ("MKTAYIAKQR", "mktayiakqr", "UZOBX", "ACDE*J-.", ""):
        np.testing.assert_array_equal(tt5.tokenize(seq), jt5.tokenize(seq))
        np.testing.assert_array_equal(
            tt5.tokenize(seq, vocab), jt5.tokenize(seq, vocab)
        )
    assert tt5.PROTT5_VOCAB == jt5.PROTT5_VOCAB
    assert (tt5.PAD_ID, tt5.EOS_ID, tt5.UNK_ID) == (jt5.PAD_ID, jt5.EOS_ID, jt5.UNK_ID)


def test_configs_match():
    for name in ("PROTT5_XL", "TINY"):
        j, t = dataclasses.asdict(getattr(jt5, name)), dataclasses.asdict(getattr(tt5, name))
        j.pop("dtype"), t.pop("dtype")
        assert j == t
    assert tt5.PROTT5_XL.dtype == torch.bfloat16


def _encode_both(dtype, length, fused, flags, seed=0):
    jdt, tdt = DTYPES[dtype]
    flags = dict(flags, use_fused_ffn=fused)
    config_j = dataclasses.replace(jt5.TINY, dtype=jdt, **flags)
    config_t = dataclasses.replace(tt5.TINY, dtype=tdt, **flags)
    params = jt5.init_params(config_j, seed=seed)
    ported = params_from_jax(jax.tree.map(np.asarray, params), tdt, "cpu")
    rng = np.random.RandomState(seed + 1)
    ids = rng.randint(3, 24, size=(3, length)).astype(np.int32)
    mask = np.ones((3, length), dtype=bool)
    mask[1, length // 2:] = False
    mask[2, length - 5:] = False
    want = jt5.encode(params, jnp.asarray(ids), jnp.asarray(mask), config_j)
    got = tt5.T5Encoder(config_t, ported)(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (3, length, config_t.d_model)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ffn", "dense_ffn"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_matches_jax(dtype, route, fused):
    length, flags = ROUTES[route]
    got, want = _encode_both(dtype, length, fused, flags)
    assert_matches(got, want, dtype)


def test_auto_flags_resolve_to_the_accelerator_routes(monkeypatch):
    """"auto" takes the fused FFN and, above blockwise_above, the flash
    route; the short kernel stays off."""
    from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda

    calls = []
    for mod, name in ((ffn_cuda, "fused_ffn_t5"), (flash_cuda, "flash_attention_t5"),
                      (short_cuda, "short_attention_t5")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    config = dataclasses.replace(tt5.TINY, blockwise_above=64, attention_chunk=32)
    params = tt5.init_params(config, seed=0, device="cpu")
    encoder = tt5.T5Encoder(config, params)
    for length in (40, 100):
        ids = torch.full((2, length), 5)
        encoder(ids, torch.ones((2, length), dtype=torch.bool))
    layers = config.num_layers
    assert calls.count("fused_ffn_t5") == 2 * layers
    assert calls.count("flash_attention_t5") == layers
    assert "short_attention_t5" not in calls


def test_init_params_scales_and_generator():
    config = dataclasses.replace(tt5.TINY, d_ff=4096)
    a = tt5.init_params(config, seed=3, device="cpu")
    b = tt5.init_params(config, seed=3, device="cpu")
    torch.testing.assert_close(a["layers"][1]["mlp"]["wo"], b["layers"][1]["mlp"]["wo"],
                               rtol=0, atol=0)
    wi = a["layers"][0]["mlp"]["wi"].float()
    assert wi.dtype == torch.float32 and a["embedding"].dtype == torch.bfloat16
    assert abs(float(wi.std()) - config.d_model**-0.5) < 0.01 * config.d_model**-0.5 * 10
    assert abs(float(a["rel_embedding"].float().std()) - 0.1) < 0.05
    assert torch.equal(a["final_ln"], torch.ones(config.d_model, dtype=torch.bfloat16))
