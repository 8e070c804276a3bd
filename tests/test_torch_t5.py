"""The port's ProtT5 encoder (knn_for_homology_tpu_torch/models/t5.py)
against the JAX package's, on the same numpy weights and tokens. The port
has one route at each length (dense attention up to blockwise_above,
flash above, the fused FFN; on the CPU the plain versions of kernels I, H
and G); it is held to every attention route and both FFN routes of the
JAX package at that length. The JAX side's Pallas kernels run in
interpret mode (its config flags set to True), as its own tests run them.

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
from knn_for_homology_tpu_torch.models.convert import params_to_torch
from knn_for_homology_tpu_torch.ops import ffn_cuda, flash_cuda, short_cuda

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# the JAX package's attention routes: (length, fields of both configs, the
# JAX config's route flags); 100 > blockwise_above = 64 and is not a
# multiple of attention_chunk = 32, so the flash routes see a ragged edge
BLOCKWISE = {"blockwise_above": 64, "attention_chunk": 32}
ROUTES = {
    "dense": (48, {}, {}),
    "short": (48, {}, {"use_short_kernel": True}),
    "flash": (100, BLOCKWISE, {"use_flash_kernel": True}),
    "blockwise": (100, BLOCKWISE, {"use_flash_kernel": False}),
}
# the JAX config's route flags, which the port's config does not have
JAX_ROUTE_FIELDS = {"use_flash_kernel", "use_short_kernel", "short_kernel_max",
                    "use_fused_ffn"}


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
    """The offset table, expanded to [1, H, q_len, k_len] (the bias
    depends only on k - q), equals the JAX package's position_bias."""
    rng = np.random.RandomState(0)
    rel = rng.randn(32, 4).astype(np.float32)
    config_j = dataclasses.replace(jt5.TINY, dtype=jnp.float32)
    for q_len, k_len in ((48, 48), (7, 300)):
        want = np.asarray(jt5.position_bias(jnp.asarray(rel), q_len, k_len, config_j))
        length = max(q_len, k_len)
        table = tt5.offset_bias_table(torch.from_numpy(rel), length,
                                      config_j.rel_buckets,
                                      config_j.rel_max_distance)
        assert table.shape == (4, 2 * length - 1) and table.dtype == torch.float32
        offsets = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
        got = table.numpy()[:, offsets + length - 1][None]
        np.testing.assert_array_equal(got, want)


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
    """The configs equal the JAX package's but for the dtype and the JAX
    package's route flags: the port has one route at each length, and
    checkpoints drop the flags."""
    from knn_for_homology_tpu_torch.models.convert import T5_ROUTE_FIELDS

    assert T5_ROUTE_FIELDS == JAX_ROUTE_FIELDS
    for name in ("PROTT5_XL", "TINY"):
        j, t = dataclasses.asdict(getattr(jt5, name)), dataclasses.asdict(getattr(tt5, name))
        j.pop("dtype"), t.pop("dtype")
        assert JAX_ROUTE_FIELDS <= set(j)
        assert {k: v for k, v in j.items() if k not in JAX_ROUTE_FIELDS} == t
    assert tt5.PROTT5_XL.dtype == torch.bfloat16


def _encode_both(dtype, length, shared, jax_flags, seed=0):
    """(port, JAX) hidden states: `shared` fields set in both configs,
    `jax_flags` (the JAX route flags) in the JAX config only."""
    jdt, tdt = DTYPES[dtype]
    config_j = dataclasses.replace(jt5.TINY, dtype=jdt, **shared, **jax_flags)
    config_t = dataclasses.replace(tt5.TINY, dtype=tdt, **shared)
    params = jt5.init_params(config_j, seed=seed)
    ported = params_to_torch(jax.tree.map(np.asarray, params), "cpu", tdt)
    rng = np.random.RandomState(seed + 1)
    ids = rng.randint(3, 24, size=(3, length)).astype(np.int32)
    mask = np.ones((3, length), dtype=bool)
    mask[1, length // 2:] = False
    mask[2, length - 5:] = False
    want = jt5.encode(params, jnp.asarray(ids), jnp.asarray(mask), config_j)
    got = tt5.T5Encoder(config_t, ported)(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (3, length, config_t.d_model)
    return got.float().numpy(), np.asarray(want, np.float32)


def _encode_cases():
    """(dtype, JAX route, JAX fused flag). In bf16 two JAX routes round
    where the port's one route does not: the dense MLP rounds the FFN's
    output to bf16 before the residual add (G adds in fp32) and the XLA
    blockwise loop keeps p in fp32 (H rounds p to bf16). The port sits
    from them as far as the JAX package's own fused FFN and flash kernel
    do, past this module's bf16 mean bound, so they are held in fp32 only;
    in bf16 the port is held to those twins."""
    for dtype in DTYPES:
        for route in ROUTES:
            for fused, fid in ((True, "fused_ffn"), (False, "dense_ffn")):
                if dtype == "bf16" and (not fused or route == "blockwise"):
                    continue
                yield pytest.param(dtype, route, fused,
                                   id=f"{dtype}-{route}-{fid}")


@pytest.mark.parametrize("dtype,route,fused", list(_encode_cases()))
def test_encode_matches_jax(dtype, route, fused):
    length, shared, jax_flags = ROUTES[route]
    got, want = _encode_both(dtype, length, shared,
                             dict(jax_flags, use_fused_ffn=fused))
    assert_matches(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_short_route_matches_dense_route_and_jax(dtype, monkeypatch):
    """encode() at TINY and L ≤ blockwise_above calls kernel I's wrapper
    (its plain version on the CPU), fed the [H, 2L-1] offset table once a
    layer, and equals both the JAX package's dense route and its
    short-kernel route, within the module's tolerance."""
    tables = []
    real = short_cuda.short_attention_t5

    def spy(q, k, v, mask, table):
        tables.append(tuple(table.shape))
        return real(q, k, v, mask, table)

    monkeypatch.setattr(short_cuda, "short_attention_t5", spy)
    length = 48
    fused = {"use_fused_ffn": True}  # the JAX FFN that rounds as the port's
    port, jax_dense = _encode_both(dtype, length, {}, fused)
    heads = tt5.TINY.num_heads
    assert tables == [(heads, 2 * length - 1)] * tt5.TINY.num_layers
    again, jax_short = _encode_both(dtype, length, {},
                                    dict(fused, use_short_kernel=True))
    np.testing.assert_array_equal(again, port)
    assert_matches(port, jax_dense, dtype)
    assert_matches(port, jax_short, dtype)


def test_auto_flags_resolve_to_the_accelerator_routes(monkeypatch):
    """encode() calls kernel I's wrapper up to blockwise_above, kernel H's
    above it with the plain version's key step attention_chunk, and kernel
    G's for every FFN, whatever the device (on the CPU each wrapper runs
    its plain version)."""
    calls = []
    for mod, name in ((ffn_cuda, "fused_ffn_t5"), (flash_cuda, "flash_attention_t5"),
                      (short_cuda, "short_attention_t5")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, args[0].shape[-2], kw.get("block")))
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    config = dataclasses.replace(tt5.TINY, blockwise_above=64, attention_chunk=32)
    params = tt5.init_params(config, seed=0, device="cpu")
    encoder = tt5.T5Encoder(config, params)
    for length in (40, 100):
        ids = torch.full((2, length), 5)
        encoder(ids, torch.ones((2, length), dtype=torch.bool))
    # second-last dim: L for attention, the 2·L tokens for the FFN
    assert calls == (
        [("short_attention_t5", 40, None), ("fused_ffn_t5", 80, None)]
        * config.num_layers
        + [("flash_attention_t5", 100, 32), ("fused_ffn_t5", 200, None)]
        * config.num_layers)


class KernelReached(Exception):
    """Raised in place of building the kernel library: a wrapper let the
    call through to its kernel."""


CARD_LIKE = tt5.T5Config(vocab_size=32, d_model=256, d_kv=128, d_ff=512,
                         num_layers=2, num_heads=2)
FP32, FP16 = torch.float32, torch.float16


# (config fields, padded L, attention stubbed out, tensor-parallel rank,
# the wrapper that must be reached or the refusal it must raise)
@pytest.mark.parametrize("fields,length,stub,tp,outcome", [
    ({}, 96, False, False, "short_attention_t5"),
    ({"blockwise_above": 64}, 96, False, False, "flash_attention_t5"),
    ({}, 96, True, False, "fused_ffn_t5"),
    ({"dtype": FP32}, 96, False, False, "kernel I takes bf16"),
    ({"dtype": FP32}, 1100, False, False, "kernel H takes bf16"),
    ({"dtype": FP16}, 1100, False, False, "kernel H takes bf16"),
    ({"d_kv": 64}, 96, False, False, "kernel I is built for d_kv 128"),
    ({"blockwise_above": 2048}, 1100, False, False, "kernel I handles L ≤ 1024"),
    ({"dtype": FP32}, 96, True, False, "kernel G takes bf16"),
    ({"d_ff": 1000}, 96, True, False, "kernel G handles"),
    ({"d_ff": 160}, 96, True, True, "kernel G handles"),
], ids=["bf16-i", "bf16-h", "bf16-g", "fp32-i", "fp32-h", "fp16-h", "dkv64-i",
        "past-i-max", "fp32-g", "dff1000-g", "tp-rank-g"])
def test_encode_off_the_cpu_runs_no_plain_version(monkeypatch, fields, length,
                                                  stub, tp, outcome):
    """Off the CPU encode() hands every block to its kernel's wrapper, which
    either reaches the kernel or raises the kernel's limit: a config the
    kernels cannot take is refused, never run on plain versions. Shape-only
    meta tensors stand for the card's; the library build is replaced by
    KernelReached; `stub` replaces attention so that the FFN is reached;
    `tp` runs the blocks as a tensor-parallel rank does."""
    from knn_for_homology_tpu_torch.ops import _build

    def library():
        raise KernelReached

    monkeypatch.setattr(_build, "library", library)
    if stub:
        def empty(q, k, v, mask, table, **kw):
            return torch.empty_like(q)

        monkeypatch.setattr(short_cuda, "short_attention_t5", empty)
        monkeypatch.setattr(flash_cuda, "flash_attention_t5", empty)
    config = dataclasses.replace(CARD_LIKE, **fields)
    params = tt5.T5Encoder(config, tt5.init_params(config, device="cpu")
                           ).to("meta").params()
    ids = torch.zeros((2, length), dtype=torch.long, device="meta")
    mask = torch.ones((2, length), dtype=torch.bool, device="meta")
    reduce = (lambda partial: partial) if tp else None
    if outcome.startswith("kernel "):
        with pytest.raises((TypeError, ValueError), match=outcome):
            tt5.encode(params, ids, mask, config, reduce=reduce)
    else:
        with pytest.raises(KernelReached) as caught:
            tt5.encode(params, ids, mask, config, reduce=reduce)
        assert caught.traceback[-2].name == outcome


XL = tt5.PROTT5_XL


@pytest.mark.parametrize("config,length,route", [
    (XL, 1, "I"),
    (XL, 128, "I"),
    (XL, 512, "I"),
    (XL, 1024, "I"),
    (XL, 1025, "H"),
    (XL, 1152, "H"),
    (XL, 24064, "H"),
    (dataclasses.replace(XL, dtype=FP32), 512, "I"),
    (dataclasses.replace(XL, dtype=FP32), 1152, "H"),
    (dataclasses.replace(XL, dtype=FP16), 1152, "H"),
    (dataclasses.replace(XL, d_kv=64), 512, "I"),
    (dataclasses.replace(XL, d_kv=64), 1152, "H"),
    (tt5.TINY, 48, "I"),
    (dataclasses.replace(XL, blockwise_above=2048), 1100, "I"),
    (dataclasses.replace(XL, blockwise_above=2048), 2049, "H"),
    (dataclasses.replace(XL, blockwise_above=64), 64, "I"),
    (dataclasses.replace(XL, blockwise_above=64), 65, "H"),
], ids=["xl-1", "xl-128", "xl-512", "xl-1024", "xl-1025", "xl-1152",
        "xl-past-h-max", "fp32-512", "fp32-1152", "fp16-1152", "dkv64-512",
        "dkv64-1152", "tiny", "past-i-max", "above-2048", "at-64", "above-64"])
def test_attention_route_rule(config, length, route):
    """Dense attention (kernel I's wrapper) up to blockwise_above, flash
    (kernel H's) above it, by padded length alone: neither the dtype, nor
    the widths, nor a kernel's MAX_LEN choose (past MAX_LEN the wrapper
    refuses the call on the card)."""
    assert tt5.attention_route(config, length) == route


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
