"""The frozen operation, byte and FLOP counts on small shapes, and at the
shapes whose bounds PERF.md's kernel table quotes."""

import math

import pytest

from portbench.lib import peaks, work

PROTT5 = {"d_model": 1024, "d_kv": 128, "d_ff": 16384, "num_layers": 24,
          "num_heads": 32}


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(989e12, "bf16", 0) == pytest.approx(1.0)
    assert peaks.bound_s(1, "bf16", 3.35e12) == pytest.approx(1.0)
    assert peaks.PEAK_OPS["int32"] == 132 * 64 * 1980e6


def test_t5_counts_small():
    cfg = {"d_model": 4, "d_kv": 2, "d_ff": 8, "num_layers": 3,
           "num_heads": 2}
    # q, k, v, o: 4 x 4 x 4; wi, wo: 2 x 4 x 8
    assert work.t5_layer_params(cfg) == 4 * 4 * 4 + 2 * 4 * 8
    per_res = 2 * 3 * (64 + 64)
    attn = 4 * 2 * 2 * 3
    assert work.t5_model_flops([5, 7], cfg) == \
        5 * per_res + attn * 25 + 7 * per_res + attn * 49


def test_prott5_parameters_and_ffn_bound():
    assert 24 * work.t5_layer_params(PROTT5) == 1_207_959_552  # 1.208 B
    # kernel G at T = 7000: 0.475 ms, bound by operations (PERF.md §6)
    assert work.ffn_bound_s(7000, 1024, 16384) * 1e3 == \
        pytest.approx(0.4749, abs=1e-4)


def test_attention_bound():
    # kernel H, 2 x 32 heads x L 3200 x 128: 0.339 ms (PERF.md §6)
    assert work.attention_bound_s(2, 32, 3200, 128) * 1e3 == \
        pytest.approx(0.339, abs=1e-3)
    b, h, l, d = 1, 1, 4, 2
    ops = 4 * b * h * l * l * d
    nbytes = 2 * 4 * l * d + l + 4 * (2 * l - 1)
    assert work.attention_bound_s(b, h, l, d) == \
        max(ops / 989e12, nbytes / 3.35e12)


def test_int8_search_bound():
    # kernel F, 1024 queries x 131072 x 1024: 0.139 ms (PERF.md §6)
    assert work.int8_search_bound_s(1024, 131072, 1024, 0) * 1e3 == \
        pytest.approx(0.139, abs=1e-3)
    assert work.int8_search_bound_s(2, 3, 4, 5) == max(
        2 * 2 * 3 * 4 / 1979e12, ((2 + 3) * 8 + 2 * 5 * 8) / 3.35e12)


def test_sw_bound():
    assert work.sw_bound_s(1000) == 1000 * 10 / (132 * 64 * 1980e6)
    assert math.isclose(work.sw_bound_s(2.488e9) * 1e3, 1.488, rel_tol=1e-3)
