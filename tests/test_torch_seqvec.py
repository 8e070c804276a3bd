"""SeqVec's serving route (models/elmo.py: bf16, the recurrence on kernel
M's wrapper, whose CPU route is ops/lstm.py) and its step loop against
the plain reference (portbench/reference/seqvec.py, ELMo as AllenNLP
runs it), on seeded weights at bilm-tf's initialisation, over ragged
lengths with 1-residue proteins; SeqVecEmbedder's device pooling against
its host "SeqVec Sum"; the counts its encode span records; and the
finding that the benchmark's initialisation keeps the recurrence stable.
All on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from knn_for_homology_tpu_torch.models import elmo
from knn_for_homology_tpu_torch.models.registry import SeqVecEmbedder
from knn_for_homology_tpu_torch.ops import lstm_cuda
from knn_for_homology_tpu_torch.ops.lstm import lstmp_bidir_plain
from knn_for_homology_tpu_torch.utils import trace
from portbench.drivers.embed_seqvec import elmo_config, seqvec_weights
from portbench.lib import harness
from portbench.reference import seqvec as ref

AAS = "ACDEFGHIKLMNPQRSTVWY"
PUBLISHED = harness.load_json(harness.BENCH_DIR / "configs" / "seqvec.json")
# TINY_ELMO's widths, and a mid size with the published character CNN
TINY = dict(PUBLISHED, char_embed_dim=4, filters=[[1, 8], [2, 8], [3, 16]],
            n_highway=1, proj_dim=16, lstm_dim=32)
MID = dict(PUBLISHED, proj_dim=64, lstm_dim=512)
LENGTHS = (1, 2, 40, 17, 120, 1, 65)
# fp32: the step loop sums in another order than the reference (measured
# 2.9e-7 tiny, 1.7e-6 mid, relative, per residue)
FP32_TOL = 1e-5
# bf16 serving: h rounded to bf16 at every step (2^-9 relative), xw and
# the projection's operand too; measured per residue 5.4e-3 (tiny) and
# 4.8e-3 (mid), pooled 1.6e-3 and 1.7e-3: held at 2^-6 and 2^-7
BF16_RESIDUE_TOL = 2.0**-6
BF16_POOLED_TOL = 2.0**-7


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These runs are thousands of small ops; beside other test workers
    torch's pool of threads spins on the shared cores (a tiny seqvec.mix
    run: 5 s on one thread, 35 s on eight, with seven cores busy)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def sequences(seed, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(AAS), n)) for n in lengths]


def embedder(cfg, dtype, seed=7, max_batch_tokens=512):
    weights = seqvec_weights(cfg, seed, "cpu", dtype)
    config = dataclasses.replace(elmo_config(cfg), dtype=dtype)
    return SeqVecEmbedder(config=config, params=weights,
                          max_batch_tokens=max_batch_tokens,
                          device="cpu"), weights


def widest_residue_err(got, want):
    gap = np.linalg.norm(got - want, axis=-1)
    return float((gap / np.linalg.norm(want, axis=-1)).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_RESIDUE_TOL)],
                         ids=["fp32 step loop", "bf16 on M's plain version"])
@pytest.mark.parametrize("cfg", [TINY, MID], ids=["tiny", "mid"])
def test_encode_equals_reference(cfg, dtype, tol):
    emb, weights = embedder(cfg, dtype)
    seqs = sequences(1)
    for seq, got in zip(seqs, emb.embed_per_residue(seqs)):
        want = ref.run(weights, seq, cfg)[0].numpy()
        assert got.shape == want.shape == (3, len(seq), 2 * cfg["proj_dim"])
        assert widest_residue_err(got, want) < tol, seq


@pytest.mark.parametrize("cfg", [TINY, MID], ids=["tiny", "mid"])
def test_pooled_equals_reference(cfg):
    emb, weights = embedder(cfg, torch.bfloat16)
    seqs = sequences(2)
    got = emb.embed_pooled(seqs)
    want = ref.pooled(weights, seqs, cfg).numpy()
    gap = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert gap.max() < BF16_POOLED_TOL


@pytest.mark.parametrize("fault", ["backward output not re-aligned",
                                   "row retired a step early",
                                   "last residue's step dropped"])
def test_faults_fail_the_tolerance(fault, monkeypatch):
    """The comparison sees where the backward direction's outputs land, a
    row's length and its last residue's step."""
    cfg = MID
    emb, weights = embedder(cfg, torch.bfloat16)
    real = lstm_cuda.lstmp_bidir

    def broken(xw, weights, lengths, cell_clip, proj_clip):
        p = weights.w_proj[0].shape[1]
        if fault == "row retired a step early":
            lengths = [n - 1 for n in lengths]
        out = real(xw, weights, lengths, cell_clip, proj_clip)
        for r, n in enumerate(lengths):
            if fault == "backward output not re-aligned":
                out[r, :n, p:] = out[r, :n, p:].flip(0)
            if fault == "last residue's step dropped":
                out[r, n - 2, :p] = 0  # n - 1 holds </S>
        return out

    monkeypatch.setattr(lstm_cuda, "lstmp_bidir", broken)
    seqs = sequences(3, (40, 17, 120, 65))
    worst = 0.0
    for seq, got in zip(seqs, emb.embed_per_residue(seqs)):
        want = ref.run(weights, seq, cfg)[0].numpy()
        worst = max(worst, widest_residue_err(got, want))
    assert worst > 4 * BF16_RESIDUE_TOL


@pytest.mark.parametrize("lengths", [[5, 1, 3], [1], [9, 9, 0, 4]])
def test_plain_recurrence_equals_reference_lstm(lengths):
    """M's plain version in fp32 against the reference's LSTMP, each row
    alone: forward over the row, backward over its own positions reversed,
    nothing past its length."""
    cfg = TINY
    weights = seqvec_weights(cfg, 11, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(12)
    b, steps, p = len(lengths), max(lengths) + 2, cfg["proj_dim"]
    x = torch.randn((b, steps, p), generator=gen)
    cells = (weights["lstm_fwd"][0], weights["lstm_bwd"][0])
    xw = torch.stack([x @ c["w_x"] + c["b"] for c in cells])
    got = lstmp_bidir_plain(xw, [c["w_h"] for c in cells],
                            [c["w_proj"] for c in cells],
                            torch.tensor(lengths), 3.0, 3.0)
    for r, n in enumerate(lengths):
        fwd = ref.lstmp(x[r, :n], cells[0], cfg) if n else x[r, :0, :p]
        bwd = ref.lstmp(x[r, :n].flip(0), cells[1], cfg).flip(0) if n \
            else x[r, :0, :p]
        want = torch.cat([fwd, bwd], dim=-1)
        torch.testing.assert_close(got[r, :n], want, rtol=0, atol=1e-6)
        assert not got[r, n:].any()


def test_device_pooled_equals_host_sum():
    """embed_pooled (pooled on the device) gives the host path's "SeqVec
    Sum": the per-layer means summed."""
    emb, _ = embedder(TINY, torch.bfloat16, max_batch_tokens=128)
    seqs = sequences(4)
    got = emb.embed_pooled(seqs)
    want = emb.embed_layer_variants(seqs)["SeqVec Sum"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_encode_span_counts_the_recurrence(monkeypatch):
    """Each batch's embed.encode span counts kernel M's launches and the
    serial steps they ran; here the CPU route is counted as if it were the
    kernel (the counters are the kernel's)."""
    real = lstm_cuda.lstmp_bidir

    def counted(xw, weights, lengths, *clips):
        counted.launches += 1
        counted.steps += max(lengths)
        return real(xw, weights, lengths, *clips)

    counted.launches = counted.steps = 0
    monkeypatch.setattr(lstm_cuda, "lstmp_bidir", counted)
    monkeypatch.setattr(
        SeqVecEmbedder, "launch_counts",
        lambda self: {"lstm_launches": counted.launches,
                      "lstm_steps": counted.steps})
    emb, _ = embedder(TINY, torch.bfloat16, max_batch_tokens=96)
    seqs = sequences(5)
    batches = emb.batches(seqs)
    trace.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        emb.embed_pooled(seqs)
    spans = trace.spans()
    encodes = [s.counts for s in spans if s.name == "embed.encode"]
    assert [c["lstm_launches"] for c in encodes] == [2] * len(batches)
    assert [c["lstm_steps"] for c in encodes] == [
        2 * (max(len(s) for s in b.sequences) + 2) for b in batches]
    names = [s.name for s in spans]
    assert names.count("embed.lstm") == names.count("embed.lstm_input") \
        == 2 * len(batches)


def test_kernel_wrapper_refuses_mismatched_shapes():
    xw = torch.zeros((2, 3, 5, 64), dtype=torch.bfloat16)
    w_h = [torch.zeros((16, 64), dtype=torch.bfloat16)] * 2
    w_p = [torch.zeros((8, 16), dtype=torch.bfloat16)] * 2
    with pytest.raises(ValueError):
        lstm_cuda.lstmp_weights(w_h, w_p)
    w_p = [torch.zeros((16, 16), dtype=torch.bfloat16)] * 2
    weights = lstm_cuda.lstmp_weights(w_h, w_p)
    with pytest.raises(ValueError):
        lstm_cuda.lstmp_bidir(xw[0], weights, [5, 1, 2], 3.0, 3.0)
    with pytest.raises(ValueError):
        lstm_cuda.lstmp_bidir(xw, weights, [5, 1], 3.0, 3.0)
    with pytest.raises(ValueError):  # xw's gates are not W_h's
        lstm_cuda.lstmp_bidir(xw[..., :32], weights, [5, 1, 2], 3.0, 3.0)


def test_fp32_route_equals_the_kernel_route_on_the_cpu():
    """The fp32 route calls the step loop itself; the bf16 route reaches
    it through kernel M's wrapper, which on CPU tensors runs it: on fp32
    weights the two give the same outputs."""
    weights = seqvec_weights(TINY, 14, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(15)
    xw = torch.randn((2, 3, 9, 4 * TINY["lstm_dim"]), generator=gen)
    rec = lstm_cuda.lstmp_weights(
        [weights[s][0]["w_h"] for s in ("lstm_fwd", "lstm_bwd")],
        [weights[s][0]["w_proj"] for s in ("lstm_fwd", "lstm_bwd")])
    assert rec.packed is None  # nothing is packed off the card
    got = lstm_cuda.lstmp_bidir(xw, rec, [9, 1, 4], 3.0, 3.0)
    want = lstmp_bidir_plain(xw, rec.w_h, rec.w_proj, torch.tensor([9, 1, 4]),
                             3.0, 3.0)
    assert torch.equal(got, want)


def test_benchmark_initialisation_is_not_chaotic():
    """At the configuration's initialisation (bilm-tf's Glorot-uniform
    LSTM kernels), a one-ulp change of every LSTM weight moves the fp32
    reference's LSTM2 output by under 1e-5 over 512 steps, at the
    published widths. (At elmo.init_params' normal x 0.1 the same change
    grows with the length: elmo.init_params' docstring.)"""
    cfg = PUBLISHED
    weights = seqvec_weights(cfg, 13, "cpu", torch.float32)
    nudged = dict(weights)  # the same tree but for the LSTMs
    nudged["lstm_fwd"], nudged["lstm_bwd"] = (
        [{k: torch.nextafter(v, torch.full_like(v, float("inf")))
          if k != "b" else v for k, v in cell.items()}
         for cell in weights[side]] for side in ("lstm_fwd", "lstm_bwd"))
    seq = sequences(6, (510,))[0]  # 512 steps with <S> and </S>
    want = ref.run(weights, seq, cfg)[1][1]
    got = ref.run(nudged, seq, cfg)[1][1]
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap < 1e-5, gap
