"""The benchmark's cells seqvec.mix and pfam20.db_sharded: the readers
encoder_mfu.seqvec, lstm_roofline.seqvec and lstm_step_us.seqvec
hand-computed on a synthetic traced run and silent where the program's
spans lack their counts or there is no device trace; lib/work_seqvec.py's
formulas; both cells end to end on the CPU at tiny sizes (the sharded one
over two gloo ranks), a fault in each making `correct` false, and each
control failing a limit."""

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.utils.trace import Span
from portbench.lib import harness, program
from portbench.lib import work_seqvec as work
from portbench.lib.record import DeviceTrace
from portbench.tests.tiny import BENCH
from portbench.tests.tiny_seqvec_sharded import OVERRIDES

CFG = harness.load_json(harness.BENCH_DIR / "configs" / "seqvec.json")
KERNEL = "knn_lstm::lstmp_bidir_kernel(__nv_bfloat16 const*, uint4 const*)"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These runs are thousands of small ops; beside other test workers
    torch's pool of threads spins on the shared cores (a tiny seqvec.mix
    run: 5 s on one thread, 35 s on eight, with seven cores busy)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reader(name):
    return harness.load_module(
        harness.BENCH_DIR / "metrics" / f"{name}.py",
        "test_seqvec_" + name.replace(".", "_"))


def batch(lengths, padded_len):
    return {"residues": sum(lengths), "tokens": len(lengths) * padded_len,
            "rows": len(lengths), "padded_len": padded_len,
            "residues_sq": sum(n * n for n in lengths)}


BATCHES = [batch([1614, 900], 1632), batch([300, 290, 280], 320)]
SPANS = [Span("embed", -1, 0, 1.0, 3.0, {}),
         Span("embed.batch", 0, 0, 1.1, 2.0, BATCHES[0]),
         Span("embed.encode", 1, 0, 1.2, 1.9,
              {"lstm_launches": 2, "lstm_steps": 2 * 1616}),
         Span("embed.batch", 0, 0, 2.0, 2.9, BATCHES[1]),
         Span("embed.encode", 1, 0, 2.1, 2.8,
              {"lstm_launches": 2, "lstm_steps": 2 * 302})]
KERNELS = [(KERNEL, 1.3, 1.5), ("gemm", 1.5, 1.6), (KERNEL, 1.6, 1.8),
           (KERNEL, 2.2, 2.3), (KERNEL, 2.3, 2.4)]


def synthetic_run(kernels=KERNELS, traced=True):
    trace = DeviceTrace(kernels=list(kernels), copies=[],
                        spans=[("window", 0.0, 4.0), ("embed", 1.0, 3.0)],
                        window=(0.0, 4.0)) if traced else None
    return harness.Run("synthetic", {}, CFG, [], (0.0, 4.0), 1.0, trace)


@pytest.fixture
def recorded(monkeypatch):
    def use(spans):
        monkeypatch.setattr(program, "recorded_spans", lambda: spans)
    use(SPANS)
    return use


def test_seqvec_flops_hand_computed():
    # a scan: 2 FLOPs a weight of x.W_x, h.W_h (512 x 16384 each) and the
    # projection (4096 x 512); 4 scans a residue
    per_scan = 2 * (2 * 512 * 16384 + 4096 * 512)
    assert work.seqvec_model_flops(10, CFG) == pytest.approx(
        10 * 4 * per_scan)
    assert per_scan == pytest.approx(37.7e6, rel=2e-3)


def test_lstm_bound_hand_computed():
    rows, residues = 3, 870
    positions = residues + 2 * rows
    recurrent = 512 * 16384 + 4096 * 512
    ops = 2 * positions * 2 * recurrent
    nbytes = 2 * (2 * recurrent + 2 * positions * (16384 + 512))
    assert work.lstm_launch_bound_s(rows, residues, CFG) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))
    assert ops / 989e12 > nbytes / 3.35e12  # bound by the products


def test_readers_hand_computed(recorded):
    run = synthetic_run()
    flops = sum(work.seqvec_model_flops(b["residues"], CFG) for b in BATCHES)
    assert reader("encoder_mfu.seqvec").read(run) == pytest.approx(
        100.0 * flops / (4.0 * 989e12))
    bound = 2 * sum(work.lstm_launch_bound_s(b["rows"], b["residues"], CFG)
                    for b in BATCHES)
    assert reader("lstm_roofline.seqvec").read(run) == pytest.approx(
        100.0 * bound / 0.6)
    assert reader("lstm_step_us.seqvec").read(run) == pytest.approx(
        1e6 * 0.6 / (2 * 1616 + 2 * 302))


def test_readers_silent_without_their_counts(recorded):
    """A program whose encode spans count no recurrence (the parent's)."""
    recorded([s._replace(counts={"short_launches": 0})
              if s.name == "embed.encode" else s for s in SPANS])
    run = synthetic_run()
    assert reader("lstm_roofline.seqvec").read(run) is None
    assert reader("lstm_step_us.seqvec").read(run) is None
    assert reader("encoder_mfu.seqvec").read(run) is not None


@pytest.mark.parametrize("name", ["encoder_mfu.seqvec",
                                  "lstm_roofline.seqvec",
                                  "lstm_step_us.seqvec"])
def test_readers_silent_without_trace_or_kernel(recorded, name):
    assert reader(name).read(synthetic_run(traced=False)) is None
    if name != "encoder_mfu.seqvec":
        assert reader(name).read(synthetic_run(kernels=[("gemm", 1.5, 1.9)])
                                 ) is None


@pytest.mark.parametrize("rows", [1, 10, 16, 17, 56])
def test_checked_rows_span_every_m_tile(rows):
    from portbench.drivers import embed_seqvec

    got = embed_seqvec.checked_rows(rows, np.random.default_rng(rows))
    assert got == sorted(set(got)) and got[0] == 0 and got[-1] == rows - 1
    for tile in range(0, rows, embed_seqvec.TILE):
        assert any(tile <= r < tile + embed_seqvec.TILE for r in got)


def run_tiny(cell, traced=False, patch=None, control=False, seed=2**35 + 7):
    return harness.run_cell(cell, seed, 0.3, traced, "cpu",
                            overrides=OVERRIDES[cell], bench=BENCH,
                            patch=patch, control=control)


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", ["seqvec.mix", "pfam20.db_sharded"])
def test_tiny_run(cell, traced):
    line = run_tiny(cell, traced)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    unit = "residues_per_s" if cell.startswith("seqvec") else "queries_per_s"
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {unit, "setup_s"}


@pytest.mark.parametrize("cell", ["seqvec.mix", "pfam20.db_sharded"])
def test_control_fails_a_limit(cell):
    line = run_tiny(cell, control=True)
    assert line["correct"] is True, line["checks"]
    assert any(line["control"][k] > c["limit"]
               for k, c in line["checks"].items()), line["control"]


def alter_pooled(driver):
    from knn_for_homology_tpu_torch.models.registry import SeqVecEmbedder

    real = SeqVecEmbedder.embed_pooled

    def altered(self, seqs):
        out = real(self, seqs)
        longest = int(np.argmax([len(s) for s in seqs]))
        out[longest] = out[longest] * 1.1
        return out

    SeqVecEmbedder.embed_pooled = altered


def shift_recurrence(driver):
    """The window's encode with kernel M's output a position late."""
    from knn_for_homology_tpu_torch.ops import lstm_cuda

    real = lstm_cuda.lstmp_bidir

    def late(*args):
        out = real(*args)
        out[:, 1:] = out[:, :-1].clone()
        return out

    late.launches, late.steps = real.launches, real.steps
    lstm_cuda.lstmp_bidir = late


def alter_late_rows(driver):
    """The window's encode with kernel M's output off at the rows past its
    first m-tile (sorted rows 16 on) of every launch that has them."""
    from knn_for_homology_tpu_torch.ops import lstm_cuda

    real = lstm_cuda.lstmp_bidir

    def late_rows(*args):
        out = real(*args)
        out[16:] = out[16:] * 1.1  # a batch's rows are sorted, as M's
        return out

    late_rows.launches, late_rows.steps = real.launches, real.steps
    lstm_cuda.lstmp_bidir = late_rows


def alter_shortest(driver):
    """The pooled vector of each call's shortest protein altered."""
    from knn_for_homology_tpu_torch.models.registry import SeqVecEmbedder

    real = SeqVecEmbedder.embed_pooled

    def altered(self, seqs):
        out = real(self, seqs)
        shortest = int(np.argmin([len(s) for s in seqs]))
        out[shortest] = out[shortest] * 1.1
        return out

    SeqVecEmbedder.embed_pooled = altered


def alter_ids(driver):
    real = driver.search

    def altered(state, i):  # rank 0's host arrays
        vals, ids = real(state, i)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % (state["world"] * state["rows"])
        return vals, ids

    driver.search = altered


def drop_half(driver):
    real = driver.search

    def half(state, i):  # rank 0's host arrays
        vals, ids = real(state, i)
        ids = ids.copy()
        ids[:, ids.shape[1] // 2:] = ids[:, :1]
        return vals, ids

    driver.search = half


@pytest.mark.parametrize("cell,fault", [
    ("seqvec.mix", alter_pooled), ("seqvec.mix", shift_recurrence),
    ("seqvec.mix", alter_late_rows), ("seqvec.mix", alter_shortest),
    ("pfam20.db_sharded", alter_ids), ("pfam20.db_sharded", drop_half)],
    ids=["pooled altered", "recurrence a step late",
         "rows past the first m-tile altered", "shortest pooled altered",
         "ids altered", "half the hits dropped"])
def test_fault_makes_the_run_incorrect(cell, fault):
    from knn_for_homology_tpu_torch.models.registry import SeqVecEmbedder
    from knn_for_homology_tpu_torch.ops import lstm_cuda

    embed, recur = SeqVecEmbedder.embed_pooled, lstm_cuda.lstmp_bidir
    try:
        line = run_tiny(cell, patch=fault)
    finally:
        SeqVecEmbedder.embed_pooled, lstm_cuda.lstmp_bidir = embed, recur
    assert line["correct"] is False, line["checks"]
