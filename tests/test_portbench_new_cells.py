"""The benchmark's cells protxlnet.long and pfam20.graph_online: the
readers encoder_mfu.xlnet and relattn_roofline.xlnet hand-computed on a
synthetic traced run, silent where the program's spans lack their counts
(a program before them) or there is no device trace; lib/work.py's new
formulas; and both cells end to end on the CPU at tiny sizes."""

import pytest

from knn_for_homology_tpu_torch.utils.trace import Span
from portbench.lib import harness, program
from portbench.lib import work_xlnet as work
from portbench.lib.record import DeviceTrace
from portbench.tests.tiny import BENCH
from portbench.tests.tiny_xlnet_graph import OVERRIDES

CFG = harness.load_json(harness.BENCH_DIR / "configs" / "protxlnet.json")


def reader(name):
    return harness.load_module(
        harness.BENCH_DIR / "metrics" / f"{name}.py",
        "test_new_" + name.replace(".", "_"))


def batch(rows, padded_len, lengths):
    return {"residues": sum(lengths), "tokens": rows * padded_len,
            "rows": rows, "padded_len": padded_len,
            "residues_sq": sum(n * n for n in lengths)}


# one call of two batches inside the benchmark's "embed" span
BATCHES = [batch(2, 3202, [3096, 2900]), batch(3, 2178, [2000, 1900, 1800])]
SPANS = [Span("embed", -1, 0, 1.0, 3.0, {}),
         Span("embed.batch", 0, 0, 1.1, 2.0, BATCHES[0]),
         Span("embed.relpos", 1, 0, 1.2, 1.21, {}),
         Span("embed.batch", 0, 0, 2.0, 2.9, BATCHES[1])]
KERNELS = [("void knn_xlnet::attention_xlnet_kernel(CUtensorMap_st)", 1.3,
            1.5), ("gemm", 1.5, 1.9),
           ("void knn_xlnet::attention_xlnet_kernel(CUtensorMap_st)", 2.1,
            2.2)]


def synthetic_run(spans=SPANS, kernels=KERNELS, traced=True):
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


def test_xlnet_flops_hand_computed():
    # per residue and layer: 2 x (4 d^2 + 2 d f) + 4 d^2 (R at 2n
    # positions, 2 FLOPs a product); per protein and layer 6 d n^2
    d, f, layers = 1024, 4096, 30
    per_res = layers * (2 * (4 * d * d + 2 * d * f) + 4 * d * d)
    assert work.xlnet_model_flops(10, 100, CFG) == pytest.approx(
        10 * per_res + 6 * d * layers * 100)
    assert work.xlnet_layer_params(CFG) == 4 * d * d + 2 * d * f


def test_relattn_bound_hand_computed():
    ops = 6 * 2 * 16 * 3202**2 * 64
    nbytes = 2 * (4 * 2 * 16 * 3202 * 64 + 2 * 3202 * 16 * 64) + 2 * 3202
    assert work.relattn_bound_s(2, 16, 3202, 64) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))
    assert ops / 989e12 > nbytes / 3.35e12  # bound by the products


def test_readers_hand_computed(recorded):
    run = synthetic_run()
    flops = sum(work.xlnet_model_flops(b["residues"], b["residues_sq"], CFG)
                for b in BATCHES)
    assert reader("encoder_mfu.xlnet").read(run) == pytest.approx(
        100.0 * flops / (4.0 * 989e12))
    bound = 30 * (work.relattn_bound_s(2, 16, 3202, 64)
                  + work.relattn_bound_s(3, 16, 2178, 64))
    assert reader("relattn_roofline.xlnet").read(run) == pytest.approx(
        100.0 * bound / 0.3)


def test_readers_silent_without_their_counts(recorded):
    """A program whose batch spans count residues and tokens only."""
    recorded([s._replace(counts={k: s.counts[k] for k in ("residues",
                                                          "tokens")})
              if s.name == "embed.batch" else s for s in SPANS])
    run = synthetic_run()
    assert reader("encoder_mfu.xlnet").read(run) is None
    assert reader("relattn_roofline.xlnet").read(run) is None


def test_readers_silent_without_trace_or_kernel(recorded):
    assert reader("encoder_mfu.xlnet").read(synthetic_run(traced=False)) \
        is None
    assert reader("relattn_roofline.xlnet").read(
        synthetic_run(traced=False)) is None
    run = synthetic_run(kernels=[("gemm", 1.5, 1.9)])
    assert reader("relattn_roofline.xlnet").read(run) is None
    assert reader("encoder_mfu.xlnet").read(run) is not None


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", ["protxlnet.long", "pfam20.graph_online"])
def test_tiny_run(cell, traced):
    line = harness.run_cell(cell, 2**35 + 3, 0.3, traced, "cpu",
                            overrides=OVERRIDES[cell], bench=BENCH)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    unit = "residues_per_s" if cell.startswith("protxlnet") else \
        "queries_per_s"
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {unit, "setup_s"}


def test_tiny_xlnet_spans_carry_the_counts(monkeypatch):
    runs = []

    class Kept(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    cell = "protxlnet.long"
    harness.run_cell(cell, 2**35 + 5, 0.3, True, "cpu",
                     overrides=OVERRIDES[cell], bench=BENCH)
    spans = program.program_spans(runs[-1])
    batches = [s.counts for s in spans if s.name == "embed.batch"]
    assert batches and all(
        set(c) == {"residues", "tokens", "rows", "padded_len",
                   "residues_sq"} for c in batches)
    encodes = sum(1 for s in spans if s.name == "embed.encode")
    assert sum(1 for s in spans if s.name == "embed.relpos") == encodes
