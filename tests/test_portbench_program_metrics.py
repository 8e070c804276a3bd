"""The benchmark's readers of the program's spans (portbench/lib/program.py
and the metrics pad_efficiency.embedder, prep_idle_share.embed,
dispatch_idle_share.embed, copy_gbps.allvsall, short_attention_roofline):
hand-computed values on a synthetic trace, the split of an idle gap
between spans, the clock check, no number from a program without spans,
and tiny traced CPU runs."""

import sys

import pytest

from knn_for_homology_tpu_torch.utils.trace import Span
from portbench.lib import harness, program
from portbench.lib.record import DeviceTrace
from portbench.tests.tiny import BENCH, OVERRIDES

READERS = ("pad_efficiency.embedder", "prep_idle_share.embed",
           "dispatch_idle_share.embed", "copy_gbps.allvsall")


def reader(name):
    return harness.load_module(
        harness.BENCH_DIR / "metrics" / f"{name}.py",
        "test_m_" + name.replace(".", "_"))


def spans_of(rows):
    """Span records from (name, parent, t0, t1, counts) rows of one call."""
    return [Span(n, p, 0, t0, t1, c) for n, p, t0, t1, c in rows]


# one embed call (two batches, the first with its children) and one
# search, inside the benchmark's "embed" and "search" spans
SPANS = spans_of([
    ("embed", -1, 1.0001, 4.9999, {}),
    ("embed.batching", 0, 1.0002, 1.1, {}),
    ("embed.batch", 0, 1.1, 4.0, {"residues": 200, "tokens": 256}),
    ("embed.tokenize", 2, 1.1, 1.2, {}),
    ("embed.h2d", 2, 1.2, 1.3, {}),
    ("embed.encode", 2, 1.3, 2.0, {}),
    ("embed.pool", 2, 2.0, 2.1, {}),
    ("embed.d2h", 2, 2.1, 3.9, {}),
    ("embed.batch", 0, 4.0, 4.8, {"residues": 250, "tokens": 256}),
    ("embed.unsort", 0, 4.8, 4.9999, {}),
    ("flat.search", -1, 5.2, 5.4, {}),
    ("flat.h2d", 10, 5.2, 5.25, {"bytes": 2e8}),
    ("flat.d2h", 10, 5.3, 5.4, {"bytes": 6e8}),
])
KERNELS = [("k", 0.5, 1.15), ("k", 1.35, 2.05), ("k", 2.5, 3.0),
           ("k", 4.1, 4.7), ("k", 6.0, 10.0)]
COPIES = [("Memcpy HtoD (Pageable -> Device)", 1.25, 1.26),
          ("Memset (Device)", 5.21, 5.215),
          ("Memcpy HtoD (Pageable -> Device)", 5.22, 5.24),
          ("Memcpy DtoH (Device -> Pageable)", 5.32, 5.38)]
# idle seconds by innermost span: the gaps [0, .5], [1.15, 1.35] (less
# the copy at 1.25), [2.05, 2.5], [3, 4.1], [4.7, 5.22] (less the memset),
# [5.24, 5.32], [5.38, 6]
IDLE = {"": 0.5 + 0.2001 + 0.6, "embed.tokenize": 0.05,
        "embed.h2d": 0.09, "embed.encode": 0.05, "embed.pool": 0.05,
        "embed.d2h": 0.4 + 0.9, "embed.batch": 0.1 + 0.1 + 0.1,
        "embed.unsort": 0.1999, "flat.h2d": 0.015 + 0.01,
        "flat.search": 0.05, "flat.d2h": 0.02 + 0.02}


def synthetic_run(kernels=KERNELS, copies=COPIES):
    trace = DeviceTrace(
        kernels=list(kernels), copies=list(copies),
        spans=[("window", 0.0, 10.0), ("embed", 1.0, 5.0),
               ("search", 5.1, 5.5)],
        window=(0.0, 10.0))
    return harness.Run("synthetic", {}, {}, [], (0.0, 10.0), 1.0, trace)


@pytest.fixture
def recorded(monkeypatch):
    """Makes the readers see `spans` as what the program recorded."""
    def use(spans):
        monkeypatch.setattr(program, "recorded_spans", lambda: spans)
    use(SPANS)
    return use


def test_program_spans_keep_the_window_and_pass_the_clock_check(recorded):
    early = Span("embed.tokenize", -1, 0, -2.0, -1.0, {})
    recorded(SPANS + [early])
    assert program.program_spans(synthetic_run()) == SPANS


def test_idle_by_span_hand_computed():
    idle = program.idle_by_span(synthetic_run(), SPANS)
    assert idle.keys() == IDLE.keys()
    for name, seconds in IDLE.items():
        assert idle[name] == pytest.approx(seconds, abs=1e-9), name


@pytest.mark.parametrize("nested", [False, True], ids=["siblings", "nested"])
def test_idle_gap_straddling_two_spans_splits_by_intersection(nested):
    """A gap from 1 to 4 across spans a [0, 2] and b [2, 6] (or b inside a
    [0, 6] from 2) goes 1 s to a and 2 s to b, not all to the span holding
    its middle."""
    outer_end = 6.0 if nested else 2.0
    spans = spans_of([("a", -1, 0.0, outer_end, {}),
                      ("b", 0 if nested else -1, 2.0, 6.0, {})])
    run = synthetic_run(kernels=[("k", 0.0, 1.0), ("k", 4.0, 10.0)],
                        copies=[])
    idle = program.idle_by_span(run, spans)
    assert idle == pytest.approx({"a": 1.0, "b": 2.0, "": 0.0})


def test_innermost_pieces():
    spans = spans_of([("a", -1, 0.0, 10.0, {}), ("b", 0, 1.0, 3.0, {}),
                      ("c", 1, 1.0, 2.0, {}), ("d", 0, 3.0, 4.0, {}),
                      ("e", -1, 12.0, 13.0, {})])
    assert program.innermost(spans) == [
        (0.0, 1.0, "a"), (1.0, 2.0, "c"), (2.0, 3.0, "b"), (3.0, 4.0, "d"),
        (4.0, 10.0, "a"), (12.0, 13.0, "e")]


def test_readers_hand_computed(recorded):
    run = synthetic_run()
    assert reader("pad_efficiency.embedder").read(run) == pytest.approx(
        100.0 * 450 / 512)
    prep = sum(IDLE[n] for n in ("embed.batch", "embed.tokenize",
                                 "embed.h2d", "embed.d2h", "embed.unsort"))
    assert reader("prep_idle_share.embed").read(run) == pytest.approx(
        100.0 * prep / 10.0)
    assert reader("dispatch_idle_share.embed").read(run) == pytest.approx(
        100.0 * 0.1 / 10.0)
    # 8e8 bytes over the two Memcpy events inside the flat copy spans
    # (the memset and the embedder's copy left out)
    assert reader("copy_gbps.allvsall").read(run) == pytest.approx(
        8e8 / 0.08 / 1e9)


def test_readers_of_one_run_take_the_spans_once(monkeypatch):
    """The program hands its spans over once (trace.spans empties its
    buffer): the four readers of a run share one take, and a new run takes
    again."""
    takes = []
    monkeypatch.setattr(program, "recorded_spans",
                        lambda: takes.append(1) or list(SPANS))
    run = synthetic_run()
    values = [reader(name).read(run) for name in READERS]
    assert None not in values and len(takes) == 1
    assert program.program_spans(synthetic_run()) == SPANS
    assert len(takes) == 2


@pytest.mark.parametrize("shift", [2e-3, -2e-3, 0.3e-3])
def test_clock_check(recorded, shift):
    """Spans 2 ms off the benchmark's give no spans and no numbers; 0.3 ms
    is inside the tolerance."""
    recorded([s._replace(t0=s.t0 + shift, t1=s.t1 + shift) for s in SPANS])
    run = synthetic_run()
    values = [reader(name).read(run) for name in READERS]
    if abs(shift) > program.TOLERANCE_S:
        assert program.program_spans(run) is None
        assert values == [None] * 4
    else:
        assert len(program.program_spans(run)) == len(SPANS)
        assert None not in values


def test_no_checked_span_no_spans(recorded):
    recorded([s for s in SPANS if s.name not in ("embed", "flat.search")])
    assert program.program_spans(synthetic_run()) is None


def test_program_without_trace_module_gives_no_numbers(monkeypatch):
    import knn_for_homology_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "knn_for_homology_tpu_torch.utils.trace",
                        None)
    assert program.recorded_spans() is None
    run = synthetic_run()
    assert [reader(name).read(run) for name in READERS] == [None] * 4


def test_no_kernels_or_copies_no_device_numbers(recorded):
    run = synthetic_run(kernels=[], copies=[c for c in COPIES
                                            if c[0].startswith("Memset")])
    assert reader("prep_idle_share.embed").read(run) is None
    assert reader("dispatch_idle_share.embed").read(run) is None
    assert reader("copy_gbps.allvsall").read(run) is None
    assert reader("pad_efficiency.embedder").read(run) is not None


@pytest.fixture
def runs(monkeypatch):
    """The harness's Run objects, kept as run_cell makes them."""
    made = []

    class Kept(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    return made


def test_tiny_traced_embed_cell(runs):
    cell = "prott5xl.mix"
    line = harness.run_cell(cell, 2**33 + 11, 0.5, True, "cpu",
                            overrides=OVERRIDES[cell], bench=BENCH)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["pad_efficiency.embedder"]["value"] == pytest.approx(
        metrics["pad_efficiency.embed"]["value"], abs=1e-9)
    # the CPU has no device trace to split
    assert "prep_idle_share.embed" not in metrics
    assert "dispatch_idle_share.embed" not in metrics
    spans = program.program_spans(runs[-1])
    calls = [s for s in spans if s.name == "embed"]
    assert len(calls) == len(runs[-1].calls)
    assert {s.name for s in spans} >= {"embed.batch", "embed.encode",
                                       "flat.search", "flat.d2h"}


def test_tiny_traced_allvsall_cell(runs):
    cell = "pfam20.allvsall_sq8"
    line = harness.run_cell(cell, 2**33 + 13, 0.3, True, "cpu",
                            overrides=OVERRIDES[cell], bench=BENCH)
    assert line["correct"] is True
    assert "copy_gbps.allvsall" not in line["metrics"]  # no Memcpy events
    run = runs[-1]
    spans = program.program_spans(run)
    searches = [s for s in spans if s.name == "flat.search"]
    assert len(searches) == len(run.calls)
    rows, dim, k = run.info["rows"], run.info["dim"], run.cell["k"]
    assert {s.counts["bytes"] for s in spans if s.name == "flat.h2d"} == {
        rows * dim * 4}
    # fp32 scores and int32 ids
    assert {s.counts["bytes"] for s in spans if s.name == "flat.d2h"} == {
        rows * k * 8}


I_KERNEL = "void knn_attn::attention_t5_kernel<1, true>(CUtensorMap, int, int)"
H_KERNEL = "void knn_attn::attention_t5_kernel<2, false>(CUtensorMap, int, int)"


def with_short_launches(launches, padded=True):
    """SPANS with kernel I's launch counts on the encodes of the two batches
    (the second batch's encode added inside it), rows and padded lengths on
    the batches (left out with `padded` False: a program that counts no
    shapes)."""
    extra = ({"rows": 2, "padded_len": 128}, {"rows": 1, "padded_len": 256})
    out, batch = [], 0
    for sp in SPANS:
        if sp.name == "embed.batch":
            counts = dict(sp.counts, **(extra[batch] if padded else {}))
            out.append(sp._replace(counts=counts))
            if batch == 1:
                out.append(Span("embed.encode", 8, 0, 4.1, 4.7,
                                {"short_launches": launches[1]}))
            batch += 1
        elif sp.name == "embed.encode":
            out.append(sp._replace(counts={"short_launches": launches[0]}))
        else:
            out.append(sp)
    return out


def test_short_attention_roofline_hand_computed(recorded):
    """The bound of each batch whose encode launched I, once a launch, over
    the device time of I's kernels alone (H's left out)."""
    from portbench.lib.work import attention_bound_s

    kernels = KERNELS + [(I_KERNEL, 1.4, 1.45), (I_KERNEL, 4.2, 4.23),
                         (H_KERNEL, 4.3, 4.4)]
    run = synthetic_run(kernels=kernels)
    run.config = {"num_heads": 32, "d_kv": 128}
    recorded(with_short_launches((24, 24)))
    want = 24 * (attention_bound_s(2, 32, 128, 128)
                 + attention_bound_s(1, 32, 256, 128))
    got = reader("short_attention_roofline").read(run)
    assert got == pytest.approx(100.0 * want / 0.08)
    # a batch whose encode took another route adds nothing to the bound
    recorded(with_short_launches((24, 0)))
    run = synthetic_run(kernels=kernels)
    run.config = {"num_heads": 32, "d_kv": 128}
    assert reader("short_attention_roofline").read(run) == pytest.approx(
        100.0 * 24 * attention_bound_s(2, 32, 128, 128) / 0.08)


@pytest.mark.parametrize("case", ["parent", "no_launch", "no_kernel",
                                  "no_padded_len"])
def test_short_attention_roofline_reads_nothing(recorded, case):
    """No number from a program that does not count I's launches (the
    parent), from encodes that launched none, from a trace without I's
    kernels, or from batches without their shapes."""
    kernels = KERNELS + [(I_KERNEL, 1.4, 1.45)]
    spans = {"parent": SPANS, "no_launch": with_short_launches((0, 0)),
             "no_kernel": with_short_launches((24, 24)),
             "no_padded_len": with_short_launches((24, 24), padded=False)}
    recorded(spans[case])
    run = synthetic_run(kernels=KERNELS if case == "no_kernel" else kernels)
    run.config = {"num_heads": 32, "d_kv": 128}
    assert reader("short_attention_roofline").read(run) is None


def test_encode_span_counts_kernel_i_launches(monkeypatch):
    """Each "embed.encode" span counts the launches of kernel I's wrapper
    in its encode: one a layer where the batch's padded length takes dense
    attention (the wrapper's plain version is counted here as the card
    would count its kernel), none where it takes flash attention."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from knn_for_homology_tpu_torch.models import t5
    from knn_for_homology_tpu_torch.models.registry import ProtT5Embedder
    from knn_for_homology_tpu_torch.ops import short_cuda
    from knn_for_homology_tpu_torch.utils import trace

    real = short_cuda.short_attention_t5

    def counted(*args):
        real.launches += 1
        return real(*args)

    monkeypatch.setattr(short_cuda, "short_attention_t5", counted)
    params = t5.init_params(t5.TINY, seed=0, device="cpu")
    seqs = ["MKTAYIAKQR" * 3, "ACDEFGHIK", "W" * 40]
    counts = {}
    for route, above in (("dense", t5.TINY.blockwise_above), ("flash", 8)):
        config = dataclasses.replace(t5.TINY, blockwise_above=above,
                                     dtype=torch.float32)
        embedder = ProtT5Embedder(config=config, params=params,
                                  token_budget=64, device="cpu")
        trace.spans()
        with profile(activities=[ProfilerActivity.CPU]):
            embedder.embed_pooled(seqs)
        encodes = [sp for sp in trace.spans() if sp.name == "embed.encode"]
        assert len(encodes) == len(embedder.batches(seqs)) > 1
        counts[route] = {sp.counts["short_launches"] for sp in encodes}
    assert counts == {"dense": {t5.TINY.num_layers}, "flash": {0}}
