"""The port's spans (utils/trace.py): nothing recorded and one shared object
with no profiler running; under torch.profiler, the span tree of
ProtT5Embedder.embed_pooled and FlatIndex.search with the counts the
benchmark reads, on the profiler's host clock; spans() hands a session's
records over once; the record buffer bounded."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from knn_for_homology_tpu_torch.models import t5
from knn_for_homology_tpu_torch.models.batching import make_batches
from knn_for_homology_tpu_torch.models.registry import ProtT5Embedder
from knn_for_homology_tpu_torch.search.flat import FlatIndex
from knn_for_homology_tpu_torch.utils import trace

AAS = "ACDEFGHIKLMNPQRSTVWY"
BATCH_CHILDREN = ["embed.tokenize", "embed.h2d", "embed.encode",
                  "embed.pool", "embed.d2h"]


def sequences(seed, n, lo=5, hi=120):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(AAS), size=rng.randint(lo, hi)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def embedder():
    return ProtT5Embedder(config=t5.TINY,
                          params=t5.init_params(t5.TINY, 0, "cpu"),
                          token_budget=512, max_len=100, device="cpu")


def flat_index(backend):
    rng = np.random.RandomState(1)
    index = FlatIndex(metric="cosine", backend=backend, device="cpu")
    return index.add(rng.randn(200, 32).astype(np.float32))


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.spans()


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.spans()


def test_off_span_is_one_shared_object():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("a"), trace.span("b", rows=3)
    assert a is b and not hasattr(a, "__dict__") and not a
    with a as s:
        s.count(bytes=1)
    assert trace.spans() == []


@pytest.mark.parametrize("call", ["embed", "auto", "sq8"])
def test_off_records_nothing(call, embedder):
    if call == "embed":
        embedder.embed_pooled(sequences(0, 12))
    else:
        flat_index(call).search(np.ones((5, 32), np.float32), 7)
    assert trace.spans() == []


def test_embed_span_tree(embedder):
    seqs = sequences(2, 20)
    pooled, spans = traced(lambda: embedder.embed_pooled(seqs))
    assert spans[0].name == "embed" and spans[0].parent == -1
    assert spans[0].counts == {}
    assert {s.call for s in spans} == {0}
    top = [s.name for s in spans if s.parent == 0]
    batches = make_batches(seqs, 512, 100)
    assert top == ["embed.batching"] + ["embed.batch"] * len(batches) \
        + ["embed.unsort"]
    for i, s in enumerate(spans):
        if s.name == "embed.batch":
            assert [c.name for c in spans if c.parent == i] == BATCH_CHILDREN
        if s.parent >= 0:
            outer = spans[s.parent]
            assert outer.t0 <= s.t0 <= s.t1 <= outer.t1
    assert all(s.counts == {} for s in spans
               if s.name not in ("embed.batch", "embed.encode"))
    # kernel I's launches: none on the CPU (its plain version runs)
    assert all(s.counts == {"short_launches": 0} for s in spans
               if s.name == "embed.encode")
    np.testing.assert_array_equal(pooled, embedder.embed_pooled(seqs))


def test_two_calls_two_call_ids(embedder):
    def twice():
        embedder.embed_pooled(sequences(3, 4))
        embedder.embed_pooled(sequences(4, 4))

    _, spans = traced(twice)
    roots = [i for i, s in enumerate(spans) if s.name == "embed"]
    assert len(roots) == 2 and [spans[i].parent for i in roots] == [-1, -1]
    assert all(s.call == max(r for r in roots if r <= i)
               for i, s in enumerate(spans))


def test_embed_counts_equal_make_batches(embedder):
    seqs = sequences(5, 30, hi=160)
    _, spans = traced(lambda: embedder.embed_pooled(seqs))
    batches = make_batches(seqs, 512, 100)
    counts = [s.counts for s in spans if s.name == "embed.batch"]
    assert counts == [{"residues": sum(len(x) for x in b.sequences),
                       "tokens": len(b.indices) * b.padded_len,
                       "rows": len(b.indices), "padded_len": b.padded_len,
                       "residues_sq": sum(len(x) ** 2 for x in b.sequences)}
                      for b in batches]


@pytest.mark.parametrize("backend, blocks", [
    pytest.param(backend, blocks, id=backend + ("" if blocks == 1 else "-3"))
    for blocks in (1, 3) for backend in ("auto", "sq8")])
def test_search_span_tree_and_bytes(backend, blocks, monkeypatch):
    """One search, in one block or in three (the block size patched small):
    one copy span each way, apart, with the whole call's bytes."""
    if blocks > 1:
        monkeypatch.setattr(FlatIndex, "_block_rows", lambda self, k: 4)
    index = flat_index(backend)
    queries = np.random.RandomState(6).randn(9, 32).astype(np.float32)
    routes = dict(FlatIndex.copy_routes)
    (scores, ids), spans = traced(lambda: index.search(queries, 11))
    route = "direct" if blocks == 1 else "pipelined"
    assert FlatIndex.copy_routes[route] == routes[route] + 1
    assert [s.name for s in spans] == ["flat.search", "flat.h2d", "flat.d2h"]
    assert [s.parent for s in spans] == [-1, 0, 0]
    assert [s.call for s in spans] == [0, 0, 0]
    assert spans[1].t1 <= spans[2].t0
    assert spans[0].counts == {}
    assert spans[1].counts == {"bytes": queries.nbytes}
    assert spans[2].counts == {"bytes": scores.nbytes + ids.nbytes}


def test_span_clock_is_the_profilers():
    """A span opened inside a profiler range lies within the range's kineto
    host times, to 0.5 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with record_function("pb:x"):
                with trace.span("inner", i=i):
                    torch.ones(64).sum()
    ranges = sorted((ev.start_ns() * 1e-9,
                     (ev.start_ns() + ev.duration_ns()) * 1e-9)
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == "pb:x")
    spans = trace.spans()
    assert len(ranges) == len(spans) == 20
    for (lo, hi), s in zip(ranges, spans):
        assert lo - 0.5e-3 <= s.t0 <= s.t1 <= hi + 0.5e-3


def test_counts_and_exceptions():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer", a=1) as s:
            s.count(b=2)
            with pytest.raises(ValueError):
                with trace.span("inner"):
                    raise ValueError("closes the span all the same")
    spans = trace.spans()
    assert [(s.name, s.parent, s.call) for s in spans] == [
        ("outer", -1, 0), ("inner", 0, 0)]
    assert spans[0].counts == {"a": 1, "b": 2}


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            for i in range(8):
                with trace.span("inner", i=i):
                    pass
    spans = trace.spans()
    assert len(spans) == 5
    assert [s.counts.get("i") for s in spans] == [None, 0, 1, 2, 3]


def test_on_span_is_truthy():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a") as s:
            assert s and s is not trace.span("b")
    assert [x.name for x in trace.spans()] == ["a"]


def test_each_session_sees_its_own_spans(embedder):
    """spans() hands the records over and empties the buffer: a second
    session's spans() holds that session's spans alone."""
    _, first = traced(lambda: embedder.embed_pooled(sequences(7, 6)))
    assert trace.spans() == []
    index = flat_index("auto")
    _, second = traced(lambda: index.search(np.ones((3, 32), np.float32), 5))
    assert first[0].name == "embed" and len(first) > 3
    assert [s.name for s in second] == ["flat.search", "flat.h2d", "flat.d2h"]
    assert trace.spans() == []


def test_spans_taken_while_a_span_is_open():
    """A span open when spans() is called is left out, and a span opened
    after that starts the new buffer's tree."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            with trace.span("before"):
                pass
            assert trace.spans() == []
            with trace.span("after"):
                with trace.span("inner"):
                    pass
    assert [(s.name, s.parent, s.call) for s in trace.spans()] == [
        ("after", -1, 0), ("inner", 0, 0)]


def test_taking_spans_frees_a_full_buffer(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            with trace.span("a", i=i):
                pass
        assert [s.counts["i"] for s in trace.spans()] == [0, 1]
        with trace.span("b"):
            pass
    assert [s.name for s in trace.spans()] == ["b"]
