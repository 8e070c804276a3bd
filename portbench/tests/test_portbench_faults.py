"""A run with the timed path broken underneath comes out not correct: for
each cell, half of a call's answers left out (the mean of the rest put in
their place) and one answer altered where it is produced; and the control,
the reference one precision step down in the program's place, fails the
cell's limits. At tiny sizes on the CPU, where the check compares every
answer the window produced."""

import numpy as np
import pytest
import torch

from portbench.lib import harness
from portbench.tests.tiny import BENCH, OVERRIDES


def half_mean(arr: np.ndarray) -> np.ndarray:
    out = np.array(arr, copy=True)
    half = len(out) // 2
    out[half:] = out[:half].mean(axis=0).astype(out.dtype)
    return out


def patch_embed_half(mp):
    from knn_for_homology_tpu_torch.models.registry import ProtT5Embedder

    real = ProtT5Embedder.embed_pooled
    mp.setattr(ProtT5Embedder, "embed_pooled",
               lambda self, seqs: half_mean(real(self, seqs)))


def patch_embed_alter(mp):
    from knn_for_homology_tpu_torch.models.registry import ProtT5Embedder

    real = ProtT5Embedder.embed_pooled

    def altered(self, seqs):
        out = real(self, seqs)
        out[0] = out[0] * 1.5
        return out

    mp.setattr(ProtT5Embedder, "embed_pooled", altered)


def patch_search_half(mp):
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    real = FlatIndex.search

    def half(self, q, k):
        scores, ids = real(self, q, k)
        n = len(ids) // 2
        ids[n:] = ids[:n][: len(ids) - n]
        return scores, ids

    mp.setattr(FlatIndex, "search", half)


def patch_search_alter(mp):
    from knn_for_homology_tpu_torch.search.flat import FlatIndex

    real = FlatIndex.search

    def altered(self, q, k):
        scores, ids = real(self, q, k)
        ids[:, 0] = (ids[:, 0] + 1) % self.ntotal
        return scores, ids

    mp.setattr(FlatIndex, "search", altered)


def patch_align(mp, how):
    from knn_for_homology_tpu_torch.ops import align

    real = align.align_hits

    def broken(queries, hits, **kw):
        scores, evs = real(queries, hits, **kw)
        if how == "half":
            half = len(scores) // 2
            fill = float(np.mean(np.concatenate(scores[:half])))
            scores = scores[:half] + [np.full_like(s, fill)
                                      for s in scores[half:]]
        else:
            scores = [s.copy() for s in scores]
            scores[0][0] += 1
        return scores, evs

    mp.setattr(align, "align_hits", broken)


def patch_topk(mp, how):
    from knn_for_homology_tpu_torch.search import flat

    real = flat.flat_topk  # FlatIndex's own reference to the top-k

    def broken(db, queries, k, **kw):
        sims, ids = real(db, queries, k, **kw)
        sims, ids = sims.clone(), ids.clone()
        if how == "half":
            n = ids.shape[0] // 2
            ids[n:] = ids[:n][: ids.shape[0] - n]
            sims[n:] = sims[:n].mean(0)
        else:
            ids[:, 0] = (ids[:, 0] + 1) % db.n
        return sims, ids

    mp.setattr(flat, "flat_topk", broken)


FAULTS = {
    "prott5xl.mix": {"half": patch_embed_half, "alter": patch_embed_alter,
                     "search_half": patch_search_half,
                     "search_alter": patch_search_alter},
    "prott5xl.long": {"half": patch_embed_half, "alter": patch_embed_alter},
    "pfam20.query_align": {
        "search_half": patch_search_half, "search_alter": patch_search_alter,
        "half": lambda mp: patch_align(mp, "half"),
        "alter": lambda mp: patch_align(mp, "alter")},
    "pfam20.allvsall_sq8": {"half": lambda mp: patch_topk(mp, "half"),
                            "alter": lambda mp: patch_topk(mp, "alter")},
}
CASES = [(cell, fault) for cell, faults in sorted(FAULTS.items())
         for fault in sorted(faults)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    result = harness.run_cell(cell, 11, 0.5, False, "cpu",
                              overrides=OVERRIDES[cell], bench=BENCH)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_control_fails_the_limits(cell):
    result = harness.run_cell(cell, 12, 0.5, False, "cpu",
                              overrides=OVERRIDES[cell], control=True,
                              bench=BENCH)
    assert result["correct"] is True, result["checks"]
    failed = [k for k, v in result["control"].items()
              if not float(v) <= result["checks"][k]["limit"]]
    assert failed, (result["control"], result["checks"])


def test_unbroken_run_is_correct():
    result = harness.run_cell("pfam20.query_align", 11, 0.5, False, "cpu",
                              overrides=OVERRIDES["pfam20.query_align"],
                              bench=BENCH)
    assert result["correct"] is True, result["checks"]
    assert torch.get_default_dtype() == torch.float32
