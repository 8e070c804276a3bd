"""protxlnet.long and pfam20.graph_online at tiny sizes on the CPU: a run
with the timed path broken underneath (half of a call's answers left out,
one answer altered) comes out not correct, and the control fails the
cells' limits (test_portbench_faults.py's cases, for these cells); so does
protxlnet.long with the position term broken inside the timed encode."""

import pytest

from portbench.lib import harness
from portbench.tests.test_portbench_faults import half_mean
from portbench.tests.tiny import BENCH
from portbench.tests.tiny_xlnet_graph import OVERRIDES


def patch_embed(mp, how):
    from knn_for_homology_tpu_torch.models.registry import XLNetEmbedder

    real = XLNetEmbedder.embed_pooled

    def broken(self, seqs):
        out = real(self, seqs)
        if how == "half":
            return half_mean(out)
        out[0] = out[0] * 1.5
        return out

    mp.setattr(XLNetEmbedder, "embed_pooled", broken)


def patch_graph(mp, how):
    from knn_for_homology_tpu_torch.search.graph import GraphIndex

    real = GraphIndex.search

    def broken(self, q, k):
        scores, ids = real(self, q, k)
        if how == "half":
            n = len(ids) // 2
            ids[n:] = ids[:n][: len(ids) - n]
        else:
            scores[0, 0] += 1e-3
        return scores, ids

    mp.setattr(GraphIndex, "search", broken)


def patch_encode(mp, how):
    """Breaks the position term inside the encode the window times
    (models/xlnet.py's fused route): R projected with the next layer's
    weights (a wrong slice of the one R product), the sinusoid one row
    off, or no position term."""
    import torch

    from knn_for_homology_tpu_torch.models import xlnet

    if how == "r_one_row_off":
        real_sin = xlnet.sinusoid
        mp.setattr(xlnet, "sinusoid", lambda length, d, device: torch.roll(
            real_sin(length, d, device), 1, 0))
        return
    real = xlnet._encode_fused

    def broken(params, token_ids, mask, config):
        layers = params["layers"]
        layers = [dict(p, r=(layers[(i + 1) % len(layers)]["r"]
                             if how == "r_of_next_layer" else 0 * p["r"]))
                  for i, p in enumerate(layers)]
        return real(dict(params, layers=layers), token_ids, mask, config)

    mp.setattr(xlnet, "_encode_fused", broken)


FAULTS = {"protxlnet.long": patch_embed, "pfam20.graph_online": patch_graph}
CASES = [(cell, how) for cell in sorted(FAULTS) for how in ("alter", "half")]
ENCODE_FAULTS = ("r_of_next_layer", "r_one_row_off", "no_position_term")


@pytest.mark.parametrize("cell,how", CASES, ids=[f"{c}-{h}" for c, h in CASES])
def test_fault_is_not_correct(cell, how, monkeypatch):
    FAULTS[cell](monkeypatch, how)
    result = harness.run_cell(cell, 11, 0.5, False, "cpu",
                              overrides=OVERRIDES[cell], bench=BENCH)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("how", ENCODE_FAULTS)
def test_position_term_fault_is_not_correct(how, monkeypatch):
    # only attn_rel_err, read from the window's own encode, sees these
    patch_encode(monkeypatch, how)
    cell = "protxlnet.long"
    result = harness.run_cell(cell, 13, 0.5, False, "cpu",
                              overrides=OVERRIDES[cell], bench=BENCH)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["attn_rel_err"]["value"] > \
        result["checks"]["attn_rel_err"]["limit"], result["checks"]


@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_control_fails_the_limits(cell):
    result = harness.run_cell(cell, 12, 0.5, False, "cpu",
                              overrides=OVERRIDES[cell], control=True,
                              bench=BENCH)
    assert result["correct"] is True, result["checks"]
    failed = [k for k, v in result["control"].items()
              if not float(v) <= result["checks"][k]["limit"]]
    assert failed, (result["control"], result["checks"])
