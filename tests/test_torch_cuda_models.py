"""The other encoder families (models/{elmo,bert,xlnet,unirep,plus_rnn,
cpcprot}.py) on the card against the same encoders on the CPU, with the
same weights moved across; and one full-width recurrence step of the ELMo
(SeqVec) and mLSTM (UniRep) cells, where the card and the CPU differ only
in the order of their fp32 sums.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_models.py

Tolerance: all of these encoders are fp32 on both sides (TF32 off, the
package's import sets it), so the two devices differ by the rounding of
sums taken in other orders: |card - cpu| ≤ 1e-5 · max(1, max|cpu|), the
bound the CPU tests hold the port to against JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.models import (
    bert,
    cpcprot,
    elmo,
    plus_rnn,
    registry,
    unirep,
    xlnet,
)
from knn_for_homology_tpu_torch.models.convert import params_to_torch
from knn_for_homology_tpu_torch.ops.lstm import lstmp_bidir_plain

pytestmark = pytest.mark.cuda
FP32_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_fp32_close(got: torch.Tensor, want: torch.Tensor, tol=FP32_TOL):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    assert err <= tol * scale, (err, scale)


def padded_batch(rng, vocab, lengths):
    width = max(lengths)
    ids = rng.randint(0, vocab, (len(lengths), width)).astype(np.int32)
    mask = np.arange(width)[None] < np.asarray(lengths)[:, None]
    return (torch.from_numpy(np.where(mask, ids, 0).astype(np.int32)),
            torch.from_numpy(mask))


FAMILIES = {
    "elmo": (elmo, elmo.TINY_ELMO, len(elmo.AA_ORDER)),
    "bert": (bert, bert.TINY_BERT, 32),
    "albert": (bert, dataclasses.replace(
        bert.TINY_BERT, pre_norm=False, share_layers=True, embed_dim=16,
        gelu_exact=False), 32),
    "xlnet": (xlnet, xlnet.TINY_XLNET, 32),
    "unirep": (unirep, unirep.TINY_UNIREP, 26),
    "plus_rnn": (plus_rnn, plus_rnn.TINY_PLUS, 21),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_encoder_card_equals_cpu(cuda, family):
    module, config, vocab = FAMILIES[family]
    params = module.init_params(config, seed=3, device="cpu")
    ids, mask = padded_batch(np.random.RandomState(4), vocab, [40, 17, 3])
    want = module.encode(params, ids, mask, config)
    got = module.encode(params_to_torch(params, cuda), ids.to(cuda),
                        mask.to(cuda), config)
    assert_fp32_close(got, want)


@pytest.mark.parametrize("conv_spec", [((8, 3), (16, 3)), ((8, 4), (16, 2))],
                         ids=["odd", "even"])
def test_cpcprot_card_equals_cpu(cuda, conv_spec):
    config = dataclasses.replace(cpcprot.TINY_CPCPROT, conv_spec=conv_spec)
    params = cpcprot.init_params(config, seed=5, device="cpu")
    ids = torch.from_numpy(
        np.random.RandomState(6).randint(0, 30, (3, 8, 4)).astype(np.int32))
    zw, cw = cpcprot.encode(params, ids, config)
    zg, cg = cpcprot.encode(params_to_torch(params, cuda), ids.to(cuda),
                            config)
    assert_fp32_close(zg, zw)
    assert_fp32_close(cg, cw)


def test_elmo_full_width_step_card_equals_cpu(cuda):
    """The fp32 route's recurrence (ops/lstm.py's step loop) over three
    steps of both SeqVec directions at 512 → 4096 cells → 512, 16 rows
    (two of length 0, one of length 1), at the init's scales: card and
    CPU agree, and nothing is written past a row's length."""
    config = elmo.SEQVEC
    gen = torch.Generator().manual_seed(7)
    h4, p = config.lstm_dim, config.proj_dim
    w_h = [torch.randn(p, 4 * h4, generator=gen) * 0.1 for _ in range(2)]
    w_p = [torch.randn(h4, p, generator=gen) * 0.1 for _ in range(2)]
    xw = torch.randn(2, 16, 3, 4 * h4, generator=gen)
    lengths = [3] * 16
    lengths[3] = lengths[11] = 0
    lengths[5] = 1
    want = lstmp_bidir_plain(xw, w_h, w_p, lengths, config.cell_clip,
                             config.proj_clip)
    got = lstmp_bidir_plain(xw.to(cuda), [w.to(cuda) for w in w_h],
                            [w.to(cuda) for w in w_p], lengths,
                            config.cell_clip, config.proj_clip)
    assert_fp32_close(got, want)
    assert not got[3].any() and not got[11].any() and not got[5, 1:].any()


def test_mlstm_full_width_step_card_equals_cpu(cuda):
    """One UniRep mLSTM step at 1900 cells, 16 rows (two masked)."""
    config = unirep.UNIREP
    params = unirep.init_params(config, seed=8, device="cpu")
    gen = torch.Generator().manual_seed(9)
    x = params["embedding"][torch.randint(0, 26, (16,), generator=gen)]
    h = torch.rand(16, config.hidden_dim, generator=gen) * 2 - 1
    c = torch.randn(16, config.hidden_dim, generator=gen)
    keep = torch.ones(16, dtype=torch.bool)
    keep[[0, 9]] = False
    want = unirep.mlstm_step(x @ params["wmx"], x @ params["wx"], h, c, keep,
                             params, config)
    pd = params_to_torch(params, cuda)
    xd = x.to(cuda)
    got = unirep.mlstm_step(xd @ pd["wmx"], xd @ pd["wx"], h.to(cuda),
                            c.to(cuda), keep.to(cuda), pd, config)
    for g, w in zip(got, want):
        assert_fp32_close(g, w)
    assert not got[2][0].any()  # masked rows emit zeros


@pytest.mark.parametrize("key", ["SeqVec", "ESM1b", "ProtXLNet UniRef100",
                                 "UniRep", "PLUS", "CPCProt"])
def test_registry_card_equals_cpu(cuda, key):
    """A registry embedder on the card pools as the same embedder on the
    CPU over a mixed-length set (batching and un-sorting on both)."""
    module, config, kw = {
        "SeqVec": (elmo, elmo.TINY_ELMO, {"max_batch_tokens": 256}),
        "ESM1b": (bert, dataclasses.replace(bert.TINY_BERT,
                                            position_offset=2),
                  {"token_budget": 256}),
        "ProtXLNet UniRef100": (xlnet, dataclasses.replace(
            xlnet.TINY_XLNET, vocab_size=40), {"token_budget": 256}),
        "UniRep": (unirep, unirep.TINY_UNIREP, {"token_budget": 256}),
        "PLUS": (plus_rnn, plus_rnn.TINY_PLUS, {"token_budget": 256}),
        "CPCProt": (cpcprot, cpcprot.TINY_CPCPROT, {"batch_size": 3}),
    }[key]
    params = module.init_params(config, seed=10, device="cpu")
    rng = np.random.RandomState(11)
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWYXU"), int(n)))
            for n in rng.randint(3, 60, 9)]
    want = registry.get_embedder(key, params=params, config=config,
                                 device="cpu", **kw).embed_pooled(seqs)
    got = registry.get_embedder(key, params=params, config=config,
                                device="cuda", **kw).embed_pooled(seqs)
    assert_fp32_close(torch.from_numpy(got), torch.from_numpy(want))
