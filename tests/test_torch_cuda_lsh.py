"""The card route of the LSH search (ops/lsh.py:hamming_topk on CUDA
tensors: `torch._int_mm` products, one `torch.topk` over unique keys, int32
where they fit, and the int64 keys of wider indexes)
against its plain route on the card (the ±1 product in fp32 with TF32 off,
then stable_topk). Both are exact, so ids and distances must be bit-equal,
ties included.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lsh.py
"""

import numpy as np
import pytest
import torch

from knn_for_homology_tpu_torch.ops import lsh
from knn_for_homology_tpu_torch.search.lsh import LSHIndex

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card route runs there only")
    return torch.device("cuda")


def _signs(rng, n, nbits, device):
    bits = rng.rand(n, nbits) < 0.5
    return torch.from_numpy(np.where(bits, 1, -1).astype(np.int8)).to(device)


@pytest.mark.parametrize("k", [13, 1000])
@pytest.mark.parametrize("q_n, nbits", [(2048, 1024), (7, 1000), (300, 72)])
def test_card_route_bit_equal_with_ties(cuda, k, q_n, nbits):
    """A db of 2048 rows, every distinct row four times (each distance
    ties four ways), and queries copied from the db (distance 0 ties);
    odd query counts and widths exercise the products' padding."""
    rng = np.random.RandomState(q_n + nbits)
    base = _signs(rng, 512, nbits, cuda)
    db = base[torch.from_numpy(rng.permutation(2048) % 512).to(cuda)]
    q = torch.cat([db[:q_n // 2], _signs(rng, q_n - q_n // 2, nbits, cuda)])
    want_d, want_i = lsh.hamming_topk_plain(db, q, k)
    for got_d, got_i in (lsh.hamming_topk(db, q, k),
                         lsh.hamming_topk_int(db, q, k, torch.int64)):
        torch.cuda.synchronize()
        assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_d, want_d)
        assert float(got_d[0, 0]) == 0.0


def test_card_route_k_beyond_n(cuda):
    rng = np.random.RandomState(1)
    db, q = _signs(rng, 100, 256, cuda), _signs(rng, 40, 256, cuda)
    got_d, got_i = lsh.hamming_topk(db, q, 130)
    want_d, want_i = lsh.hamming_topk_plain(db, q, 130)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    assert bool((got_i[:, 100:] == -1).all())
    assert bool(torch.isinf(got_d[:, 100:]).all())


def test_card_route_blocks_queries(cuda, monkeypatch):
    """Several query blocks of the key buffer give the one-block result."""
    rng = np.random.RandomState(2)
    db, q = _signs(rng, 1000, 512, cuda), _signs(rng, 300, 512, cuda)
    whole = lsh.hamming_topk(db, q, 50)
    monkeypatch.setattr(lsh, "KEY_BLOCK_BYTES", 8 * 1000 * 64)
    blocked = lsh.hamming_topk(db, q, 50)
    assert torch.equal(whole[0], blocked[0])
    assert torch.equal(whole[1], blocked[1])


def test_index_on_the_card_matches_cpu(cuda):
    """Sketches on the card against the CPU's where |x·p| is clear of 0,
    and the card's search against the plain route on the CPU, given the
    card's sketches."""
    rng = np.random.RandomState(3)
    x = rng.randn(3000, 64).astype(np.float32)
    card = LSHIndex(64, nbits=1024, device=cuda).add(x)
    host = LSHIndex(64, nbits=1024, device="cpu").add(x)
    exact = x.astype(np.float64) @ card.projection.astype(np.float64)
    far = np.abs(exact) > 1e-4
    got, want = card._signs.cpu().numpy(), host._signs.numpy()
    np.testing.assert_array_equal(got[far], want[far])
    q = card.signs_of(x[:256])
    for k in (13, 1000):
        _, want = lsh.hamming_topk_plain(card._signs.cpu(), q.cpu(), k)
        np.testing.assert_array_equal(card.search(x[:256], k)[1],
                                      want.numpy())
