"""The flagship forward step: sequences' tokens → ProtT5 encoder → masked
mean-pool → l2 → top-k neighbours in a database (the counterpart of
__graft_entry__.py's `forward_step`, the JAX package's one-jit program),
and `dryrun_multichip`, the multi-device dry run.

    sims, ids = forward_step(encoder, db, token_ids, mask, k=13)

`encoder` is a models/t5.py:T5Encoder; `db` [N, d] holds L2-normalised
fp32 rows on the encoder's device. Inner product of normalised vectors is
cosine similarity; sims [B, k] fp32 descending, ids [B, k] int32.
"""

import numpy as np
import torch

from .models.pooling import mean_pool
from .models.t5 import T5Encoder
from .ops.distance import l2_normalize
from .ops.topk import oneshot_topk


@torch.no_grad()
def forward_step(
    encoder: T5Encoder,
    db: torch.Tensor,
    token_ids: torch.Tensor,
    mask: torch.Tensor,
    k: int = 13,
):
    hidden = encoder(token_ids, mask)
    pooled = l2_normalize(mean_pool(hidden, mask))
    return oneshot_topk(db, pooled, k, metric="ip")


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> dict:
    """The multi-device dry run (counterpart of __graft_entry__.py's
    `dryrun_multichip`): `n_devices` ranks run one step of the
    tensor- and data-parallel encoder, then db- and query-sharded search,
    the sharded flat (pod mesh), graph, IVF and LSH indexes and a
    ShardSweep, each held to its golden (below). Raises on any mismatch;
    returns rank 0's summary.

    Ranks are processes (parallel/mesh.py:spawn). On the CPU they meet on
    gloo; on CUDA on NCCL, a card a rank, so fewer cards than ranks raise
    unless the caller passes backend="gloo" (ranks then share a card and
    collectives stage through host memory). The encoder is the flagship
    entry's tiny T5 (d_model 128, 4 heads x 32, d_ff 256; 2 model ranks
    when n_devices is even): d_model 128 is a width kernel G takes on the
    card (bf16 there, fp32 on the CPU)."""
    from .device import resolve_device
    from .parallel.mesh import spawn

    device = resolve_device(device)
    if backend is None:
        if device.type == "cuda" and torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) on nccl needs {n_devices}"
                f" cards, {torch.cuda.device_count()} visible; pass"
                " backend='gloo' to share them")
        backend = "nccl" if device.type == "cuda" else "gloo"
    return spawn(_dryrun_rank, n_devices, device, backend,
                 args=(n_devices, str(device)))[0]


def _tiny_inputs(batch, length, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 24, size=(batch, length)).astype(np.int64)
    mask = np.ones((batch, length), dtype=bool)
    mask[:, length - 2 :] = False
    return ids, mask


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of dryrun_multichip: the reference's seven steps."""
    import tempfile

    from .models import t5
    from .ops.topk import oneshot_topk
    from .parallel import (
        DATA_AXIS,
        MODEL_AXIS,
        ShardedFlatIndex,
        ShardedGraphIndex,
        ShardedIVFIndex,
        ShardedLSHIndex,
        db_sharded_topk,
        make_mesh,
        make_pod_mesh,
        query_sharded_topk,
    )
    from .parallel.encoder_sharding import encode_sharded, shard_t5_params
    from .parallel.scale import ShardSweep
    from .search.lsh import LSHIndex

    dev = torch.device(device)
    model_par = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, axis_names=(DATA_AXIS, MODEL_AXIS),
                     shape=(n_devices // model_par, model_par))
    # d_kv 128: on the card kernels I and G take the encoder whole and
    # split over two model ranks
    config = t5.T5Config(
        vocab_size=32, d_model=128, d_kv=128, d_ff=256, num_layers=2,
        num_heads=4,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
    )
    full = t5.init_params(config, seed=0, device=dev)
    batch = 4 * (n_devices // model_par)
    ids, mask = (torch.from_numpy(a).to(dev)
                 for a in _tiny_inputs(batch, 32))
    out = {}

    # 1) TP + DP encoder forward, held to the unsharded encoder
    hidden = encode_sharded(shard_t5_params(full, mesh), ids, mask, config,
                            mesh)
    queries = l2_normalize(mean_pool(hidden, mask)).to(torch.float32)
    want = l2_normalize(mean_pool(t5.encode(full, ids, mask, config), mask))
    out["encoder_max_abs"] = float((queries - want.float()).abs().max())
    tol = 5e-2 if config.dtype == torch.bfloat16 else 1e-5
    assert out["encoder_max_abs"] <= tol, out

    # 2) db- and query-sharded search: ids equal to the unsharded search
    rng = np.random.RandomState(1)
    db = l2_normalize(torch.from_numpy(
        rng.randn(16 * n_devices, config.d_model).astype(np.float32)).to(dev))
    sims, hit_ids = db_sharded_topk(db, queries, 5, mesh, metric="ip",
                                    db_tile=16)
    assert hit_ids.shape == (batch, 5)
    _, hit_ids2 = query_sharded_topk(db, queries, 5, mesh, metric="ip",
                                     db_tile=16)
    assert torch.equal(hit_ids, hit_ids2)
    ref_sims, ref_ids = oneshot_topk(db, queries, 5, metric="ip")
    assert torch.equal(hit_ids, ref_ids)
    # values within 1e-6: shard-local products sum in another order
    assert torch.allclose(sims, ref_sims, atol=1e-6, rtol=1e-6)
    want_ids = hit_ids.cpu().numpy()

    # 3) pod mesh + streaming sharded index
    pod = (make_pod_mesh(n_ici=n_devices // 2, n_dcn=2) if n_devices % 2 == 0
           else make_pod_mesh(n_ici=n_devices, n_dcn=1))
    db_np, q_np = db.cpu().numpy(), queries.cpu().numpy()
    half = len(db_np) // 2
    index = ShardedFlatIndex(pod, metric="ip", device=dev)
    _, ids3 = index.add(db_np[:half]).add(db_np[half:]).search(q_np, 5)
    assert np.array_equal(ids3, want_ids)

    # 4) sharded graph: the beam (16) holds each shard's 16 rows, so the
    # fp32-rescored top-5 must be the exact one, in order
    _, g_ids = ShardedGraphIndex(pod, metric="ip", degree=4, beam_width=16,
                                 expand=4, device=dev).build(db_np).search(
                                     q_np, 5)
    assert np.array_equal(g_ids, want_ids)

    # 5) sharded IVF: nprobe and the union budget cover every cell of a
    # shard and the shortlist is rescored in fp32: the exact top-5
    _, i_ids = ShardedIVFIndex(pod, metric="ip", nprobe=64, union_budget=64,
                               device=dev).build(db_np).search(q_np, 5)
    assert np.array_equal(i_ids, want_ids)

    # 6) sharded LSH: bit-identical to the single-device LSHIndex
    l_dist, l_ids = ShardedLSHIndex(pod, dim=config.d_model, nbits=128,
                                    device=dev).add(db_np).finalize().search(
                                        q_np, 5)
    w_dist, w_ids = LSHIndex(dim=config.d_model, nbits=128,
                             device=dev).add(db_np).search(q_np, 5)
    assert np.array_equal(l_ids, w_ids) and np.array_equal(l_dist, w_dist)

    # 7) one-device spill: a covering IVF shard a half, fp32 rescore, so
    # the swept top-5 equals the resident exact search (rank 0 alone: it
    # is one process's program)
    if torch.distributed.get_rank() == 0:
        with tempfile.TemporaryDirectory() as tmp:
            sweep = ShardSweep(tmp, metric="ip", index="ivf", nprobe=64,
                               store_fp32=True, device=dev)
            sweep.build_shard(db_np[:half])
            sweep.build_shard(db_np[half:])
            s_scores, s_ids, _ = sweep.search(q_np, 5)
        assert np.array_equal(s_ids, want_ids)
        assert np.allclose(s_scores, sims.cpu().numpy(), atol=1e-6,
                           rtol=1e-6)
    out["steps"] = 7
    return out
