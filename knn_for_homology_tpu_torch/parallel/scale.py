"""Scale-out: pod meshes and the sharded indexes (port of
knn_for_homology_tpu/parallel/scale.py).

  * `make_pod_mesh` — a (dcn, data) mesh: the inner axis spans the ranks
    of one host, the outer axis the hosts. Database shards map to the
    combined axis (`flatten_mesh`), so the O(k·Q) winner merge crosses
    hosts once while each shard's scan stays on its rank.
  * `ShardedFlatIndex`, `ShardedLSHIndex`, `ShardedGraphIndex`,
    `ShardedIVFIndex` — one shard a rank: every rank builds (or holds)
    only its own rows, the replicated queries fan out, and the per-shard
    winner sets merge with one all_gather and one stable selection
    (parallel/sharded.py:merge_shards), value descending and the lower
    global id first, the reference's order. Every rank calls the same
    methods with the same arguments (SPMD) and gets the whole result.
  * `ShardSweep` — one process: shards built and spilled one at a time,
    reloaded one at a time at query time, merged on the host.

Shards are built as the reference builds them: rows padded to a multiple
of the shard count (zeros for the flat and LSH sketches, wrapped real rows
for the graph and IVF), each shard indexed on its own with the port's
single-device index (the same k-means, graph and Threefry long-range
edges as the JAX package's), and `n_valid` keeps a shard's pad rows out of
every selection. The device is explicit (`device`, "cuda" by default).
"""

import time
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.distance import finalize_scores, l2_normalize
from ..ops.topk import pad_k
from .mesh import DATA_AXIS
from .sharded import merge_shards, shard_topk

DCN_AXIS = "dcn"


def _axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def data_axis_size(mesh) -> int:
    """Total database shards of a (possibly dcn × data) mesh."""
    size = _axis_size(mesh, DATA_AXIS)
    if DCN_AXIS in mesh.mesh_dim_names:
        size *= _axis_size(mesh, DCN_AXIS)
    return size


def flatten_mesh(mesh):
    """Collapse a (dcn, data) pod mesh into one data axis (same rank
    order) for merges over a single axis; built once per mesh."""
    if DCN_AXIS not in mesh.mesh_dim_names:
        return mesh
    flat = getattr(mesh, "_knn_flat", None)
    if flat is None:
        from torch.distributed.device_mesh import DeviceMesh

        flat = DeviceMesh(mesh.device_type, mesh.mesh.flatten(),
                          mesh_dim_names=(DATA_AXIS,))
        mesh._knn_flat = flat
    return flat


def make_pod_mesh(n_ici: Optional[int] = None, n_dcn: int = 1):
    """(dcn, data) mesh over the process group: contiguous ranks along the
    inner data axis, the outer axis across hosts. With one host this is a
    flat data mesh with a dcn axis of size 1."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n_ici = n_ici or world // n_dcn
    if n_ici * n_dcn != world:
        raise ValueError(f"a {n_dcn} x {n_ici} pod mesh needs {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_dcn, n_ici),
                            mesh_dim_names=(DCN_AXIS, DATA_AXIS))


def _shard_of(mesh) -> Tuple[int, int, object]:
    """(this rank's shard, shard count, merge group) of the flattened
    data axis."""
    flat = flatten_mesh(mesh)
    return (flat.get_local_rank(DATA_AXIS), data_axis_size(mesh),
            flat.get_group(DATA_AXIS))


def _pad_k_np(sims, ids, k, fill=-np.inf):
    """FAISS-style padding of host results to k columns."""
    if sims.shape[1] < k:
        pad = k - sims.shape[1]
        sims = np.pad(sims, ((0, 0), (0, pad)), constant_values=fill)
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
    return sims, ids


class ShardedFlatIndex:
    """Exact cosine/ip/l2 index sharded over a mesh's data axis (or a pod
    mesh's dcn × data)."""

    def __init__(self, mesh, metric: str = "cosine", dtype=torch.float32,
                 storage: str = "native", device="cuda"):
        self.mesh = mesh
        self.metric = metric
        self.dtype = dtype
        self.storage = storage  # "sq8" / "sq8-sym": int8 shard scans
        self.device = resolve_device(device)
        self._chunks: List[torch.Tensor] = []  # host rows, normalised
        self._shard = None  # this rank's [rows, d] on the device
        self._n = 0

    @property
    def ntotal(self) -> int:
        return self._n

    def _normalised(self, vectors) -> torch.Tensor:
        chunk = torch.as_tensor(np.asarray(vectors, dtype=np.float32))
        if self.metric == "cosine":
            chunk = l2_normalize(chunk.to(self.device)).cpu()
        return chunk

    def add(self, vectors) -> "ShardedFlatIndex":
        """Stream in a host chunk (normalised once here for cosine)."""
        self._chunks.append(self._normalised(vectors).to(self.dtype))
        self._n += self._chunks[-1].shape[0]
        self._shard = None
        return self

    def finalize(self) -> "ShardedFlatIndex":
        """Pad the rows to the shard count and place this rank's shard on
        its device (the host chunks stay: add() after finalize() keeps
        every row)."""
        if not self._chunks:
            raise ValueError("index is empty; call add() first")
        s, n_shards, _ = _shard_of(self.mesh)
        rows = -(-self._n // n_shards)
        db = torch.cat(self._chunks)
        shard = db[s * rows : (s + 1) * rows]
        if shard.shape[0] < rows:  # zero pad rows, masked by n_valid
            shard = torch.nn.functional.pad(
                shard, (0, 0, 0, rows - shard.shape[0]))
        self._shard = shard.to(self.device).contiguous()
        return self

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Replicated-query fan-out + per-shard top-k + merge. Returns
        FAISS-convention (scores, ids)."""
        if self._shard is None:
            self.finalize()
        q = torch.as_tensor(np.asarray(queries, dtype=np.float32)).to(
            self.device)
        if self.metric == "cosine":
            q = l2_normalize(q)
        search_metric = "ip" if self.metric == "cosine" else self.metric
        s, _, group = _shard_of(self.mesh)
        sims, ids = shard_topk(
            self._shard.to(torch.float32), q, k, s, self.ntotal, group,
            metric=search_metric, approx=self.storage != "native",
            storage=self.storage,
        )
        return (finalize_scores(sims, search_metric).cpu().numpy(),
                ids.cpu().numpy())

    # --- shard spill -------------------------------------------------------
    def save_shards(self, directory: Path) -> None:
        """One .npz a shard (rows split evenly, no padding), written by
        rank 0 of the mesh; every rank returns once the files exist."""
        directory = Path(directory)
        _, n_shards, group = _shard_of(self.mesh)
        if dist.get_rank(group) == 0:
            directory.mkdir(parents=True, exist_ok=True)
            db = torch.cat(self._chunks).numpy()
            bounds = np.linspace(0, db.shape[0], n_shards + 1, dtype=int)
            for i in range(n_shards):
                np.savez_compressed(
                    directory / f"shard_{i:04d}.npz",
                    vectors=db[bounds[i] : bounds[i + 1]], metric=self.metric,
                )
        dist.barrier(group)

    @classmethod
    def load_shards(cls, directory: Path, mesh, metric: Optional[str] = None,
                    device="cuda") -> "ShardedFlatIndex":
        files = sorted(Path(directory).glob("shard_*.npz"))
        if not files:
            raise FileNotFoundError(f"no shards in {directory}")
        with np.load(files[0]) as first:
            index = cls(mesh, metric or str(first["metric"]), device=device)
        for f in files:
            with np.load(f) as data:
                # shards were normalised before spilling; add raw
                chunk = torch.from_numpy(data["vectors"]).to(index.dtype)
                index._chunks.append(chunk)
                index._n += chunk.shape[0]
        return index.finalize()


def stream_add(index: ShardedFlatIndex,
               chunks: Iterable[np.ndarray]) -> ShardedFlatIndex:
    """Convenience: add an iterator of host chunks then finalize."""
    for chunk in chunks:
        index.add(chunk)
    return index.finalize()


class ShardedLSHIndex:
    """LSH sharded over the mesh's data axis: the int8 ±1 sketches of a
    rank's rows stay on its device, queries sketch once against the
    replicated projection, every rank takes the Hamming top-k of its
    shard (ops/lsh.py:hamming_topk) and the winner sets merge.

    Hamming distances are exact integers and both the shard-local
    selection and the merge break ties by ascending global id, so results
    are bit-identical to the single-device LSHIndex. The shard-local
    search runs on the shard's real rows only (its first n_valid):
    selection over unique (distance, id) keys has no plan to keep."""

    def __init__(self, mesh, dim: int, nbits: int = 1024, seed: int = 1234,
                 device="cuda"):
        from ..search.lsh import LSHIndex

        self.mesh = mesh
        self.dim = dim
        self.nbits = nbits
        self.seed = seed
        self._sketch = LSHIndex(dim, nbits, seed, device=device)
        self.projection = self._sketch.projection
        self._chunks: List[torch.Tensor] = []  # int8 sign chunks
        self._signs = None  # this rank's real rows [n_local, nbits]
        self._n = 0

    @property
    def ntotal(self) -> int:
        return self._n

    def add(self, vectors) -> "ShardedLSHIndex":
        """Sketch a host chunk on the device and stream it in."""
        self._chunks.append(self._sketch.signs_of(vectors))
        self._n += self._chunks[-1].shape[0]
        self._signs = None
        return self

    def finalize(self) -> "ShardedLSHIndex":
        if not self._chunks:
            raise ValueError("index is empty; call add() first")
        s, n_shards, _ = _shard_of(self.mesh)
        self._rows = -(-self._n // n_shards)
        self._signs = torch.cat(self._chunks)[
            s * self._rows : (s + 1) * self._rows].contiguous()
        return self

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(hamming [Q, k] float32 ascending, global ids [Q, k]) — the
        single-device LSHIndex's FAISS conventions, bit-identical."""
        from ..ops.lsh import hamming_topk

        if self._signs is None:
            self.finalize()
        q_signs = self._sketch.signs_of(queries)
        s, _, group = _shard_of(self.mesh)
        dist_l, ids = hamming_topk(self._signs, q_signs, min(k, self._rows))
        # merge on -distance: bigger is better, ties lower id first
        vals, ids = merge_shards(-dist_l, ids, s * self._rows, self._n, k,
                                 group)
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        hamming = np.where(ids >= 0, -vals, np.inf).astype(np.float32)
        return _pad_k_np(hamming, ids, k, fill=np.inf)


class ShardedGraphIndex:
    """Graph ANN sharded over the mesh: each rank builds the neighbour
    graph of its own shard (search/graph.py:GraphIndex: the exact kNN
    through kernel B, the Threefry long-range edges), the replicated
    queries run the beam search on every shard (kernel K's packed route
    where GraphIndex takes it on the card, else the bf16 row gathers), and
    the winner sets merge. Rows ≥ the shard's n_valid (wrapped pad rows)
    never score, in the entry seeding or the beam."""

    def __init__(self, mesh, metric: str = "cosine", degree: int = 42,
                 beam_width: int = 128, expand: int = 8, n_entry: int = 32,
                 n_pivots: int = 16384, device="cuda"):
        self.mesh = mesh
        self.metric = metric
        self.degree = degree
        self.beam_width = beam_width
        self.expand = expand
        self.n_entry = n_entry
        self.n_pivots = n_pivots  # 0 → shared strided entries
        self.device = resolve_device(device)
        self._local = None  # this rank's GraphIndex
        self._n = 0

    @property
    def ntotal(self) -> int:
        return self._n

    def build(self, vectors) -> "ShardedGraphIndex":
        from ..search.graph import GraphIndex

        v = torch.as_tensor(np.asarray(vectors, dtype=np.float32)).to(
            self.device)
        if self.metric == "cosine":
            v = l2_normalize(v)
        self._n = v.shape[0]
        s, n_shards, _ = _shard_of(self.mesh)
        rows = -(-self._n // n_shards)
        # wrapped REAL rows, not zeros: a zero vector would take adjacency
        # slots in the last shard's graph; n_valid keeps them out of results
        idx = torch.arange(s * rows, (s + 1) * rows, device=v.device) % self._n
        self._local = GraphIndex(
            metric="ip" if self.metric == "cosine" else self.metric,
            degree=self.degree, beam_width=self.beam_width,
            expand=self.expand, n_entry=self.n_entry, device=self.device,
        ).add(v[idx].cpu().numpy())
        return self

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], global ids [Q, k]) — FAISS conventions."""
        from ..search.graph import (
            _seed_entries,
            beam_search,
            beam_search_packed,
        )

        local = self._local
        q_all = torch.as_tensor(np.asarray(queries, dtype=np.float32)).to(
            self.device)
        if self.metric == "cosine":
            q_all = l2_normalize(q_all)
        search_metric = local.metric
        s, _, group = _shard_of(self.mesh)
        rows = local.ntotal
        k_local = min(k, rows)
        n_local = min(max(self._n - s * rows, 0), rows)
        n_piv = min(self.n_pivots, rows) if self.n_pivots > 0 else 0
        dev = self.device
        entry = torch.arange(0, rows, max(rows // max(self.n_entry, 1), 1),
                             dtype=torch.int32, device=dev)[: self.n_entry]
        pivots = torch.arange(0, rows, max(rows // max(n_piv, 1), 1),
                              dtype=torch.int32, device=dev)[:n_piv]
        beam = max(self.beam_width, k_local)
        iters = max(8, beam // max(self.expand, 1) // 2)
        use_packed = local._use_packed()
        if use_packed:
            pv, pi, sc, deg_p = local._packed_state()
        qb = local.query_block(k_local)
        sims_out, ids_out = [], []
        for start in range(0, q_all.shape[0], qb):
            q = q_all[start : start + qb]
            entries = (
                _seed_entries(local._db, pivots, q, self.n_entry,
                              search_metric, n_valid=n_local)
                if n_piv > 0 else entry
            )
            if use_packed:
                sims, ids = beam_search_packed(
                    local._db, pv, pi, sc, q, entries, k_local, deg_p,
                    local._graph.shape[1], beam_width=beam,
                    expand=self.expand, iters=iters, n_valid=n_local,
                )
            else:
                sims, ids = beam_search(
                    local._db, local._graph, q, entries, k_local,
                    beam_width=beam, expand=self.expand, iters=iters,
                    metric=search_metric, n_valid=n_local,
                    db_traversal=local._db_traversal(),
                )
            sims_out.append(sims)
            ids_out.append(ids)
        sims, ids = merge_shards(torch.cat(sims_out), torch.cat(ids_out),
                                 s * rows, self._n, k, group)
        sims, ids = pad_k(sims, ids, k)
        return (finalize_scores(sims, search_metric).cpu().numpy(),
                ids.cpu().numpy())


class ShardedIVFIndex:
    """IVF sharded over the mesh's data axis: each rank builds the
    inverted file of its own shard (search/ivf.py:IVFIndex: k-means,
    balanced cells, int8 slabs), routes the replicated queries against
    its own centroids and scans its probed slabs, and the winner sets
    merge. Two scans, as in the reference:

    * per-probe (`union_budget` 0): each query's probed slabs through
      kernel K (ops/slab_cuda.beam_expand), MAX_PROBE_PER_CALL probes a
      call, then the shortlist's rescore;
    * union (`union_budget` > 0): a block's queries scan the union of its
      `union_budget` most-probed cells (search/ivf.py:_union_scan_one,
      kernel J for ip / cosine).

    `rescore=True` keeps the shard's fp32 rows and rescores each shard's
    shortlist exactly before the merge; `rescore=False` drops them and
    rescores from the dequantised slabs (the lean layout's storage
    quantisation stays caller-visible)."""

    def __init__(self, mesh, metric: str = "cosine", nprobe: int = 16,
                 n_clusters: int = 0, kmeans_iters: int = 16,
                 rescore: bool = True, union_budget: int = 0, device="cuda"):
        self.mesh = mesh
        self.metric = metric
        self.nprobe = nprobe
        self.n_clusters = n_clusters  # 0 → per-shard auto (2·rows/128)
        self.kmeans_iters = kmeans_iters
        self.rescore = rescore
        self.union_budget = max(0, union_budget)  # <= 0: per-probe path
        self.device = resolve_device(device)
        self._local = None  # this rank's IVFIndex
        self._slot = None  # [rows] local id -> packed row (rescore=False)
        self._n = 0
        self._rows = 0

    @property
    def ntotal(self) -> int:
        return self._n

    def build(self, vectors) -> "ShardedIVFIndex":
        from ..search.ivf import IVFIndex

        v = torch.as_tensor(np.asarray(vectors, dtype=np.float32)).to(
            self.device)
        if self.metric == "cosine":
            v = l2_normalize(v)
        self._n = v.shape[0]
        s, n_shards, _ = _shard_of(self.mesh)
        rows = self._rows = -(-self._n // n_shards)
        # wrapped REAL rows (zeros would win the routing of far-out
        # queries); n_valid keeps them out of the results
        idx = torch.arange(s * rows, (s + 1) * rows, device=v.device) % self._n
        local = IVFIndex(
            metric="ip" if self.metric == "cosine" else self.metric,
            nprobe=self.nprobe, n_clusters=self.n_clusters,
            kmeans_iters=self.kmeans_iters, device=self.device,
        ).add(v[idx].cpu().numpy())
        if not self.rescore:
            # local id -> packed row, for the slab rescore; no fp32 rows
            flat_ids = local._packed[1].reshape(-1).long()
            slot = torch.zeros(rows, dtype=torch.int64, device=self.device)
            ok = flat_ids >= 0
            slot[flat_ids[ok]] = torch.arange(
                flat_ids.shape[0], device=self.device)[ok]
            self._slot = slot
            local._db = None
        self._local = local
        return self

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], global ids [Q, k]) — FAISS conventions."""
        from ..search.ivf import (
            CAPACITY,
            IVFIndex,
            _dma_block_one,
            _union_scan_one,
        )

        # The block loop and its sizes are the reference's sharded ones,
        # not IVFIndex.plan_blocks': nprobe (knn_for_homology_tpu/parallel/
        # scale.py:614), the union's fixed budget, shortlist, qb cap and
        # last-block pad (:626-636), the per-probe shortlist (:705), and
        # no route-locality sort. They decide which ids survive, so they
        # stay apart from the single-device loop.
        local = self._local
        q_all = torch.as_tensor(np.asarray(queries, dtype=np.float32)).to(
            self.device)
        if self.metric == "cosine":
            q_all = l2_normalize(q_all)
        metric = local.metric
        s, _, group = _shard_of(self.mesh)
        rows = self._rows
        c_local = local._centroids.shape[0]
        k_eff = min(k, rows, self._n)
        nprobe = min(max(self.nprobe, -(-2 * k_eff // CAPACITY)), c_local)
        rescore = "db" if self.rescore else "slab"
        pv, pi, sc = local._packed
        args = (local._centroids, pv, pi, sc, local._row_sq, local._db,
                self._slot)
        q_n, d = q_all.shape
        if self.union_budget:
            budget = min(self.union_budget, c_local)
            shortlist = min(max(4 * k_eff, CAPACITY), nprobe * CAPACITY)
            qb = min(IVFIndex.QUERY_BLOCK, q_n)
            # the rescore's [qb, shortlist, d] fp32 transient, as the
            # reference caps it
            while qb > 256 and qb * shortlist * d * 4 > 2e9:
                qb //= 2
            # the reference fills the last block with copies of its last
            # query, whose probes count toward cell popularity
            pad = -q_n % qb
            outs = [
                _union_scan_one(
                    q_all[b0 : b0 + qb], *args, metric=metric, k_eff=k_eff,
                    nprobe=nprobe, shortlist=shortlist, rescore=rescore,
                    budget=budget,
                    int8_min_rows=IVFIndex.INT8_UNION_MIN_ROWS,
                    compute="sym" if rescore == "db" else "sym2",
                    pad=pad if b0 + qb >= q_n else 0,
                )
                for b0 in range(0, q_n, qb)
            ]
        else:
            outs = [
                _dma_block_one(
                    q_all[b0 : b0 + IVFIndex.QUERY_BLOCK], *args,
                    metric=metric, k_eff=k_eff, nprobe=nprobe,
                    shortlist=min(max(4 * k_eff, 128), nprobe * CAPACITY),
                    rescore=rescore, max_probe=IVFIndex.MAX_PROBE_PER_CALL,
                )
                for b0 in range(0, q_n, IVFIndex.QUERY_BLOCK)
            ]
        sims, ids = merge_shards(torch.cat([o[0] for o in outs]),
                                 torch.cat([o[1] for o in outs]),
                                 s * rows, self._n, k, group)
        sims, ids = pad_k(sims, ids, k)
        return (finalize_scores(sims, metric).cpu().numpy(),
                ids.cpu().numpy())


class ShardSweep:
    """Many shards on ONE device: shards stream through its memory one at
    a time. Each built shard is spilled to disk (search/io.py) and
    reloaded at query time, so the device never holds more than one; the
    host merges the winner sets. Per-shard build and query times are what
    each rank of a mesh would spend concurrently.

    `index="graph"` (default) spills per-shard GraphIndex shards;
    `index="ivf"` per-shard IVFIndex shards, lean (int8 slabs only) unless
    `store_fp32`."""

    def __init__(self, shard_dir: Path, metric: str = "cosine",
                 degree: int = 42, beam_width: int = 128, expand: int = 8,
                 iters: int = 8, k_local: Optional[int] = None,
                 index: str = "graph", nprobe: int = 16, n_clusters: int = 0,
                 kmeans_iters: int = 8, store_fp32: bool = False,
                 device="cuda"):
        if index not in ("graph", "ivf"):
            raise ValueError(f"unknown shard index type {index!r}")
        self.shard_dir = Path(shard_dir)
        self.shard_dir.mkdir(parents=True, exist_ok=True)
        self.metric = metric
        self.degree = degree
        self.beam_width = beam_width
        self.expand = expand
        self.iters = iters
        self.k_local = k_local
        self.index = index
        self.nprobe = nprobe
        self.n_clusters = n_clusters
        self.kmeans_iters = kmeans_iters
        self.store_fp32 = store_fp32
        self.device = resolve_device(device)
        self._rows: List[int] = []

    @property
    def ntotal(self) -> int:
        return int(sum(self._rows))

    def _path(self, s: int) -> Path:
        return self.shard_dir / f"{self.index}_shard_{s:04d}.npz"

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_shard(self, vectors) -> float:
        """Build shard `len(self._rows)`'s index on the device and spill
        it. Returns the build seconds (device work; the spill excluded)."""
        from ..search.io import write_index

        s = len(self._rows)
        t0 = time.perf_counter()
        if self.index == "ivf":
            from ..search.ivf import IVFIndex

            index = IVFIndex(
                metric=self.metric, nprobe=self.nprobe,
                n_clusters=self.n_clusters, kmeans_iters=self.kmeans_iters,
                store_fp32=self.store_fp32, device=self.device,
            ).add(vectors)
        else:
            from ..search.graph import GraphIndex

            index = GraphIndex(
                metric=self.metric, degree=self.degree,
                beam_width=self.beam_width, expand=self.expand,
                iters=self.iters, device=self.device,
            ).add(vectors)
        self._sync()
        seconds = time.perf_counter() - t0
        write_index(index, self._path(s))
        self._rows.append(index.ntotal)
        return seconds

    def search(self, queries, k: int):
        """Sweep every spilled shard through the device; merge winner sets
        on the host. Returns (scores [Q, k], global ids [Q, k], per-shard
        search seconds)."""
        from ..search.io import read_index

        q = np.asarray(queries, dtype=np.float32)
        k_local = self.k_local or k
        all_sims, all_ids, shard_seconds = [], [], []
        offset = 0
        for s in range(len(self._rows)):
            index = read_index(self._path(s), device=self.device)
            self._sync()  # the load is not the search
            t0 = time.perf_counter()
            sims, ids = index.search(q, min(k_local, index.ntotal))
            shard_seconds.append(time.perf_counter() - t0)
            # back to bigger-is-better merge keys for every metric
            all_sims.append(-sims if self.metric == "l2" else sims)
            all_ids.append(np.where(ids >= 0, ids + offset, -1))
            offset += self._rows[s]
            del index  # free the shard's memory before the next load
        cand_s = np.concatenate(all_sims, axis=1)
        cand_i = np.concatenate(all_ids, axis=1)
        cand_s = np.where(cand_i >= 0, cand_s, -np.inf)
        sel = np.argsort(-cand_s, axis=1, kind="stable")[:, :k]
        top_s, top_i = _pad_k_np(np.take_along_axis(cand_s, sel, axis=1),
                                 np.take_along_axis(cand_i, sel, axis=1), k)
        if self.metric == "l2":
            top_s = -top_s
        return top_s, top_i, shard_seconds
