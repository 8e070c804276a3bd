"""Device meshes over torch.distributed (port of
knn_for_homology_tpu/parallel/mesh.py).

The JAX package runs its sharded programs under `shard_map` over a
`jax.sharding.Mesh` of the devices one process sees. Here every shard is
a process (a rank) and the program is SPMD: each rank calls the same
function on the same replicated inputs, works on its own shard and meets
the others in collectives. A mesh is a `DeviceMesh` with named dimensions
(`init_device_mesh`) over every rank of the process group, in rank order.

Backends are explicit: "nccl" for CUDA tensors, a rank a card; "gloo" for
CPU tensors (the tests' stand-in for the 8-device virtual mesh) or, when
the caller asks for it, for ranks that share one card. Gloo's collectives
take host tensors here: `all_gather` and `all_reduce` stage a CUDA tensor
through host memory on a gloo group, and say so in their docstrings; the
mesh's own device type is then "cpu", never a silent switch of where the
tensors live.

`spawn(fn, world_size, device, backend)` runs `fn(*args)` on every rank of
a fresh process group (torch.multiprocessing with a file:// store) and
returns each rank's result to the caller. The children import `fn`'s
module, so it must import neither jax nor the JAX package.
"""

import contextlib
import datetime
import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"  # database/query sharding axis
MODEL_AXIS = "model"  # tensor-parallel axis for the encoder


def default_backend(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


@contextlib.contextmanager
def process_group(backend: str, rank: int = 0, world_size: int = 1,
                  store: Optional[str] = None,
                  timeout: Optional[datetime.timedelta] = None):
    """This process as `rank` of a `world_size` group on `backend`, met
    through the file `store` (a fresh temporary one when None; a
    one-rank NCCL group needs a store too). `timeout` bounds the meeting
    and every collective (torch's default when None). Destroys the group
    on exit."""
    with contextlib.ExitStack() as stack:
        if store is None:
            store = os.path.join(
                stack.enter_context(tempfile.TemporaryDirectory()), "store")
        extra = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world_size, **extra)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank, fn, args, world_size, device, backend, tmp):
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    with process_group(backend, rank, world_size, os.path.join(tmp, "store")):
        out = fn(*args)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def spawn(fn, world_size: int, device="cuda", backend: Optional[str] = None,
          args: Sequence = ()):
    """Run `fn(*args)` on `world_size` new processes, ranks of one group
    on `backend` (default: `default_backend(device)`), and return their
    results, rank 0 first. NCCL needs a card a rank; several ranks share
    one card only on gloo, which the caller must ask for."""
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if backend == "nccl" and (
        device.type != "cuda" or torch.cuda.device_count() < world_size
    ):
        raise ValueError(
            f"nccl needs a card a rank: {world_size} ranks, device {device}"
            f" with {torch.cuda.device_count()} cards; pass backend='gloo'"
            " to share one")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="knn_spawn_") as tmp:
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, tuple(args), world_size, str(device), backend, tmp))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    shape: Optional[Sequence[int]] = None,
):
    """A DeviceMesh over the process group's ranks in rank order, with the
    named dimensions `axis_names`. Each rank of the group must call it. A
    torch mesh spans the whole group, so `n_devices` (default: the world
    size) must equal it. Its device type is "cuda" on NCCL and "cpu" on
    gloo (see the module docstring)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans all {world} ranks, not {n}")
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def replicated(mesh):
    """DTensor placements of an array replicated on every rank."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))


def row_sharded(mesh, axis: str = DATA_AXIS):
    """DTensor placements of an array whose rows split over `axis` (and
    that is replicated over the mesh's other dimensions)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def _staged(group, tensor: torch.Tensor) -> bool:
    return tensor.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_gather(tensor: torch.Tensor, group) -> torch.Tensor:
    """[ranks of `group`, *tensor.shape]: every rank's tensor, in group rank
    order. On a gloo group a CUDA tensor goes through host memory (a copy
    each way)."""
    src = tensor.contiguous()
    if _staged(group, src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(tensor.device)


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of every rank's tensor, as a new tensor. On a
    gloo group a CUDA tensor goes through host memory (a copy each way)."""
    out = tensor.contiguous().clone()
    if _staged(group, out):
        host = out.cpu()
        dist.all_reduce(host, group=group)
        return host.to(tensor.device)
    dist.all_reduce(out, group=group)
    return out
