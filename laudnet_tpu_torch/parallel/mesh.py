"""Process groups, device meshes and the batch's placement (counterpart of
`laudnet_tpu/parallel/mesh.py`).

The JAX package runs data parallelism as one program over a mesh of devices
with the batch sharded on its 'data' axis. The port runs one process per
device (one rank per card, or per CPU process over gloo), joined by
``torch.distributed``: `initialize_distributed` joins the group, `make_mesh`
lays the ranks out as a ``DeviceMesh`` with the dims ``("data",)`` or
``("data", "model")`` (the model dim inner, as the JAX mesh's), and each
rank holds its slice of the global batch (`shard_batch`,
`put_global_batch`). What the single jitted program does implicitly, the
train step does explicitly (`train/trainer.py`): the gate densities and
BatchNorm's statistics are means over the global batch
(`ops/batch_stats.py`), and the gradients are averaged over the 'data' dim.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from laudnet_tpu_torch.device import resolve_device


def process_device(process_id: int = 0, device=None) -> torch.device:
    """The device of rank ``process_id``: ``cuda:{process_id % cards}`` on
    the card (a machine without one raises), the CPU when asked for."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device in this process; pass "
                           "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", process_id % cards)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *, device=None,
                           backend: str | None = None) -> torch.device:
    """Joins the process group (the reference's ``dist.init_process_group``,
    `train/main.py:261-262`): ``tcp://<coordinator_address>``, NCCL for a
    rank on a card and gloo on the CPU (``backend`` overrides). Without a
    coordinator it joins nothing: one process needs no group. With one it
    joins, a group of one process included. Returns this process's device
    (`process_device`), made the current CUDA device on a card.

    A coordinator without a process count raises, as JAX's does: each
    process would otherwise train alone on the whole data set and overwrite
    the others' checkpoints."""
    if coordinator_address and not num_processes:
        raise ValueError(
            "initialize_distributed: coordinator_address given but "
            "num_processes is unset — pass --dist_num_processes (and a "
            "per-host process_id)")
    if num_processes and num_processes > 1 and not coordinator_address:
        raise ValueError("initialize_distributed: num_processes > 1 needs a "
                         "coordinator_address (--dist_coordinator)")
    if num_processes and num_processes > 1 and process_id is None:
        raise ValueError("initialize_distributed: num_processes > 1 needs "
                         "this process's process_id (--dist_process_id)")
    rank = process_id or 0
    device = process_device(rank, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if coordinator_address and not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=rank)
    return device


def free_port() -> int:
    """A free TCP port on this host, for a coordinator on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_ranks(n_devices: int | None, device) -> tuple[str, int]:
    """``(device type, ranks)`` for a mesh over the whole group. A process
    that joined no group joins one of one rank on an in-memory store (a
    mesh needs a group; one process has no peers to find)."""
    device_type = resolve_device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the port runs one rank per device; "
                         f"n_devices={n_devices} but the group has {world} "
                         f"ranks")
    return device_type, world


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              model_parallel: int = 1, *, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` over the group's ranks, one device each: dims
    ``(axis_name,)``, or ``(axis_name, "model")`` for ``model_parallel >
    1``, whose model dim is the inner one (consecutive ranks form a
    tensor-parallel group, `parallel/tp.py`). ``device``: the card unless
    the CPU is asked for."""
    device_type, world = mesh_ranks(n_devices, device)
    if model_parallel > 1:
        if world % model_parallel:
            raise ValueError(f"{world} devices not divisible by "
                             f"model_parallel={model_parallel}")
        return init_device_mesh(device_type, (world // model_parallel,
                                              model_parallel),
                                mesh_dim_names=(axis_name, "model"))
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(axis_name,))


def data_parallel_shardings(mesh: DeviceMesh, axis_name: str = "data"):
    """(batch placements, replicated placements) on ``mesh``: the batch
    split on its leading dim over ``axis_name`` (``Shard(0)``), replicated
    over any other dim."""
    batch = tuple(Shard(0) if name == axis_name else Replicate()
                  for name in mesh.mesh_dim_names)
    return batch, tuple(Replicate() for _ in mesh.mesh_dim_names)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank runs on within ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: DeviceMesh, axis_name: str = "data"):
    """This rank's slice of a global batch (a tensor, an array or a dict,
    list or tuple of them), on its device: the leading dim split evenly
    over ``axis_name`` (ranks that share a data index get the same
    rows)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    i = mesh.get_local_rank(axis_name)
    device = mesh_device(mesh)

    def local(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible over the "
                             f"{axis_name!r} dim ({n})")
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows].to(device)

    return _tree_map(local, batch)


def put_global_batch(x, mesh: DeviceMesh, axis_name: str = "data"):
    """This rank's rows of the global batch from the host-local rows every
    process loaded (``global batch // processes`` each, in rank order):
    the ranks that share a data index (a tensor- or pipeline-parallel
    group) concatenate theirs, so each holds its data slice whole. On a
    'data'-only mesh that is the local rows, moved to the device."""
    x = torch.as_tensor(x).to(mesh_device(mesh))
    others = [n for n in mesh.mesh_dim_names if n != axis_name]
    if not others:
        return x
    if len(others) > 1:
        raise ValueError("put_global_batch: at most one dim beside the data "
                         "dim")
    group = mesh.get_group(others[0])
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


@torch.no_grad()
def replicate(tree, mesh: DeviceMesh):
    """Broadcasts the first rank's tensors to every rank of ``mesh``, in
    place: a module's parameters and buffers, or the tensors of a dict,
    list or tuple. Returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = []
        _tree_map(lambda t: tensors.append(t) if torch.is_tensor(t) else t,
                  tree)
    for t in tensors:
        dist.broadcast(t.data, src=src)
    return tree
