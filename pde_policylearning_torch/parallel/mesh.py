"""Process groups for data and model parallelism on torch.distributed.

Counterpart of `pde_policylearning_tpu/parallel/mesh.py` (reference:
neuralop/mpu/comm.py:100-223, NCCL process groups with a file/TCP
rendezvous and the model/data group factorization).  The JAX package names
a ('data', 'model') device mesh and lets XLA insert the collectives; here
a `Mesh` holds the two process groups of this rank and the collectives are
explicit.

Layout (the reference's and the JAX mesh's): rank r is data index
r // mp and model index r % mp.  Model groups are contiguous blocks of mp
ranks, data groups the strided sets {m, m + mp, ...}.  NCCL on a card
(one rank per card), gloo on the CPU; the backend follows the device and
never falls back from one to the other.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(eq=False)
class Mesh:
    """The ('data', 'model') factorization of the default process group
    as seen from one rank: `dp` x `mp` ranks, this rank's two groups, its
    device and the backend."""
    world_size: int
    rank: int
    dp: int
    mp: int
    data_group: object
    model_group: object
    device: torch.device
    backend: str

    @property
    def data_rank(self) -> int:
        """This rank's index along 'data' (its model group's index)."""
        return self.rank // self.mp

    @property
    def model_rank(self) -> int:
        """This rank's index along 'model' (its place in its model
        group)."""
        return self.rank % self.mp

    def axis(self, name: str):
        """(group, size, index of this rank) of one axis."""
        if name == DATA_AXIS:
            return self.data_group, self.dp, self.data_rank
        if name == MODEL_AXIS:
            return self.model_group, self.mp, self.model_rank
        raise ValueError(f"unknown mesh axis {name!r}")


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU.  Raises where the
    device's backend is missing: no fallback from one to the other."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this torch build; "
                               "a CUDA mesh needs it")
        return "nccl"
    if dev.type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("gloo is not available in this torch build")
        return "gloo"
    raise ValueError(f"no process-group backend for device {dev}")


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None,
                     timeout: float = 300.0) -> Optional[str]:
    """Join the default process group (comm.py:100-158): NCCL for a CUDA
    device (None: the card; one rank per card, this rank's card made
    current), gloo for device='cpu'.  Does nothing for a single process
    given no `init_method`, and nothing when a group already exists, as
    the JAX function does.  Returns the backend, or None when it did
    nothing."""
    if dist.is_initialized():
        return None
    if init_method is None and (world_size is None or world_size <= 1):
        return None
    backend = backend_for(device)
    if backend == "nccl":
        dev = resolve_device(device)
        index = dev.index if dev.index is not None else (
            (rank or 0) % torch.cuda.device_count())
        torch.cuda.set_device(index)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size or 1,
        rank=rank or 0, timeout=datetime.timedelta(seconds=timeout))
    return backend


def _new_group(ranks, world_size):
    """The whole world's group, or a new one over `ranks`.  Every rank
    calls this for every group, in the same order (new_group's rule)."""
    if len(ranks) == world_size:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(model_parallel_size: int = 1, device=None) -> Mesh:
    """The ('data', 'model') mesh of the default process group, data size
    inferred from the world size (comm.py:184-223).  Without a process
    group: a mesh of one rank whose collectives do nothing.  `device`
    defaults to the backend's (this rank's card under NCCL, the CPU
    under gloo; without a group, the card)."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if backend == "nccl" else torch.device("cpu"))
    else:
        world, rank, backend = 1, 0, "none"
    device = resolve_device(device)
    mp = model_parallel_size
    if world % mp != 0:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel_size={mp}")
    dp = world // mp
    data_group = model_group = None
    if dist.is_initialized():
        for d in range(dp):
            g = _new_group([d * mp + m for m in range(mp)], world)
            if d == rank // mp:
                model_group = g
        for m in range(mp):
            g = _new_group([d * mp + m for d in range(dp)], world)
            if m == rank % mp:
                data_group = g
    return Mesh(world_size=world, rank=rank, dp=dp, mp=mp,
                data_group=data_group, model_group=model_group,
                device=device, backend=backend)


def get_data_parallel_size(mesh: Mesh) -> int:
    return mesh.dp


def get_model_parallel_size(mesh: Mesh) -> int:
    return mesh.mp


def axis_slice(mesh: Mesh, n: int, axis_name: str = DATA_AXIS) -> slice:
    """This rank's block of a leading axis of length n split evenly over
    `axis_name`."""
    _, size, index = mesh.axis(axis_name)
    if n % size != 0:
        raise ValueError(f"leading axis {n} not divisible by the "
                         f"{axis_name!r} axis size {size}")
    k = n // size
    return slice(index * k, (index + 1) * k)


def shard_batch(mesh: Mesh, *arrays, axis_name: str = DATA_AXIS):
    """This rank's block of each array's leading axis over `axis_name`, on
    the mesh's device."""
    out = tuple(a[axis_slice(mesh, a.shape[0], axis_name)].to(mesh.device)
                for a in arrays)
    return out[0] if len(out) == 1 else out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [t.data for t in (*tree.parameters(), *tree.buffers())]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank (parameters, optimizer state): each
    tensor of `tree` (a tensor, a module's parameters and buffers, or
    dicts and sequences of them) broadcast in place.  Returns `tree`."""
    if mesh.data_group is None:
        return tree
    for t in _tensors(tree):
        dist.broadcast(_real(t), src=0)
    return tree


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce_gradients(mesh: Mesh, params, model_split: bool = False):
    """Gradients of the global batch on every rank, in one all-reduce over
    the world of every gradient packed into one buffer: averaged over
    'data', and over 'model' summed where the model ranks computed
    disjoint shares of the batch (`model_split`, a patch batch scattered
    over the model group), else averaged (the model ranks computed the
    same).  Parameters without a gradient are left alone."""
    if mesh.data_group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([_real(g).reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.dp if model_split else mesh.world_size
    i = 0
    for g in grads:
        view = _real(g)
        view.copy_(flat[i:i + view.numel()].view_as(view))
        i += view.numel()


def gather(mesh: Mesh, t: torch.Tensor, axis_name: str, dim: int = 0):
    """The whole of a tensor split along `dim` over one mesh axis: an
    all-gather, the blocks in rank order."""
    group, size, _ = mesh.axis(axis_name)
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def ordered_sum(mesh: Mesh, t: torch.Tensor, axis_name: str):
    """The sum of `t` over one mesh axis, the same bits on every rank: an
    all-gather, then a sum in rank order (an all-reduce may round
    differently from rank to rank)."""
    parts = gather(mesh, t[None], axis_name)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def split_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Per-data-rank batch (torch_setup.py:44-48 divisibility contract)."""
    dp = get_data_parallel_size(mesh)
    if global_batch % dp != 0:
        raise ValueError(
            f"Batch size {global_batch} not divisible by data-parallel "
            f"size {dp}")
    return global_batch // dp
