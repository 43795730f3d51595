"""The ranks of a data-parallel run, and how a state is laid out on them.

The JAX package lays its state out on a ``jax.sharding.Mesh`` with one
``data`` axis: the env batch and the replay ring split along it, the
learner replicated. Here a rank is a process that owns one device, and
the mesh is the default process group: ``Mesh`` holds its size, this
rank's index and device, and the group the collectives run over. A
process with no group is a mesh of one rank, so single-process use needs
no setup (and issues no collective).

``shard_rows`` and ``replicate`` are the counterparts of ``global_put``
with ``data_sharding`` and with ``replicated``: every rank builds the same
global value, and keeps its own rows of it or rank 0's copy of it.
``shard_rows_tree`` and ``replicate_tree`` do so over a whole state
(``global_put_tree``). The port carries no PRNG keys, so ``global_put``'s
key branch has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from marlsnake_torch.device import resolve_device

_OPS = {'sum': dist.ReduceOp.SUM, 'min': dist.ReduceOp.MIN,
        'max': dist.ReduceOp.MAX}


@dataclasses.dataclass
class Mesh:
    world: int                 # ranks in the group
    rank: int                  # this rank
    device: torch.device       # this rank's device
    group: Optional[Any] = None  # the process group; None: one process

    def all_reduce(self, t: torch.Tensor, op: str = 'sum') -> torch.Tensor:
        """``t`` reduced over the ranks in place ('sum', 'min' or 'max');
        as it is with no group."""
        if self.group is not None:
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each tensor (one dtype), JAX's
        ``pmean``: one all-reduce of one flat buffer, divided by the
        world size. Each result keeps its tensor's memory layout (conv
        weight gradients come channels-last), so that a reduction over it
        (the clip's norm) sums in the order it would without the mesh."""
        tensors = [t if _dense(t) else t.contiguous() for t in tensors]
        flat = torch.cat([t.as_strided((t.numel(),), (1,))
                          for t in tensors])
        self.all_reduce(flat).div_(self.world)
        return [part.as_strided(t.shape, t.stride()) for part, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)]

    def barrier(self) -> None:
        """Wait until every rank is here: an all-reduce of one element on
        this rank's device, so that it behaves alike under NCCL and gloo."""
        self.all_reduce(torch.zeros((1,), device=self.device))


def _dense(t: torch.Tensor) -> bool:
    """True when ``t``'s elements fill one run of memory without gaps or
    overlap (contiguous in some order of its axes)."""
    expected = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def make_mesh(n_devices: Optional[int] = None, device='cuda') -> Mesh:
    """The mesh of the initialized default process group, one device a
    rank, or of this process alone when there is no group. ``device``
    'cuda' with no index is the current CUDA device (``distributed
    .initialize`` sets it for the rank). A mesh spans the whole group:
    ``n_devices`` other than its size raises."""
    if dist.is_available() and dist.is_initialized():
        group, world, rank = (dist.group.WORLD, dist.get_world_size(),
                              dist.get_rank())
    else:
        group, world, rank = None, 1, 0
    if n_devices is not None and n_devices > world:
        raise ValueError(f'requested {n_devices} devices, have {world}')
    if n_devices is not None and n_devices < world:
        raise ValueError(f'requested {n_devices} devices of a group of '
                         f'{world} ranks: a mesh spans every rank')
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return Mesh(world, rank, dev, group)


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """``tree`` with ``fn`` applied to every tensor in it: through
    dataclasses, named tuples, tuples, lists and dicts; other leaves (the
    counters, shapes) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(map_tensors(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of ``x``, a global value every rank built alike:
    the leading axis cut into ``world`` equal runs, run ``rank``, as a
    new tensor on the rank's device."""
    rows = x.shape[0]
    if rows % mesh.world:
        raise ValueError(f'{rows} rows do not split over {mesh.world} ranks')
    k = rows // mesh.world
    return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device, copy=True)


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank, as a new tensor on the rank's device
    (a broadcast from rank 0; bool tensors travel as bytes)."""
    y = x.to(mesh.device, copy=True)
    if mesh.group is not None:
        dist.broadcast(y.view(torch.uint8) if y.dtype == torch.bool else y,
                       src=0, group=mesh.group)
    return y


def shard_rows_tree(tree, mesh: Mesh):
    return map_tensors(lambda x: shard_rows(x, mesh), tree)


def replicate_tree(tree, mesh: Mesh):
    return map_tensors(lambda x: replicate(x, mesh), tree)
