"""Uniform replay ring kept on the device.

A ring of ``capacity`` transitions as tensors on one device: a push is a
scatter, a sample is a gather, and neither reads a value back to the host.
Observations are stored as uint8, the env's own obs type, and flat, as
the JAX package's ``algo/replay.py`` stores them.

Unlike the JAX ring this one is updated in place (``push`` writes into
the buffer it is given and returns it), and it has one row more than its
capacity: PyTorch has no scatter that drops a write, so every masked-out
row is written to that last row, which nothing ever reads. The random
numbers of a sample come in as an argument (``marlsnake_torch.rng``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from marlsnake_torch.device import resolve_device


@dataclasses.dataclass
class ReplayBuffer:
    obs: torch.Tensor        # (cap + 1, prod(obs_shape)) uint8
    action: torch.Tensor     # (cap + 1,) int32
    reward: torch.Tensor     # (cap + 1,) float32
    next_obs: torch.Tensor   # (cap + 1, prod(obs_shape)) uint8
    done: torch.Tensor       # (cap + 1,) bool
    ptr: torch.Tensor        # () int32: the next slot to write
    size: torch.Tensor       # () int32: filled slots
    obs_shape: Tuple[int, ...] = ()

    @property
    def capacity(self) -> int:
        return self.obs.shape[0] - 1

    def fields(self):
        """(name, tensor) pairs of the seven tensors."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self) if f.name != 'obs_shape']


def create(capacity: int, obs_shape: Tuple[int, ...],
           device='cuda') -> ReplayBuffer:
    dev = resolve_device(device)
    flat = math.prod(obs_shape)
    rows = capacity + 1

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return ReplayBuffer(
        obs=zeros((rows, flat), torch.uint8),
        action=zeros((rows,), torch.int32),
        reward=zeros((rows,), torch.float32),
        next_obs=zeros((rows, flat), torch.uint8),
        done=zeros((rows,), torch.bool),
        ptr=zeros((), torch.int32), size=zeros((), torch.int32),
        obs_shape=tuple(obs_shape))


def push(buf: ReplayBuffer, obs, action, reward, next_obs, done,
         mask: Optional[torch.Tensor] = None) -> ReplayBuffer:
    """Push a batch of transitions in place; ``mask`` (n,) bool selects
    the rows that count. Row i of the active rows goes to slot
    ``(ptr + i) % capacity``; masked-out rows go to the spare last row.

    More active rows than ``capacity`` in one push write some slots
    twice, and which write stays is not determined (nor is it in the JAX
    ring): keep a push at or under the capacity.
    """
    n = obs.shape[0]
    cap = buf.capacity
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=obs.device)
    offs = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = torch.where(mask, (buf.ptr + offs) % cap, cap).long()
    num = mask.sum(dtype=torch.int32)
    buf.obs.index_copy_(0, slots, obs.to(torch.uint8).reshape(n, -1))
    buf.action.index_copy_(0, slots, action.to(torch.int32))
    buf.reward.index_copy_(0, slots, reward.to(torch.float32))
    buf.next_obs.index_copy_(0, slots,
                             next_obs.to(torch.uint8).reshape(n, -1))
    buf.done.index_copy_(0, slots, done.to(torch.bool))
    # in place, as every other field: a captured graph reads and writes
    # the ring at fixed addresses (utils/cuda_graph.py)
    buf.ptr.copy_((buf.ptr + num) % cap)
    buf.size.copy_(torch.clamp(buf.size + num, max=cap))
    return buf


def sample_indices(buf: ReplayBuffer, batch_size: int, u: torch.Tensor,
                   replace: bool = False) -> torch.Tensor:
    """Indices of a uniform sample of ``batch_size`` filled slots.

    Without replacement (the default, the reference's ``random.sample``):
    ``u`` (capacity,) are sort keys; unfilled slots get keys above 1 and
    sort last, the first ``batch_size`` of a stable argsort are taken,
    and when fewer than ``batch_size`` slots are filled the tail wraps by
    ``% size`` (duplicates only then). With replacement, or when the
    batch exceeds the ring: ``u`` (batch_size,) are uniforms and the
    index is ``floor(u * size)``. The JAX ring draws that case with
    ``randint`` and no uniform, so this branch alone cannot be fed the
    JAX numbers: a comparison hands ``sample`` the JAX indices (``idx``).
    """
    cap = buf.capacity
    size = buf.size.clamp(min=1)
    if replace or batch_size > cap:
        idx = (u[:batch_size] * size).long()
        return torch.minimum(idx, size.long() - 1)
    slot = torch.arange(cap, device=u.device)
    keys = u + (slot >= buf.size).to(u.dtype) * 2.0
    return torch.argsort(keys, stable=True)[:batch_size] % size


def sample(buf: ReplayBuffer, batch_size: int,
           u: Optional[torch.Tensor] = None, replace: bool = False,
           idx: Optional[torch.Tensor] = None):
    """(obs, action, reward, next_obs, done) of ``batch_size`` sampled
    transitions, obs in ``obs_shape``. The sample is drawn by
    ``sample_indices`` from ``u``, or is ``idx`` where that is given."""
    if idx is None:
        idx = sample_indices(buf, batch_size, u, replace)
    idx = idx.long()
    bshape = (batch_size,) + buf.obs_shape
    return (buf.obs[idx].view(bshape), buf.action[idx], buf.reward[idx],
            buf.next_obs[idx].view(bshape), buf.done[idx])
