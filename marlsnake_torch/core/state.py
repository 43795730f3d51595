"""EnvState: a batch of environments as tensors, batch axis first.

Snake bodies are fixed-capacity direction rings, 2-bit packed: 16 slots
per int32 word, slot ``s`` at bits ``2 * (s & 15)`` of word ``s >> 4``.
Logical slot ``ring_head`` holds the newest (head-side) link and the
oldest (tail-side) link sits at ``(ring_head + ring_len - 1) % cap``.
The layout and the ring ops are those of the JAX package's
``core/state.py``; the ops here take any leading batch axes.
"""

from __future__ import annotations

import dataclasses

import torch

from marlsnake_torch.core import types as T


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Frozen, so ``replace`` makes a new state: the CUDA step wrapper
    feeds a state it returned back to the kernel as that step's output
    arena, which a rebound field would silently bypass."""

    grid: torch.Tensor            # (B, H, W) int32: type | owner << 4
    direction: torch.Tensor       # (B, N) int32 heading
    head: torch.Tensor            # (B, N, 2) int32 (row, col)
    tail: torch.Tensor            # (B, N, 2) int32 (row, col)
    ring: torch.Tensor            # (B, N, ceil(cap / 16)) int32
    ring_head: torch.Tensor       # (B, N) int32
    ring_len: torch.Tensor        # (B, N) int32, body length - 1
    alive: torch.Tensor           # (B, N) bool
    # (B,) int32 running alive counter, with the reference's
    # double decrement on tail-chase deaths
    alive_count: torch.Tensor
    epi_scores: torch.Tensor      # (B, N) float32 episodic stats
    epi_steps: torch.Tensor
    epi_fruits: torch.Tensor
    epi_kills: torch.Tensor
    episode_length: torch.Tensor  # (B,) int32
    # Frame-stack history. Full-obs configs with frame_stack > 1 carry
    # the frame_stack - 1 past raw grids, oldest first, and re-encode
    # them for every obs; vision configs carry the encoded window frames,
    # oldest first. Each axis has length 0 where its mechanism is off.
    hist_grid: torch.Tensor       # (B, fs - 1, H, W) int32
    obs_stack: torch.Tensor       # (B, fs, N, Ho, Wo, C) uint8

    def replace(self, **changes) -> 'EnvState':
        return dataclasses.replace(self, **changes)

    def fields(self):
        """(name, tensor) pairs in declaration order."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)]

    @property
    def num_envs(self) -> int:
        return self.grid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @property
    def body_length(self) -> torch.Tensor:
        """(B, N) int32: head, body and tail cells of each snake."""
        return self.ring_len + 1


def ring_num_words(cap: int) -> int:
    """int32 words backing a ``cap``-slot 2-bit-packed ring."""
    return -(-cap // 16)


def ring_pack_prefix(dirs: torch.Tensor, cap: int) -> torch.Tensor:
    """Pack directions (..., L) int32 into slots 0..L-1 of a fresh ring
    (rest zero); returns (..., ring_num_words(cap)) int32."""
    length = dirs.shape[-1]
    words = []
    for i in range(ring_num_words(cap)):
        wv = torch.zeros(dirs.shape[:-1], dtype=torch.int32,
                         device=dirs.device)
        for j in range(i * 16, min(length, i * 16 + 16)):
            wv = wv | (dirs[..., j] << (2 * (j & 15)))
        words.append(wv)
    return torch.stack(words, dim=-1)


def ring_slots(ring: torch.Tensor, cap: int) -> torch.Tensor:
    """Unpack a ring (..., CW) to one direction per slot (..., cap), for
    introspection; the ring ops below never unpack."""
    slots = torch.arange(cap, dtype=torch.int32, device=ring.device)
    return (ring[..., slots >> 4] >> (2 * (slots & 15))) & 3


def ring_push(ring, ring_head, ring_len, direction, mask, cap: int):
    """Append a head-side direction where ``mask`` is True.

    ring (..., CW) int32 with ring_head, ring_len, direction and mask of
    the leading shape. Returns (ring, ring_head, ring_len).
    """
    cw = ring.shape[-1]
    new_head = torch.where(mask, (ring_head - 1) % cap, ring_head)
    b0 = 2 * (new_head & 15)
    three = torch.full_like(b0, 3)
    blended = ((ring & (~(three << b0)).unsqueeze(-1))
               | ((direction & 3) << b0).unsqueeze(-1))
    words = torch.arange(cw, dtype=torch.int32, device=ring.device)
    sel = ((new_head >> 4).unsqueeze(-1) == words) & mask.unsqueeze(-1)
    updated = torch.where(sel, blended, ring)
    new_len = torch.where(mask, ring_len + 1, ring_len)
    return updated, new_head, new_len


def ring_pop_tail(ring, ring_head, ring_len, mask, cap: int):
    """Pop the oldest (tail-side) direction where ``mask`` is True.

    Returns (popped direction, valid where mask; new ring_len).
    """
    new_len = torch.where(mask, ring_len - 1, ring_len)
    return tail_direction(ring, ring_head, ring_len, cap), new_len


def tail_direction(ring, ring_head, ring_len, cap: int) -> torch.Tensor:
    """Direction of the oldest (tail-side) link, for any leading axes."""
    idx = (ring_head + ring_len - 1) % cap
    word = torch.gather(ring, -1, (idx >> 4).long().unsqueeze(-1)
                        ).squeeze(-1)
    return (word >> (2 * (idx & 15))) & 3


def body_coords_mask(state: EnvState, snake_idx: int) -> torch.Tensor:
    """(B, H, W) bool: the cells owned by ``snake_idx`` (head, body and
    tail) in each env."""
    return ((T.cell_type(state.grid) >= T.HEAD)
            & (T.cell_owner(state.grid) == snake_idx))
