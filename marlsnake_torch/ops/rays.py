"""Ray-feature observations (the graph env's transform).

Per snake, 5 rays (forward, left, right, forward-left and forward-right
diagonal) walk outward from the head for ``v`` cells (``vision_range``,
else 5) and sum the cells' channel vectors weighted by distance, ``1/d``
on a cardinal ray and ``1/(d*sqrt(2))`` on a diagonal, up to and
including the first cell whose wall channel is set. The result is
``(B, N, 5, C)`` float32 with zeros for dead snakes.

``ray_features`` reads the encoded uint8 obs; ``ray_features_from_grid``
gathers the same ~5*v cells a snake from the carried grid(s) and encodes
only those, so a caller that wants rays alone never reads the obs. Both
are plain tensor code that runs on either device; they sum the same
float32 terms in the same order and agree exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from marlsnake_torch.core import types as T
from marlsnake_torch.core.engine import bytes_to_planes, frame_bytes, dir_delta

F32 = torch.float32


def _ray_offsets(direction: torch.Tensor, v: int) -> torch.Tensor:
    """(B, N, 5, v, 2) int32 (row, col) offsets of every ray cell."""
    card = torch.stack([direction, (direction - 1) % 4,
                        (direction + 1) % 4], dim=2)              # (B, N, 3)
    card_d = dir_delta(card)                                      # (B, N, 3, 2)
    diag_d = torch.stack([card_d[:, :, 0] + card_d[:, :, 1],
                          card_d[:, :, 0] + card_d[:, :, 2]], dim=2)
    all_d = torch.cat([card_d, diag_d], dim=2)                    # (B, N, 5, 2)
    steps = torch.arange(1, v + 1, dtype=torch.int32,
                         device=direction.device)
    return all_d[:, :, :, None, :] * steps[None, None, None, :, None]


def _weighted_sum(vals: torch.Tensor, wall_hit: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """vals (B, N, 5, v, C) float32, wall_hit (B, N, 5, v) bool -> (B, N,
    5, C): cells behind the first wall hit drop out."""
    v = vals.shape[3]
    # cell j drops out if a cell i < j hit a wall (v is small: a (v, v)
    # mask, not a scan)
    earlier = torch.ones((v, v), dtype=torch.bool,
                         device=vals.device).triu(1)            # [i, j]: i < j
    prior_wall = (wall_hit[..., :, None] & earlier).any(dim=-2)
    include = (~prior_wall).to(F32)
    inv = 1.0 / torch.arange(1, v + 1, dtype=F32, device=vals.device)
    w = torch.cat([inv.expand(3, v), (inv / math.sqrt(2.0)).expand(2, v)])
    feats = (vals * (include * w)[..., None]).sum(dim=3)
    return torch.where(alive[..., None, None], feats, 0.0)


def ray_features(cfg: T.EnvConfig, obs: torch.Tensor, head: torch.Tensor,
                 direction: torch.Tensor, alive: torch.Tensor
                 ) -> torch.Tensor:
    """(B, N, Ho, Wo, C) uint8 obs -> (B, N, 5, C) float32 ray features.
    Ray cells are clamped into the obs, whose centre is the head for
    vision configs."""
    b, n, ho, wo, c = obs.shape
    v = cfg.vision_range if cfg.vision_range else 5
    center = (torch.full_like(head, cfg.vision_range) if cfg.vision_range
              else head)
    cells = center[:, :, None, None, :] + _ray_offsets(direction, v)
    rr = cells[..., 0].clamp(0, ho - 1)
    cc = cells[..., 1].clamp(0, wo - 1)
    flat = (rr * wo + cc).reshape(b, n, 5 * v, 1).long()
    vals = torch.gather(obs.reshape(b, n, ho * wo, c), 2,
                        flat.expand(-1, -1, -1, c))
    vals = vals.view(b, n, 5, v, c).to(F32)
    return _weighted_sum(vals, vals[..., 0] == 1, alive)


def use_grid_rays(cfg: T.EnvConfig) -> bool:
    """True when :func:`ray_features_from_grid` applies: the obs is a
    function of the carried grid(s). Vision configs with a frame stack
    carry encoded windows, not grids, and go through ``ray_features``.
    ``num_snakes <= 16`` is the JAX package's bound (its cells must fit a
    byte); the port keeps it so that both choose the same path."""
    if cfg.num_snakes > 16:
        return False
    return cfg.frame_stack == 1 or not cfg.vision_range


def ray_features_from_grid(cfg: T.EnvConfig, grid: torch.Tensor,
                           head: torch.Tensor, direction: torch.Tensor,
                           alive: torch.Tensor,
                           hist_grid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``ray_features`` of the obs that ``grid`` (B, H, W) encodes to,
    from the grid itself. With ``frame_stack > 1`` (full obs)
    ``hist_grid`` (B, fs - 1, H, W) holds the past grids, oldest first;
    every frame gives its own channel block, and the wall test reads the
    oldest frame, as channel 0 of the stacked obs does."""
    b, n = alive.shape
    h, w = cfg.height, cfg.width
    vr = cfg.vision_range
    v = vr if vr else 5
    off = _ray_offsets(direction, v)                      # (B, N, 5, v, 2)
    if vr:
        # clamp in window coordinates, then map to the grid through the
        # window's corner, which may lie outside it: such cells read EMPTY
        anchor = torch.where(alive[..., None], head, 0)
        rr = anchor[:, :, 0, None, None] - vr + (vr + off[..., 0]).clamp(
            0, 2 * vr)
        cc = anchor[:, :, 1, None, None] - vr + (vr + off[..., 1]).clamp(
            0, 2 * vr)
    else:
        rr = (head[:, :, 0, None, None] + off[..., 0]).clamp(0, h - 1)
        cc = (head[:, :, 1, None, None] + off[..., 1]).clamp(0, w - 1)
    inside = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    flat = (rr.clamp(0, h - 1) * w + cc.clamp(0, w - 1)).reshape(b, -1)

    frames = [grid]
    if cfg.frame_stack > 1:
        frames = [hist_grid[:, i] for i in range(cfg.frame_stack - 1)] + frames
    cells = [torch.where(inside, torch.gather(
        g.reshape(b, h * w), 1, flat.long()).view(rr.shape), T.EMPTY)
        for g in frames]                                  # each (B, N, 5, v)
    vals = torch.cat([bytes_to_planes(frame_bytes(n, c)) for c in cells],
                     dim=-1).to(F32)                      # (B, N, 5, v, 8*fs)
    return _weighted_sum(vals, T.cell_type(cells[0]) == T.WALL, alive)
