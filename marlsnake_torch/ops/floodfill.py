"""Bounded flood fill (a reachable-space count) as masked dilation.

The port of the JAX package's ``ops/floodfill.py``: the reference's
count-capped BFS returns ``min(|reachable region|, limit)`` (it stops only
once ``limit`` cells were popped), and ``limit`` rounds of 4-neighbour
dilation reach at least ``min(limit, |region|)`` cells, so capping the
dilated count gives the BFS's answer exactly. The start cell always
counts, passable or not.

Plain torch on either device, batched over any leading axes: one round is
five small elementwise kernels over every board at once (the visited set
carries a border, so its four neighbour reads are shifted views), and
``limit`` rounds cost ``5 * limit`` launches, whatever the batch.
"""

from __future__ import annotations

import torch


def reachable_count(passable: torch.Tensor, start: torch.Tensor,
                    limit: int = 60) -> torch.Tensor:
    """Cells reachable from ``start`` through ``passable``, capped at
    ``limit``. ``passable`` (..., H, W) bool, ``start`` (..., 2) integer
    (row, col) in the board. Returns int32 (...)."""
    h, w = passable.shape[-2:]
    lead = passable.shape[:-2]
    boards = passable.reshape((-1, h, w))
    start = start.reshape((-1, 2)).long()
    m = boards.shape[0]
    # a border of False around every board: the neighbour reads of a
    # round are then four shifted views of one tensor
    vis = torch.zeros((m, h + 2, w + 2), dtype=torch.bool,
                      device=passable.device)
    rows = torch.arange(m, device=passable.device)
    vis[rows, start[:, 0] + 1, start[:, 1] + 1] = True
    inner = vis[:, 1:-1, 1:-1]
    for _ in range(limit):
        grown = (vis[:, :-2, 1:-1] | vis[:, 2:, 1:-1]
                 | vis[:, 1:-1, :-2] | vis[:, 1:-1, 2:])
        inner |= grown & boards
    count = inner.sum((-2, -1), dtype=torch.int32).clamp_max(limit)
    return count.reshape(lead)
