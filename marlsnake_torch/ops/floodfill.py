"""Bounded flood fill (a reachable-space count) as masked dilation.

The port of the JAX package's ``ops/floodfill.py``: the reference's
count-capped BFS returns ``min(|reachable region|, limit)`` (it stops only
once ``limit`` cells were popped), and ``limit`` rounds of 4-neighbour
dilation reach at least ``min(limit, |region|)`` cells, so capping the
dilated count gives the BFS's answer exactly. The start cell always
counts, passable or not.

``reachable_count`` runs the plain version on CPU tensors and one launch
of the ``reachable_count`` entry of ``csrc/safety_mask.cu`` on CUDA
tensors (``ops/mask_kernel.py``: bit rows on one warp a board, stopping
once a round adds no cell or the count reaches the cap); it never falls
back. ``reachable_count.launches`` counts its launches. The safety mask
(``ops/safety_mask.py``) runs the same fill inside its own kernel.

The plain version, ``reachable_count_plain``, is torch on either device,
batched over any leading axes: one round is five small elementwise
kernels over every board at once (the visited set carries a border, so
its four neighbour reads are shifted views), and ``limit`` rounds cost
``5 * limit`` launches, whatever the batch.
"""

from __future__ import annotations

import torch

from marlsnake_torch.ops import mask_kernel


def reachable_count_plain(passable: torch.Tensor, start: torch.Tensor,
                          limit: int = 60) -> torch.Tensor:
    """Cells reachable from ``start`` through ``passable``, capped at
    ``limit``. ``passable`` (..., H, W) bool, ``start`` (..., 2) integer
    (row, col). A start off the board seeds no cell and counts
    ``min(0, limit)``, as the JAX package's fill counts it. Returns int32
    (...)."""
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
    r, c = start[:, 0], start[:, 1]
    on_board = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    # an off-board start writes False into the border, which stays False
    vis[rows, r.clamp(-1, h) + 1, c.clamp(-1, w) + 1] = on_board
    inner = vis[:, 1:-1, 1:-1]
    for _ in range(limit):
        grown = (vis[:, :-2, 1:-1] | vis[:, 2:, 1:-1]
                 | vis[:, 1:-1, :-2] | vis[:, 1:-1, 2:])
        inner |= grown & boards
    count = inner.sum((-2, -1), dtype=torch.int32).clamp_max(limit)
    return count.reshape(lead)


def reachable_count(passable: torch.Tensor, start: torch.Tensor,
                    limit: int = 60) -> torch.Tensor:
    """``reachable_count_plain`` for CPU tensors; the CUDA kernel for CUDA
    tensors, where ``passable`` must be bool, ``start`` integer and the
    boards at most 224 x 256 (``mask_kernel.check_reachable_args``)."""
    if passable.device.type == 'cpu':
        return reachable_count_plain(passable, start, limit)
    if passable.device.type != 'cuda':
        raise ValueError(f'unsupported device {passable.device}')
    boards, starts = mask_kernel.check_reachable_args(passable, start)
    out = mask_kernel.launch_reachable_count(boards, starts, limit)
    if boards.shape[0]:
        reachable_count.launches += 1
    return out.reshape(passable.shape[:-2])


reachable_count.launches = 0
