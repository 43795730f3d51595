"""The safety mask of the masked DQN policies: plain version and kernel.

The port of the JAX package's ``algo/evaluator.py`` masking (the
reference's inference-time masking, ``DQN_Evaluator.get_action``): a
snake's three moves are vetoed when

1. the target is off the board, or holds a wall, a body, a tail or an
   enemy head (the deadly channels),
2. an earlier snake of the same env claimed the target this step,
3. a 4-neighbour of the target holds an enemy head (head-to-head risk),
4. the space reachable from the target on the post-move board (old head
   turned to body, the tail cleared unless the move eats) is smaller than
   the snake's post-move length (``ops/floodfill.py``),

and the snake takes the argmax of its Q-values over what is left (the
first move where all three are vetoed, as ``jnp.argmax`` of three
``-inf``).

``safety_mask`` is the wrapper of the whole mask of E envs x N snakes:
on CPU tensors the plain version, ``masked_actions_plain``; on CUDA
tensors one launch of the ``masked_actions`` entry of
``csrc/safety_mask.cu`` (``ops/mask_kernel.py``), or it raises.
``safety_mask.launches`` counts the launches. ``masked_actions``,
``masked_action_single`` and the battle's ``masked_seat0`` go through it,
so every masked path costs one launch a step on the card.

In the plain version every veto but the claims reads one snake's own obs,
so all of them are computed for every (env, snake, move) at once, the
flood fills in one ``flood_limit``-long loop (``reachable_count_plain``);
only the claims and the argmax run snake by snake, which is exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from marlsnake_torch.core import types as T
from marlsnake_torch.ops import mask_kernel
from marlsnake_torch.ops.floodfill import reachable_count_plain
from marlsnake_torch.ops.mask_kernel import MaskOut

DEADLY_CHANNELS = (T.CH_WALL, T.CH_OTHER_HEAD, T.CH_OTHER_BODY,
                   T.CH_OTHER_TAIL, T.CH_MY_BODY, T.CH_MY_TAIL)
# neighbour probe order the reference infers a direction with (first
# match wins)
_PROBE = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _cells(board: torch.Tensor, y: torch.Tensor, x: torch.Tensor
           ) -> torch.Tensor:
    """``board`` (S, H, W) read at (S, K) in-board coordinates."""
    w = board.shape[-1]
    return board.flatten(1).gather(1, (y * w + x).long())


def _deadly_map(obs: torch.Tensor) -> torch.Tensor:
    """(S, H, W) bool: any deadly channel set."""
    return (obs[..., list(DEADLY_CHANNELS)] == 1).any(-1)


def _derive_dir(obs: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(S, 2) direction from the own body cell next to the head, probed in
    the reference's order; UP where there is none."""
    h, w = obs.shape[1:3]
    probe = torch.tensor(_PROBE, dtype=torch.int32, device=obs.device)
    by = head[:, :1] - probe[:, 0]
    bx = head[:, 1:] - probe[:, 1]
    inb = (by >= 0) & (by < h) & (bx >= 0) & (bx < w)
    body = (obs[..., T.CH_MY_BODY] == 1) | (obs[..., T.CH_MY_TAIL] == 1)
    hit = inb & _cells(body, by.clamp(0, h - 1), bx.clamp(0, w - 1))
    first = probe[hit.to(torch.uint8).argmax(-1)]
    up = torch.tensor((-1, 0), dtype=torch.int32, device=obs.device)
    return torch.where(hit.any(-1, keepdim=True), first, up)


class _Moves(NamedTuple):
    """One snake's three moves (S snakes), vetoed for all but claims."""
    head: torch.Tensor         # (S, 2) int32
    head_exists: torch.Tensor  # (S,) bool
    moves: torch.Tensor        # (S, 3, 2) int32: straight, left, right
    ty: torch.Tensor           # (S, 3) target row, clamped to the board
    tx: torch.Tensor           # (S, 3)
    inb: torch.Tensor          # (S, 3) bool: the target is on the board
    dead: torch.Tensor         # (S, 3) bool: vetoed, claims aside

    def index(self, i) -> '_Moves':
        return _Moves(*(x[:, i] for x in self))


def _snake_moves(obs: torch.Tensor, cur_dir: torch.Tensor,
                 flood_limit: int) -> _Moves:
    """Every veto of one snake's moves but the claim set, for obs
    (S, H, W, C >= 8) and directions (S, 2) (``(0, 0)``: unknown)."""
    s, h, w = obs.shape[:3]
    dev = obs.device
    obs = obs[..., :T.FEATURE_CHANNEL]
    my_head = obs[..., T.CH_MY_HEAD].flatten(1)
    head_exists = (my_head == 1).any(-1)
    head_flat = my_head.argmax(-1)
    head = torch.stack([head_flat // w, head_flat % w], -1).to(torch.int32)

    unknown = (cur_dir == 0).all(-1, keepdim=True)
    cur_dir = torch.where(unknown, _derive_dir(obs, head), cur_dir)
    dy, dx = cur_dir[:, 0], cur_dir[:, 1]
    # 0: straight, 1: left (-dx, dy), 2: right (dx, -dy)
    moves = torch.stack([torch.stack([dy, dx], -1),
                         torch.stack([-dx, dy], -1),
                         torch.stack([dx, -dy], -1)], 1)
    tgt = head[:, None] + moves
    inb = ((tgt[..., 0] >= 0) & (tgt[..., 0] < h)
           & (tgt[..., 1] >= 0) & (tgt[..., 1] < w))
    ty, tx = tgt[..., 0].clamp(0, h - 1), tgt[..., 1].clamp(0, w - 1)

    deadly = _deadly_map(obs)
    dead = ~inb | (_cells(deadly, ty, tx) & inb)

    # head-to-head: a 4-neighbour of the target holds an enemy head
    probe = torch.tensor(_PROBE, dtype=torch.int32, device=dev)
    ny = ty[..., None] + probe[:, 0]
    nx = tx[..., None] + probe[:, 1]
    ninb = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    enemy = _cells(obs[..., T.CH_OTHER_HEAD] == 1,
                   ny.clamp(0, h - 1).flatten(1),
                   nx.clamp(0, w - 1).flatten(1)).view(s, 3, 4)
    dead |= (enemy & ninb).any(-1) & inb

    # the flood fill of the post-move board of each move
    mine = obs[..., T.CH_MY_HEAD:T.CH_MY_TAIL + 1] == 1
    my_len = mine.flatten(1, 3).sum(-1, dtype=torch.int32)
    my_tail = obs[..., T.CH_MY_TAIL].flatten(1)
    tail_flat = my_tail.argmax(-1)
    tail_exists = (my_tail == 1).any(-1)
    rows = torch.arange(s, device=dev)
    base = deadly.clone()
    base[rows, head[:, 0], head[:, 1]] = True   # the old head is body now
    eat = _cells(obs[..., T.CH_FRUIT] == 1, ty, tx)
    board = base.flatten(1)[:, None].repeat(1, 3, 1)      # (S, 3, H * W)
    # the tail retracts unless the move eats; the target is the new head
    clear_tail = (tail_exists[:, None] & ~eat)[..., None]
    tail_idx = tail_flat[:, None, None].expand(s, 3, 1)
    board.scatter_(2, tail_idx, board.gather(2, tail_idx) & ~clear_tail)
    board.scatter_(2, (ty * w + tx).long()[..., None], False)
    space = reachable_count_plain(~board.view(s, 3, h, w),
                                  torch.stack([ty, tx], -1), flood_limit)
    dead |= space < my_len[:, None] + eat.to(torch.int32)
    return _Moves(head, head_exists, moves, ty, tx, inb, dead)


def _choose(m: _Moves, q: torch.Tensor, claimed: torch.Tensor):
    """(action, new_dir, next_pos) of snakes whose other vetoes are ``m``,
    under the claim set ``claimed`` (S, H, W)."""
    dead = m.dead | (_cells(claimed, m.ty, m.tx) & m.inb)
    act = q.masked_fill(dead, float('-inf')).argmax(-1)
    new_dir = m.moves[torch.arange(act.shape[0], device=act.device), act]
    next_pos = m.head + new_dir
    # dead snakes: action 0, no direction, no claim
    act = torch.where(m.head_exists, act, 0).to(torch.int32)
    new_dir = torch.where(m.head_exists[:, None], new_dir, 0)
    return act, new_dir, next_pos


def masked_actions_plain(obs: torch.Tensor, q: torch.Tensor,
                         cur_dirs: torch.Tensor, active: torch.Tensor,
                         claims: Optional[torch.Tensor] = None,
                         flood_limit: int = 60) -> MaskOut:
    """The plain version of ``safety_mask``, in torch on either device:
    every veto of every snake at once (``_snake_moves``), then the claims
    and the argmax snake by snake (``_choose``)."""
    e, n, h, w, c = obs.shape
    cur_dirs = cur_dirs.to(torch.int32)
    m = _snake_moves(obs.reshape(e * n, h, w, c), cur_dirs.reshape(-1, 2),
                     flood_limit)
    m = _Moves(*(x.view((e, n) + x.shape[1:]) for x in m))
    claimed = (torch.zeros((e, h * w), dtype=torch.bool, device=obs.device)
               if claims is None else claims.reshape(e, h * w).clone())
    acts, dirs, nexts = [], [], []
    for i in range(n):
        mi = m.index(i)
        act, new_dir, nxt = _choose(mi, q[:, i], claimed.view(e, h, w))
        do_claim = (mi.head_exists & active[:, i])[:, None]
        idx = (nxt[:, :1].clamp(0, h - 1) * w
               + nxt[:, 1:].clamp(0, w - 1)).long()
        claimed.scatter_(1, idx, claimed.gather(1, idx) | do_claim)
        acts.append(torch.where(active[:, i], act, 0))
        dirs.append(torch.where(active[:, i, None], new_dir, cur_dirs[:, i]))
        nexts.append(nxt)
    return MaskOut(torch.stack(acts, -1), torch.stack(dirs, 1),
                   torch.stack(nexts, 1), m.head_exists)


def safety_mask(obs: torch.Tensor, q: torch.Tensor, cur_dirs: torch.Tensor,
                active: torch.Tensor, claims: Optional[torch.Tensor] = None,
                flood_limit: int = 60) -> MaskOut:
    """Masked actions of E envs x N snakes, claimed in snake order within
    each env after the cells of ``claims``: obs (E, N, H, W, C >= 8) uint8
    (the first 8 channels are read; any env and snake strides), q (E, N,
    3), cur_dirs (E, N, 2) with ``(0, 0)`` unknown, active (E, N) bool,
    claims None or (E, H, W) bool. The plain version on CPU tensors, one
    kernel launch on CUDA tensors (``mask_kernel.check_mask_args`` says
    what it takes). An inactive snake acts 0, keeps its direction and
    claims nothing."""
    if obs.device.type == 'cpu':
        return masked_actions_plain(obs, q, cur_dirs, active, claims,
                                    flood_limit)
    if obs.device.type != 'cuda':
        raise ValueError(f'unsupported device {obs.device}')
    inputs = mask_kernel.check_mask_args(obs, q, cur_dirs, active, claims)
    out = mask_kernel.launch_masked_actions(inputs, flood_limit)
    if obs.shape[0]:
        safety_mask.launches += 1
    return out


safety_mask.launches = 0


def masked_action_single(obs_i: torch.Tensor, q_i: torch.Tensor,
                         cur_dir: torch.Tensor, claimed: torch.Tensor,
                         flood_limit: int = 60):
    """One snake's masked action, batched over any leading axes: obs
    (..., H, W, C >= 8) uint8, q (..., 3), cur_dir (..., 2) with ``(0, 0)``
    unknown (derived from the body), claimed (..., H, W) bool. Returns
    (action, new_dir (..., 2), next_pos (..., 2), head_exists)."""
    lead = obs_i.shape[:-3]
    h, w, c = obs_i.shape[-3:]
    obs = obs_i.reshape((-1, 1, h, w, c))
    e = obs.shape[0]
    out = safety_mask(obs, q_i.reshape(e, 1, 3), cur_dir.reshape(e, 1, 2),
                      torch.ones((e, 1), dtype=torch.bool,
                                 device=obs.device),
                      claimed.reshape(e, h, w), flood_limit)
    return (out.act.reshape(lead), out.new_dir.reshape(lead + (2,)),
            out.next_pos.reshape(lead + (2,)),
            out.head_exists.reshape(lead))


def masked_actions(obs: torch.Tensor, q: torch.Tensor,
                   cur_dirs: torch.Tensor, active: torch.Tensor,
                   flood_limit: int = 60):
    """Masked actions of every snake, claimed in snake order within each
    env: obs (..., N, H, W, C >= 8) uint8 (the first 8 channels are read),
    q (..., N, 3), cur_dirs (..., N, 2) with ``(0, 0)`` unknown, active
    (..., N) bool. Returns (actions (..., N) int32, new_dirs (..., N, 2)
    int32); an inactive snake acts 0 and keeps its direction."""
    lead = obs.shape[:-4]
    n, h, w, c = obs.shape[-4:]
    obs = obs.reshape((-1, n, h, w, c))
    e = obs.shape[0]
    out = safety_mask(obs, q.reshape(e, n, -1), cur_dirs.reshape(e, n, 2),
                      active.reshape(e, n), None, flood_limit)
    return (out.act.reshape(lead + (n,)),
            out.new_dir.reshape(lead + (n, 2)))
