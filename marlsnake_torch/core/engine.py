"""The batched snake engine in plain PyTorch: reset, step, auto-reset.

Every function takes a batch of envs, batch axis first, and all
randomness as input tensors (``marlsnake_torch.rng``). This module is the
port of the JAX package's ``core/engine.py`` main path and is the plain
version of the CUDA step kernel (``ops/step_kernel.py``): the CPU runs
it, the tests hold it against the JAX engine, and ``chip_smoke.py``
holds the kernel against it on the card.

Phases of a step (same order and arithmetic as the JAX engine):

1. turn: dead snakes keep their heading; proposed heads ``head + delta``.
2. collision against the PRE-move grid: two or more heads on one cell
   all die (no kill credit); a mover onto WALL/BODY/HEAD dies and the
   lowest-index proposer of each target credits one kill to the owner of
   the hit cell (itself included); a single head on FRUIT eats.
3. tail chase: a mover onto an eater's old tail dies and the eater gets
   a kill per chaser. ``alive_count`` is decremented per chaser without
   checking for a phase-2 death too (the reference's double decrement).
4. win: ``alive_count == 1`` marks the FIRST alive snake only.
5. rewards, an ordered float32 sum; snakes dead before the step get 0.
6. grid: erase dead bodies, then last-writer-wins cell writes in the
   order old head -> BODY, retracting tail -> EMPTY, new head, new tail.
7. fruit respawn: ``fruit_taken`` draws over the empty cells, with
   replacement.
8. episodic stats, timeout, ``done_mode``, competition rank ("1224").

A reset takes its snakes from a row of the host-made spawn pool, or with
``spawn_mode='procedural'`` computes one straight segment a snake from
four uniforms, each snake inside its own band of rows (no pool, no
tables: ``spawn`` is None).

The observation of a step is made from the state it returns: the whole
grid or, with ``vision_range``, a window around each head; eight one-hot
uint8 channels a cell or, with ``obs_format='packed'``, the same eight
bits in one byte. ``frame_stack > 1`` concatenates the last frames'
channels, oldest first: full-obs configs carry the past raw grids in
``EnvState.hist_grid`` and re-encode them, vision configs carry the
encoded window frames in ``EnvState.obs_stack``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from marlsnake_torch.core import types as T
from marlsnake_torch.core.spawn import base_grid_host, spawn_data
from marlsnake_torch.core.state import (
    EnvState, ring_pack_prefix, ring_pop_tail, ring_push)
from marlsnake_torch.rng import ResetDraws, StepDraws

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass
class StepOutput:
    obs: torch.Tensor             # (B, N, Ho, Wo, C) uint8 (cfg.obs_shape)
    reward: torch.Tensor          # (B, N) float32
    done: torch.Tensor            # (B, N) bool
    rank: torch.Tensor            # (B, N) int32
    # episodic stats of the finished step (meaningful where done_all)
    episode_scores: torch.Tensor  # (B, N) float32
    episode_steps: torch.Tensor
    episode_fruits: torch.Tensor
    episode_kills: torch.Tensor
    done_all: torch.Tensor        # (B,) bool: the episode-done predicate

    def replace(self, **changes) -> 'StepOutput':
        return dataclasses.replace(self, **changes)

    def fields(self):
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)]


class SpawnTables(NamedTuple):
    """Device copies of the host spawn data."""
    cells: torch.Tensor      # (P, N*k) int32 head-first flat cells
    base_grid: torch.Tensor  # (H, W) int32 empty board


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def make_empty_grid(cfg: T.EnvConfig, device) -> torch.Tensor:
    """(H, W) int32 bordered empty grid, or the walls of
    ``cfg.map_layout``."""
    return torch.as_tensor(
        base_grid_host(cfg.height, cfg.width, cfg.map_layout), device=device)


@functools.lru_cache(maxsize=32)
def _bordered_grid(height: int, width: int, device: torch.device
                   ) -> torch.Tensor:
    return torch.as_tensor(base_grid_host(height, width, None),
                           device=device)


def spawn_tables(cfg: T.EnvConfig, device) -> Optional[SpawnTables]:
    """The device copies of the spawn pool and the empty board; None for
    the procedural spawn, which needs neither."""
    if cfg.spawn_mode == 'procedural':
        return None
    sd = spawn_data(cfg.height, cfg.width, cfg.snake_length,
                    cfg.num_snakes, pool_size=cfg.spawn_pool_size,
                    map_layout=cfg.map_layout)
    return SpawnTables(torch.as_tensor(sd.cells, device=device),
                       make_empty_grid(cfg, device))


def flat_delta_to_dir(d: torch.Tensor, w: int) -> torch.Tensor:
    """Flat-index deltas {-w, +1, +w, -1} -> UP, RIGHT, DOWN, LEFT (any
    other delta maps to LEFT)."""
    return torch.where(
        d == -w, T.UP,
        torch.where(d == 1, T.RIGHT,
                    torch.where(d == w, T.DOWN, T.LEFT))).to(I32)


def dir_delta(d: torch.Tensor) -> torch.Tensor:
    """``DIR_DELTA[d]`` as (..., 2) int32 (row, col) deltas."""
    dr = (d == T.DOWN).to(I32) - (d == T.UP).to(I32)
    dc = (d == T.RIGHT).to(I32) - (d == T.LEFT).to(I32)
    return torch.stack([dr, dc], dim=-1)


def next_direction(cfg: T.EnvConfig, direction: torch.Tensor,
                   actions: torch.Tensor) -> torch.Tensor:
    """``TURN[direction, clip(actions, 0, 4)]`` as arithmetic."""
    a = actions.to(I32).clamp(0, 4)
    if cfg.observer == 'human':
        horiz = direction % 2 == 1
        return torch.where(
            horiz & (a == 3), T.DOWN,
            torch.where(horiz & (a == 4), T.UP,
                        torch.where(~horiz & (a == 1), T.LEFT,
                                    torch.where(~horiz & (a == 2), T.RIGHT,
                                                direction)))).to(I32)
    turn = (a == 2).to(I32) - (a == 1).to(I32)
    return (direction + turn + 4) & 3


def place_fruits(grid: torch.Tensor, u: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """Place up to ``count`` (B,) fruits from uniform draws ``u`` (B, K).

    The empty cells are enumerated in row-major order by an exact int32
    prefix count; draw k picks the empty cell whose inclusive count is
    ``clip(floor(u_k * num_empty), 0, num_empty - 1) + 1``, with
    replacement (duplicate draws collapse to one fruit).
    """
    b, h, w = grid.shape
    flat = grid.reshape(b, h * w)
    mask = flat == T.EMPTY
    cum = torch.cumsum(mask.to(I32), dim=1, dtype=I32)
    num_empty = cum[:, -1:]                                    # (B, 1)
    r = torch.floor(u * num_empty.to(F32)).to(I32)
    r = torch.minimum(r.clamp(min=0), (num_empty - 1).clamp(min=0))
    k = torch.arange(u.shape[1], device=grid.device)
    valid = (k[None, :] < count[:, None]) & (num_empty > 0)
    r = torch.where(valid, r, -2)
    hit = torch.zeros_like(mask)
    for j in range(u.shape[1]):
        hit = hit | (cum == r[:, j:j + 1] + 1)
    return torch.where(hit & mask, T.FRUIT, flat).to(I32).view(b, h, w)


def frame_bytes(n: int, cells: torch.Tensor) -> torch.Tensor:
    """Cell values -> (B, N, Ho, Wo) int32 observation bytes, bit c =
    channel c: wall, fruit, other head/body/tail, my head/body/tail.
    ``cells`` is one (B, H, W) grid that every snake sees, or (B, N, Ho,
    Wo) windows, one a snake. The byte is built once as "other", and the
    owner's bits 2..4 move to 5..7."""
    t = T.cell_type(cells)
    owner = T.cell_owner(cells)
    shift = torch.where(t == T.WALL, 0,
                        torch.where(t == T.FRUIT, 1, 2 + (t - T.HEAD)))
    one = torch.ones_like(t)
    base = torch.where(t > T.EMPTY, one << shift.clamp(min=0), 0)
    if cells.dim() == 3:
        t, owner, base = t[:, None], owner[:, None], base[:, None]
    ids = torch.arange(n, dtype=I32, device=cells.device).view(1, n, 1, 1)
    is_mine = (t >= T.HEAD) & (owner == ids)
    return torch.where(is_mine, base << 3, base)


def bytes_to_planes(byte: torch.Tensor) -> torch.Tensor:
    c = torch.arange(T.FEATURE_CHANNEL, dtype=I32, device=byte.device)
    return ((byte[..., None] >> c) & 1).to(torch.uint8)


def encode_frame(cfg: T.EnvConfig, grid: torch.Tensor) -> torch.Tensor:
    """(B, H, W) grid -> (B, N, H, W, 8) uint8 one-hot observation."""
    return bytes_to_planes(frame_bytes(cfg.num_snakes, grid))


def encode_frame_packed(cfg: T.EnvConfig, grid: torch.Tensor
                        ) -> torch.Tensor:
    """(B, H, W) grid -> (B, N, H, W, 1) uint8: the eight channels of
    :func:`encode_frame` as the bits of one byte
    (``ops.obs_pack.pack_frame(encode_frame(...))``)."""
    return frame_bytes(cfg.num_snakes, grid).to(torch.uint8)[..., None]


def _window_cells(cfg: T.EnvConfig, grid: torch.Tensor, head: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """The (2v+1)^2 window of raw cells around each snake's head, (B, N,
    2v+1, 2v+1) int32: a bounds-masked gather. A dead snake's window is
    centred on (0, 0); cells outside the grid read EMPTY."""
    h, w, v = cfg.height, cfg.width, cfg.vision_range
    b, n = alive.shape
    off = torch.arange(-v, v + 1, dtype=I32, device=grid.device)
    center = torch.where(alive[..., None], head, 0)
    ry = center[..., 0, None] + off                     # (B, N, v2)
    cx = center[..., 1, None] + off
    inside = (((ry >= 0) & (ry < h))[..., :, None]
              & ((cx >= 0) & (cx < w))[..., None, :])
    flat = (ry.clamp(0, h - 1)[..., :, None] * w
            + cx.clamp(0, w - 1)[..., None, :])         # (B, N, v2, v2)
    cells = torch.gather(grid.reshape(b, h * w), 1,
                         flat.reshape(b, -1).long()).view(flat.shape)
    return torch.where(inside, cells, T.EMPTY)


def encode_frame_cropped(cfg: T.EnvConfig, grid: torch.Tensor,
                         head: torch.Tensor, alive: torch.Tensor
                         ) -> torch.Tensor:
    """Vision-range observation, (B, N, 2v+1, 2v+1, 8) uint8: the window
    of :func:`_window_cells`, channel-encoded like :func:`encode_frame`
    (out-of-grid cells are all-zero, as in a zero-padded crop)."""
    return bytes_to_planes(frame_bytes(
        cfg.num_snakes, _window_cells(cfg, grid, head, alive)))


def stack_to_obs(obs_stack: torch.Tensor) -> torch.Tensor:
    """(B, fs, N, Ho, Wo, C) frames, oldest first -> (B, N, Ho, Wo,
    fs * C): channel f * C + c is channel c of frame f."""
    b, fs, n, h, w, c = obs_stack.shape
    return obs_stack.movedim(1, 4).reshape(b, n, h, w, fs * c)


def _current_frame(cfg: T.EnvConfig, state: EnvState) -> torch.Tensor:
    """The frame of the state's own grid, (B, N, Ho, Wo, C) uint8."""
    cells = (_window_cells(cfg, state.grid, state.head, state.alive)
             if cfg.vision_range else state.grid)
    byte = frame_bytes(cfg.num_snakes, cells)
    if cfg.obs_format == 'packed':
        return byte.to(torch.uint8)[..., None]
    return bytes_to_planes(byte)


def _encode_and_stack(cfg: T.EnvConfig, state: EnvState, old_stack,
                      reset_mode):
    """(obs, obs_stack or None) of ``state``. ``reset_mode`` is True
    (every env is fresh), False (none is) or a (B,) bool tensor; it
    matters only to the stored-frame stack of vision configs, which a
    fresh env fills with its first frame and every other env rolls. With
    raw-grid history the state's ``hist_grid`` already says it: a fresh
    env carries its own grid in every slot."""
    frame = _current_frame(cfg, state)
    fs = cfg.frame_stack
    if fs == 1:
        return frame, None
    if cfg.hist_mode:
        enc = (encode_frame_packed if cfg.obs_format == 'packed'
               else encode_frame)
        hists = [enc(cfg, state.hist_grid[:, i]) for i in range(fs - 1)]
        return stack_to_obs(torch.stack(hists + [frame], 1)), None
    fresh = frame[:, None].expand((-1, fs) + frame.shape[1:])
    if reset_mode is True:
        stack = fresh.contiguous()
    else:
        stack = torch.cat([old_stack[:, 1:], frame[:, None]], 1)
        if reset_mode is not False:
            stack = _select(reset_mode, fresh, stack)
    return stack_to_obs(stack), stack


def _roll_hist(cfg: T.EnvConfig, new_state: EnvState,
               prev: EnvState) -> EnvState:
    """After a step the raw-grid history drops its oldest grid and takes
    the PRE-step grid as its newest."""
    if not cfg.hist_mode:
        return new_state
    return new_state.replace(hist_grid=torch.cat(
        [prev.hist_grid[:, 1:], prev.grid[:, None]], 1))


def _with_obs(cfg: T.EnvConfig, state: EnvState, old_stack, reset_mode):
    """``state`` with its frame stack brought up to date, and its obs."""
    obs, stack = _encode_and_stack(cfg, state, old_stack, reset_mode)
    if stack is not None:
        state = state.replace(obs_stack=stack)
    return state, obs


def _set_cells(flat: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """flat[b, idx[b, j]] = val[j] where valid[b, j], in ascending j
    (last writer wins). flat (B, L), idx/valid (B, J), val (J,)."""
    for j in range(idx.shape[1]):
        ij = idx[:, j:j + 1].long()
        cur = torch.gather(flat, 1, ij)
        flat = flat.scatter(1, ij, torch.where(valid[:, j:j + 1],
                                               val[j], cur))
    return flat


def _select(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per env: ``a`` where done else ``b`` (done (B,))."""
    return torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), a, b)


# ---------------------------------------------------------------------------
# reset
# ---------------------------------------------------------------------------

def _procedural_spawn(cfg: T.EnvConfig, u: torch.Tensor) -> torch.Tensor:
    """Head-first flat cells (B, N, k) int32 of the procedural spawn, from
    ``u`` (B, N, 4) uniforms: position in band, column, head side,
    orientation.

    Snake i owns the interior rows ``[1 + i*b, 1 + (i+1)*b)`` with ``b =
    (height - 2) // num_snakes`` and lies in them as one straight segment,
    so segments of different snakes never meet. Horizontal: row ``u0`` of
    the band, column start ``u1`` among those that keep the segment off
    the walls. Vertical (``spawn_orientations='both'``, only where ``b >=
    k``, chosen by ``u3 < 0.5``): row start ``u0`` among those that keep
    the segment inside the band, any interior column ``u1``. ``u2 < 0.5``
    puts the head at the left (top) end. Each pick is the float32 product
    truncated and clamped, ``min(int(u * m), m - 1)``.
    """
    n, k, h, w = cfg.num_snakes, cfg.snake_length, cfg.height, cfg.width
    band = (h - 2) // n
    starts = w - 1 - k

    def pick(ui, m):
        return (ui * m).to(I32).clamp(max=m - 1)

    band0 = 1 + torch.arange(n, dtype=I32, device=u.device) * band
    rows = band0 + pick(u[..., 0], band)
    c0 = 1 + pick(u[..., 1], starts)
    side = u[..., 2] < 0.5
    j = torch.arange(k, dtype=I32, device=u.device)
    jj = torch.where(side[..., None], j, (k - 1) - j)        # (B, N, k)
    cells = rows[..., None] * w + c0[..., None] + jj
    if cfg.spawn_vertical:
        vert = u[..., 3] < 0.5
        r0 = band0 + pick(u[..., 0], band - k + 1)
        cv = 1 + pick(u[..., 1], w - 2)
        cells = torch.where(vert[..., None],
                            (r0[..., None] + jj) * w + cv[..., None], cells)
    return cells


def _reset_core(cfg: T.EnvConfig, spawn: Optional[SpawnTables],
                spawn_u: torch.Tensor) -> EnvState:
    """Reset WITHOUT fruits and without obs: the snakes' cells (pool row
    ``min(int(u * P), P - 1)``, or the procedural spawn), painted body,
    then head, then tail; rings from the paths. A raw-grid history holds
    this fruitless grid in every slot, and the stored-frame stack is
    left empty: the caller fills both."""
    n, k = cfg.num_snakes, cfg.snake_length
    h, w = cfg.height, cfg.width
    dev = spawn_u.device
    b = spawn_u.shape[0]
    if cfg.spawn_mode == 'procedural':
        cells = _procedural_spawn(cfg, spawn_u)
        base_grid = _bordered_grid(h, w, dev)
    else:
        num_pool = spawn.cells.shape[0]
        row = (spawn_u * num_pool).to(I32).clamp(max=num_pool - 1)
        cells = spawn.cells[row.long()].view(b, n, k)
        base_grid = spawn.base_grid

    ids = torch.arange(n, dtype=I32, device=dev) << T.OWNER_SHIFT
    flat = base_grid.reshape(1, h * w).repeat(b, 1)
    flat.scatter_(1, cells.reshape(b, n * k).long(),
                  (T.BODY + ids).repeat_interleave(k).expand(b, n * k))
    flat.scatter_(1, cells[:, :, 0].long(), (T.HEAD + ids).expand(b, n))
    flat.scatter_(1, cells[:, :, -1].long(), (T.TAIL + ids).expand(b, n))
    grid = flat.view(b, h, w)

    # link j points from cell j+1 to cell j, newest (head) link first
    dirs = flat_delta_to_dir(cells[:, :, :-1] - cells[:, :, 1:], w)
    hf, tf = cells[:, :, 0], cells[:, :, -1]
    zeros_f = torch.zeros((b, n), dtype=F32, device=dev)
    hist_len = cfg.frame_stack - 1 if cfg.hist_mode else 0
    return EnvState(
        grid=grid,
        direction=dirs[:, :, 0].contiguous(),
        head=torch.stack([hf // w, hf % w], -1),
        tail=torch.stack([tf // w, tf % w], -1),
        ring=ring_pack_prefix(dirs, cfg.body_capacity),
        ring_head=torch.zeros((b, n), dtype=I32, device=dev),
        ring_len=torch.full((b, n), k - 1, dtype=I32, device=dev),
        alive=torch.ones((b, n), dtype=torch.bool, device=dev),
        alive_count=torch.full((b,), n, dtype=I32, device=dev),
        epi_scores=zeros_f, epi_steps=zeros_f.clone(),
        epi_fruits=zeros_f.clone(), epi_kills=zeros_f.clone(),
        episode_length=torch.zeros((b,), dtype=I32, device=dev),
        hist_grid=grid[:, None].repeat(1, hist_len, 1, 1),
        obs_stack=torch.zeros(
            (b, 0, n, cfg.obs_height, cfg.obs_width, cfg.frame_channels),
            dtype=torch.uint8, device=dev),
    )


def _fill_hist(state: EnvState) -> torch.Tensor:
    """A raw-grid history with the state's own grid in every slot."""
    return state.grid[:, None].expand_as(state.hist_grid)


def reset(cfg: T.EnvConfig, spawn: Optional[SpawnTables],
          draws: ResetDraws) -> Tuple[EnvState, torch.Tensor]:
    """Reset a batch of envs; returns (state, obs). ``spawn`` is None for
    the procedural spawn."""
    state = _reset_core(cfg, spawn, draws.spawn_u)
    nf = cfg.resolved_num_fruits
    if nf > 0:
        count = torch.full((state.num_envs,), nf, dtype=I32,
                           device=state.device)
        state = state.replace(
            grid=place_fruits(state.grid, draws.fruit_u, count))
        state = state.replace(hist_grid=_fill_hist(state).contiguous())
    return _with_obs(cfg, state, None, True)


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------

def _step_core(cfg: T.EnvConfig, state: EnvState, actions: torch.Tensor):
    """Phases 1-6 and 8 (no fruit respawn, no obs). Returns
    (new state with a PRE-fruit grid, output with ``obs=None``,
    fruit_taken (B,) int32)."""
    n = cfg.num_snakes
    h, w = cfg.height, cfg.width
    hw = h * w
    cap = cfg.body_capacity
    r_fruit, r_kill, r_lose, r_win, r_time = cfg.rewards
    dev = state.device
    b = state.num_envs
    grid = state.grid
    alive0 = state.alive
    idx_n = torch.arange(n, dtype=I32, device=dev)
    lower = idx_n[None, :] < idx_n[:, None]           # [i, j]: j < i

    # --- Phase 1: direction update + proposed heads ---
    new_dir = torch.where(alive0, next_direction(cfg, state.direction,
                                                 actions), state.direction)
    tgt = state.head + dir_delta(new_dir)             # (B, N, 2)

    # --- Phase 2: collision vs the pre-move grid ---
    tgt_flat = tgt[..., 0] * w + tgt[..., 1]
    inside = (tgt_flat >= 0) & (tgt_flat < hw)
    tgt_cell = torch.where(
        inside, torch.gather(grid.reshape(b, hw), 1,
                             tgt_flat.clamp(0, hw - 1).long()), 0)
    tgt_type = T.cell_type(tgt_cell)
    tgt_owner = T.cell_owner(tgt_cell).clamp(0, n - 1)
    same_tgt = ((tgt[:, :, None, 0] == tgt[:, None, :, 0])
                & (tgt[:, :, None, 1] == tgt[:, None, :, 1])
                & alive0[:, :, None] & alive0[:, None, :])
    multi = same_tgt.sum(2) >= 2
    deadly = ((tgt_type == T.WALL) | (tgt_type == T.BODY)
              | (tgt_type == T.HEAD))
    dies_collision = alive0 & (multi | deadly)
    primary = alive0 & ~(same_tgt & lower).any(2)
    hit_snake = (tgt_type == T.BODY) | (tgt_type == T.HEAD)
    kill_credit = primary & hit_snake
    kills_delta = torch.zeros((b, n), dtype=F32, device=dev).scatter_add(
        1, tgt_owner.long(), kill_credit.to(F32))
    fruit_dead = primary & multi & (tgt_type == T.FRUIT)
    eats = alive0 & ~multi & ~deadly & (tgt_type == T.FRUIT)
    fruit_taken = (fruit_dead.sum(1) + eats.sum(1)).to(I32)

    # --- Phase 3: tail chase onto an eater's old tail ---
    tail_eq = ((tgt[:, None, :, 0] == state.tail[:, :, None, 0])
               & (tgt[:, None, :, 1] == state.tail[:, :, None, 1]))
    chase = eats[:, :, None] & alive0[:, None, :] & tail_eq  # [b, f, j]
    dies_chase = chase.any(1)
    kills_delta = kills_delta + chase.sum(2).to(F32)
    alive_count = (state.alive_count - dies_collision.sum(1).to(I32)
                   - chase.sum((1, 2)).to(I32))
    dead_now = dies_collision | dies_chase
    alive1 = alive0 & ~dead_now

    # --- Phase 4: win flag (first alive snake only) ---
    prior_alive = (alive1[:, None, :] & lower).any(2)
    win = (alive_count == 1)[:, None] & (n > 1) & alive1 & ~prior_alive

    # --- Phase 5: rewards ---
    was_dead = ~alive0
    rew = (r_time * alive1.to(F32)
           + r_fruit * eats.to(F32)
           + r_lose * dead_now.to(F32)
           + r_kill * kills_delta
           + r_win * win.to(F32))
    rew = torch.where(was_dead, 0.0, rew)
    fruits_stat = torch.where(was_dead, 0.0, eats.to(F32))
    kills_stat = torch.where(was_dead, 0.0, kills_delta)

    # --- Phase 6: grid update ---
    t_pre = T.cell_type(grid)
    owner_pre = T.cell_owner(grid)
    dead_bits = (dead_now.to(I32) << idx_n).sum(1).to(I32)
    erase = (t_pre >= T.HEAD) & (((dead_bits[:, None, None] >> owner_pre)
                                  & 1) > 0)
    flat = torch.where(erase, T.EMPTY, grid).to(I32).reshape(b, hw)

    head_flat = state.head[..., 0] * w + state.head[..., 1]
    tail_flat = state.tail[..., 0] * w + state.tail[..., 1]
    snake_ids = idx_n << T.OWNER_SHIFT
    retract = alive1 & ~eats
    ring, ring_head, ring_len = ring_push(
        state.ring, state.ring_head, state.ring_len, new_dir, alive1, cap)
    popped, ring_len = ring_pop_tail(ring, ring_head, ring_len, retract,
                                     cap)
    new_tail = torch.where(retract[..., None],
                           state.tail + dir_delta(popped), state.tail)
    new_head = torch.where(alive1[..., None], tgt, state.head)
    nh_flat = new_head[..., 0] * w + new_head[..., 1]
    nt_flat = new_tail[..., 0] * w + new_tail[..., 1]
    # A length-2 retract lands the new tail on its own old head (TAIL
    # wins), and a mover onto a retracting tail keeps its HEAD there.
    claimed_tail = (tail_eq & alive1[:, None, :]).any(2)
    oldhead_valid = alive1 & ~(retract & (nt_flat == head_flat))
    erase_tail_valid = retract & ~claimed_tail
    flat = _set_cells(
        flat,
        torch.cat([head_flat, tail_flat, nh_flat, nt_flat], 1),
        torch.cat([T.BODY + snake_ids,
                   torch.full((n,), T.EMPTY, dtype=I32, device=dev),
                   T.HEAD + snake_ids, T.TAIL + snake_ids]),
        torch.cat([oldhead_valid, erase_tail_valid, alive1, alive1], 1))

    # --- Phase 8: stats / timeout / done / rank ---
    dones_pre = ~alive1
    mask = 1.0 - dones_pre.to(F32)
    epi_scores = state.epi_scores + mask * rew
    epi_steps = state.epi_steps + mask
    epi_fruits = state.epi_fruits + mask * fruits_stat
    epi_kills = state.epi_kills + mask * kills_stat
    episode_length = state.episode_length + 1
    timeout = episode_length >= cfg.max_episode_steps
    dones = dones_pre | timeout[:, None]
    if cfg.done_mode == 'any':
        done_all = dones.any(1)
        dones_out = done_all[:, None] | dones
    else:
        done_all = dones.all(1)
        dones_out = dones
    rank = (1 + (epi_scores[:, None, :] > epi_scores[:, :, None]).sum(2)
            ).to(I32)

    out = StepOutput(
        obs=None, reward=rew, done=dones_out, rank=rank,
        episode_scores=epi_scores, episode_steps=epi_steps,
        episode_fruits=epi_fruits, episode_kills=epi_kills,
        done_all=done_all)
    zero = torch.zeros_like(epi_scores)
    new_state = state.replace(
        grid=flat.view(b, h, w), direction=new_dir, head=new_head,
        tail=new_tail, ring=ring, ring_head=ring_head, ring_len=ring_len,
        alive=alive1, alive_count=alive_count,
        epi_scores=_select(done_all, zero, epi_scores),
        epi_steps=_select(done_all, zero, epi_steps),
        epi_fruits=_select(done_all, zero, epi_fruits),
        epi_kills=_select(done_all, zero, epi_kills),
        episode_length=episode_length)
    return new_state, out, fruit_taken


def step(cfg: T.EnvConfig, state: EnvState, actions: torch.Tensor,
         fruit_u: torch.Tensor) -> Tuple[EnvState, StepOutput]:
    """One simultaneous move of every snake, without auto-reset.
    ``fruit_u`` (B, N) are the fruit-respawn draws."""
    new_state, out, fruit_taken = _step_core(cfg, state, actions)
    new_state = _roll_hist(cfg, new_state, state).replace(
        grid=place_fruits(new_state.grid, fruit_u, fruit_taken))
    new_state, obs = _with_obs(cfg, new_state, state.obs_stack, False)
    return new_state, out.replace(obs=obs)


def step_autoreset(cfg: T.EnvConfig, spawn: Optional[SpawnTables],
                   state: EnvState, actions: torch.Tensor, draws: StepDraws
                   ) -> Tuple[EnvState, StepOutput]:
    """Step with fused auto-reset: where the episode-done predicate fires,
    the returned state and obs are those of a fresh reset, while reward,
    done and the stats describe the finished step. Fruits are placed
    once, on the done-selected grid, with the done-selected draws and
    count; only then does a fresh env's raw-grid history take its grid,
    and its stored-frame stack its first frame."""
    n, nf = cfg.num_snakes, cfg.resolved_num_fruits
    new_state, out, fruit_taken = _step_core(cfg, state, actions)
    new_state = _roll_hist(cfg, new_state, state)
    r_state = _reset_core(cfg, spawn, draws.reset_spawn_u).replace(
        obs_stack=new_state.obs_stack)
    done = out.done_all
    sel = EnvState(**{name: _select(done, r, s) for (name, r), (_, s) in
                      zip(r_state.fields(), new_state.fields())})
    m = max(n, nf)
    b = state.num_envs
    u_step = torch.zeros((b, m), dtype=F32, device=state.device)
    u_step[:, :n] = draws.fruit_u
    u_reset = torch.zeros((b, m), dtype=F32, device=state.device)
    u_reset[:, :nf] = draws.reset_fruit_u
    count = torch.where(done, nf, fruit_taken).to(I32)
    sel = sel.replace(
        grid=place_fruits(sel.grid, _select(done, u_reset, u_step), count))
    if cfg.hist_mode:
        sel = sel.replace(
            hist_grid=_select(done, _fill_hist(sel), sel.hist_grid))
    sel, obs = _with_obs(cfg, sel, state.obs_stack, done)
    return sel, out.replace(obs=obs)
