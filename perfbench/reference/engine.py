"""The plain reference of the snake engine: reset, step (with hold) and
step with auto-reset, in plain torch and numpy.

A frozen, self-contained statement of the game that the benchmark holds
the program's step kernel to. It imports nothing of the program. It
covers the options the benchmark's configurations use: full-board
observations as eight one-hot uint8 planes, one frame, the 'snake'
observer (0 = straight, 1 = left, 2 = right), episodes that end when
every snake is done, bordered boards without interior walls, and both
spawns: a row of the host-made pool of disjoint k-cell paths, or the
procedural spawn (one straight segment a snake in its own band of rows).
Every random number comes in as an input tensor.

Cells hold ``type | owner << 4``; directions are UP, RIGHT, DOWN, LEFT.
A snake's body is a ring of 2-bit directions, 16 to an int32 word, the
newest (head-side) link at ``ring_head``.

A step, in order: turn; collide against the pre-move grid (two heads on
one cell all die, a mover onto a wall, body or head dies and the lowest
proposer of a target credits a kill to the owner of the hit cell, a
single head on a fruit eats); tail chase onto an eater's old tail (the
eater gets a kill a chaser; the alive count drops a chaser, without
checking for an earlier death); a win for the first alive snake when one
is left; rewards as an ordered float32 sum; the grid (dead bodies erased,
then old head -> body, retracting tail -> empty, new head, new tail, last
writer wins); fruit respawn over the empty cells from uniforms, with
replacement; episodic stats, timeout, done, rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

I32 = torch.int32
F32 = torch.float32

EMPTY, WALL, FRUIT, HEAD, BODY, TAIL = 0, 1, 2, 3, 4, 5
OWNER_SHIFT = 4
UP, RIGHT, DOWN, LEFT = 0, 1, 2, 3
CHANNELS = 8
SHIFTS = ((0, 1), (1, 0), (0, -1), (-1, 0))


@dataclasses.dataclass(frozen=True)
class Game:
    """The rules a configuration file states (its ``env`` group)."""
    height: int
    width: int
    num_snakes: int
    snake_length: int
    rewards: tuple            # (fruit, kill, lose, win, time)
    spawn_mode: str = 'pool'  # or 'procedural'
    spawn_pool_size: int = 1 << 16
    max_episode_steps: int = 10_000
    num_fruits: int = -1      # -1: round(0.8 * num_snakes)

    @property
    def fruits(self) -> int:
        return (self.num_fruits if self.num_fruits >= 0
                else int(round(self.num_snakes * 0.8)))

    @property
    def cap(self) -> int:
        return (self.height - 2) * (self.width - 2)

    @property
    def ring_words(self) -> int:
        return -(-self.cap // 16)


def game_from_config(env: dict) -> Game:
    r = env['rewards']
    return Game(env['height'], env['width'], env['num_snakes'],
                env['snake_length'],
                tuple(float(r[k]) for k in ('fruit', 'kill', 'lose', 'win',
                                            'time')),
                env.get('spawn_mode', 'pool'),
                env.get('spawn_pool_size', 1 << 16),
                env.get('max_episode_steps', 10_000),
                env.get('num_fruits', -1))


@dataclasses.dataclass
class State:
    grid: torch.Tensor          # (B, H, W) int32
    direction: torch.Tensor     # (B, N) int32
    head: torch.Tensor          # (B, N, 2) int32
    tail: torch.Tensor          # (B, N, 2) int32
    ring: torch.Tensor          # (B, N, words) int32
    ring_head: torch.Tensor     # (B, N) int32
    ring_len: torch.Tensor      # (B, N) int32: body length - 1
    alive: torch.Tensor         # (B, N) bool
    alive_count: torch.Tensor   # (B,) int32
    epi_scores: torch.Tensor    # (B, N) float32
    epi_steps: torch.Tensor
    epi_fruits: torch.Tensor
    epi_kills: torch.Tensor
    episode_length: torch.Tensor  # (B,) int32


@dataclasses.dataclass
class Out:
    obs: torch.Tensor           # (B, N, H, W, 8) uint8
    reward: torch.Tensor        # (B, N) float32
    done: torch.Tensor          # (B, N) bool
    rank: torch.Tensor          # (B, N) int32
    episode_scores: torch.Tensor
    episode_steps: torch.Tensor
    episode_fruits: torch.Tensor
    episode_kills: torch.Tensor
    done_all: torch.Tensor      # (B,) bool


def fields(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def select(keep: torch.Tensor, a, b):
    """Per env, ``a`` where ``keep`` (B,) else ``b``; same dataclass."""
    def where(x, y):
        return torch.where(keep.view((-1,) + (1,) * (x.dim() - 1)), x, y)
    return type(a)(**{k: where(v, getattr(b, k)) for k, v in
                      fields(a).items()})


# --- spawn pool (host, numpy) ------------------------------------------------

def _blocked(mask, history, extra) -> bool:
    first = history[0]
    count = 0
    for sr, sc in SHIFTS:
        node = (first[0] + sr, first[1] + sc)
        if mask[node] == 0 or node in history or node == extra:
            count += 1
    return count == len(SHIFTS)


def spawn_paths(height: int, width: int, k: int) -> np.ndarray:
    """(C, k, 2) every k-cell path on the empty bordered board, head
    first, in the order of a row-major sweep with neighbours tried in
    ``SHIFTS`` order; a path whose first cell gets boxed in is dropped."""
    mask = np.ones((height, width), dtype=np.uint8)
    mask[[0, -1]] = 0
    mask[:, [0, -1]] = 0
    out = []

    def walk(node, history):
        history = history + [node]
        if len(history) == k:
            out.append(history)
            return
        for sr, sc in SHIFTS:
            cand = (node[0] + sr, node[1] + sc)
            if (0 <= cand[0] < height and 0 <= cand[1] < width
                    and cand not in history and mask[cand]
                    and not _blocked(mask, history, cand)):
                walk(cand, history)

    for r in range(height):
        for c in range(width):
            if mask[r, c]:
                walk((r, c), [])
    return np.asarray(out, dtype=np.int32)


def spawn_cells(game: Game, seed: int = 0) -> np.ndarray:
    """(P, N * k) int32 flat head-first cells of each pool row: rows of
    ``N`` path indices drawn with numpy's generator from ``seed``, kept
    where the paths are pairwise disjoint, until ``P`` rows are found."""
    n, k, w = game.num_snakes, game.snake_length, game.width
    paths = spawn_paths(game.height, w, k)
    flat = paths[:, :, 0].astype(np.int32) * w + paths[:, :, 1]
    rng = np.random.default_rng(seed)
    rows, need = [], game.spawn_pool_size
    for _ in range(64):
        if need <= 0:
            break
        draw = rng.integers(0, len(paths), size=(max(need * 2, 1024), n))
        cells = flat[draw].reshape(len(draw), -1)
        ok = (np.diff(np.sort(cells, axis=1), axis=1) != 0).all(axis=1)
        good = draw[ok][:need]
        rows.append(good)
        need -= len(good)
    pool = np.concatenate(rows).astype(np.int32)
    if len(pool) < game.spawn_pool_size:
        pool = np.tile(pool, (-(-game.spawn_pool_size // len(pool)), 1))[
            :game.spawn_pool_size]
    coords = paths[pool]
    cells = coords[..., 0].astype(np.int64) * w + coords[..., 1]
    return np.ascontiguousarray(cells.reshape(len(pool), -1)
                                .astype(np.int32))


class Engine:
    """The reference engine of one ``Game`` on one device."""

    def __init__(self, game: Game, device, low_precision: bool = False):
        self.g = game
        self.device = torch.device(device)
        # the control: the float32 picks of fruit and spawn cells in
        # bfloat16, a precision below the one the configuration states
        self.pick_dtype = torch.bfloat16 if low_precision else F32
        base = np.zeros((game.height, game.width), np.int32)
        base[[0, -1], :] = WALL
        base[:, [0, -1]] = WALL
        self.base_grid = torch.as_tensor(base, device=self.device)
        self.pool = (None if game.spawn_mode == 'procedural' else
                     torch.as_tensor(spawn_cells(game), device=self.device))

    # --- helpers ---------------------------------------------------------------
    def _pick(self, u: torch.Tensor, m) -> torch.Tensor:
        """``floor(u * m)`` in the pick precision, as int32."""
        d = self.pick_dtype
        return (u.to(d) * (m.to(d) if torch.is_tensor(m) else m)).to(I32)

    def place_fruits(self, grid, u, count):
        """Fruits on empty cells: draw j takes the empty cell (row-major)
        whose inclusive running count is ``clip(floor(u_j * empty), 0,
        empty - 1) + 1``, for the first ``count`` draws; repeats collapse."""
        b, h, w = grid.shape
        flat = grid.reshape(b, h * w)
        mask = flat == EMPTY
        cum = torch.cumsum(mask.to(I32), 1, dtype=I32)
        num = cum[:, -1:]
        r = torch.floor(u.to(self.pick_dtype)
                        * num.to(self.pick_dtype)).to(I32)
        r = torch.minimum(r.clamp(min=0), (num - 1).clamp(min=0))
        j = torch.arange(u.shape[1], device=grid.device)
        valid = (j[None] < count[:, None]) & (num > 0)
        r = torch.where(valid, r, -2)
        hit = torch.zeros_like(mask)
        for i in range(u.shape[1]):
            hit = hit | (cum == r[:, i:i + 1] + 1)
        return torch.where(hit & mask, FRUIT, flat).to(I32).view(b, h, w)

    def obs(self, grid) -> torch.Tensor:
        """(B, N, H, W, 8) uint8: wall, fruit, other head/body/tail, my
        head/body/tail."""
        n = self.g.num_snakes
        t = grid & 15
        owner = grid >> OWNER_SHIFT
        chan = torch.where(t == WALL, 0, torch.where(t == FRUIT, 1,
                                                     2 + t - HEAD))
        ids = torch.arange(n, device=grid.device).view(1, n, 1, 1)
        mine = (t[:, None] >= HEAD) & (owner[:, None] == ids)
        chan = torch.where(mine, chan[:, None] + 3, chan[:, None])
        on = (t > EMPTY)[:, None]
        c = torch.arange(CHANNELS, device=grid.device)
        return ((chan[..., None] == c) & on[..., None]).to(torch.uint8)

    @staticmethod
    def delta(d):
        dr = (d == DOWN).to(I32) - (d == UP).to(I32)
        dc = (d == RIGHT).to(I32) - (d == LEFT).to(I32)
        return torch.stack([dr, dc], -1)

    # --- reset -----------------------------------------------------------------
    def _spawn(self, u: torch.Tensor) -> torch.Tensor:
        """(B, N, k) head-first flat cells of each env's snakes."""
        g = self.g
        n, k, h, w = g.num_snakes, g.snake_length, g.height, g.width
        b = u.shape[0]
        if g.spawn_mode != 'procedural':
            p = self.pool.shape[0]
            row = self._pick(u, p).clamp(max=p - 1)
            return self.pool[row.long()].view(b, n, k)
        band = (h - 2) // n
        band0 = 1 + torch.arange(n, dtype=I32, device=u.device) * band
        rows = band0 + self._pick(u[..., 0], band).clamp(max=band - 1)
        starts = w - 1 - k
        c0 = 1 + self._pick(u[..., 1], starts).clamp(max=starts - 1)
        j = torch.arange(k, dtype=I32, device=u.device)
        jj = torch.where((u[..., 2] < 0.5)[..., None], j, (k - 1) - j)
        return rows[..., None] * w + c0[..., None] + jj

    def _fresh(self, spawn_u) -> State:
        """A reset's state before its fruits."""
        g = self.g
        n, k, h, w = g.num_snakes, g.snake_length, g.height, g.width
        dev = spawn_u.device
        b = spawn_u.shape[0]
        cells = self._spawn(spawn_u)
        ids = torch.arange(n, dtype=I32, device=dev) << OWNER_SHIFT
        flat = self.base_grid.reshape(1, h * w).repeat(b, 1)
        flat.scatter_(1, cells.reshape(b, n * k).long(),
                      (BODY + ids).repeat_interleave(k).expand(b, n * k))
        flat.scatter_(1, cells[:, :, 0].long(), (HEAD + ids).expand(b, n))
        flat.scatter_(1, cells[:, :, -1].long(), (TAIL + ids).expand(b, n))
        d = cells[:, :, :-1] - cells[:, :, 1:]
        dirs = torch.where(d == -w, UP, torch.where(
            d == 1, RIGHT, torch.where(d == w, DOWN, LEFT))).to(I32)
        ring = torch.zeros((b, n, g.ring_words), dtype=I32, device=dev)
        for j in range(k - 1):
            ring[..., j // 16] |= dirs[..., j] << (2 * (j % 16))
        hf, tf = cells[:, :, 0], cells[:, :, -1]
        zf = torch.zeros((b, n), dtype=F32, device=dev)
        return State(
            grid=flat.view(b, h, w), direction=dirs[:, :, 0].contiguous(),
            head=torch.stack([hf // w, hf % w], -1),
            tail=torch.stack([tf // w, tf % w], -1), ring=ring,
            ring_head=torch.zeros((b, n), dtype=I32, device=dev),
            ring_len=torch.full((b, n), k - 1, dtype=I32, device=dev),
            alive=torch.ones((b, n), dtype=torch.bool, device=dev),
            alive_count=torch.full((b,), n, dtype=I32, device=dev),
            epi_scores=zf, epi_steps=zf.clone(), epi_fruits=zf.clone(),
            epi_kills=zf.clone(),
            episode_length=torch.zeros((b,), dtype=I32, device=dev))

    def reset(self, spawn_u, fruit_u):
        """(state, obs) of fresh envs."""
        s = self._fresh(spawn_u)
        count = torch.full((s.grid.shape[0],), self.g.fruits, dtype=I32,
                           device=s.grid.device)
        s.grid = self.place_fruits(s.grid, fruit_u, count)
        return s, self.obs(s.grid)

    # --- step ------------------------------------------------------------------
    def _core(self, s: State, actions):
        g = self.g
        n, h, w = g.num_snakes, g.height, g.width
        hw, cap = h * w, g.cap
        r_fruit, r_kill, r_lose, r_win, r_time = g.rewards
        dev = s.grid.device
        b = s.grid.shape[0]
        grid, alive0 = s.grid, s.alive
        idx = torch.arange(n, dtype=I32, device=dev)
        lower = idx[None, :] < idx[:, None]            # [i, j]: j < i

        a = actions.to(I32).clamp(0, 4)
        turn = (a == 2).to(I32) - (a == 1).to(I32)
        new_dir = torch.where(alive0, (s.direction + turn + 4) & 3,
                              s.direction)
        tgt = s.head + self.delta(new_dir)

        tflat = tgt[..., 0] * w + tgt[..., 1]
        inside = (tflat >= 0) & (tflat < hw)
        cell = torch.where(inside, torch.gather(
            grid.reshape(b, hw), 1, tflat.clamp(0, hw - 1).long()), 0)
        ttype, towner = cell & 15, (cell >> OWNER_SHIFT).clamp(0, n - 1)
        same = ((tgt[:, :, None, 0] == tgt[:, None, :, 0])
                & (tgt[:, :, None, 1] == tgt[:, None, :, 1])
                & alive0[:, :, None] & alive0[:, None, :])
        multi = same.sum(2) >= 2
        deadly = (ttype == WALL) | (ttype == BODY) | (ttype == HEAD)
        dies = alive0 & (multi | deadly)
        primary = alive0 & ~(same & lower).any(2)
        credit = primary & ((ttype == BODY) | (ttype == HEAD))
        kills = torch.zeros((b, n), dtype=F32, device=dev).scatter_add(
            1, towner.long(), credit.to(F32))
        fruit_dead = primary & multi & (ttype == FRUIT)
        eats = alive0 & ~multi & ~deadly & (ttype == FRUIT)
        taken = (fruit_dead.sum(1) + eats.sum(1)).to(I32)

        tail_eq = ((tgt[:, None, :, 0] == s.tail[:, :, None, 0])
                   & (tgt[:, None, :, 1] == s.tail[:, :, None, 1]))
        chase = eats[:, :, None] & alive0[:, None, :] & tail_eq
        kills = kills + chase.sum(2).to(F32)
        alive_count = (s.alive_count - dies.sum(1).to(I32)
                       - chase.sum((1, 2)).to(I32))
        dead = dies | chase.any(1)
        alive1 = alive0 & ~dead

        prior = (alive1[:, None, :] & lower).any(2)
        win = (alive_count == 1)[:, None] & (n > 1) & alive1 & ~prior

        rew = (r_time * alive1.to(F32) + r_fruit * eats.to(F32)
               + r_lose * dead.to(F32) + r_kill * kills
               + r_win * win.to(F32))
        was_dead = ~alive0
        rew = torch.where(was_dead, 0.0, rew)
        fruits_stat = torch.where(was_dead, 0.0, eats.to(F32))
        kills_stat = torch.where(was_dead, 0.0, kills)

        t_pre, o_pre = grid & 15, grid >> OWNER_SHIFT
        dead_bits = (dead.to(I32) << idx).sum(1).to(I32)
        erase = (t_pre >= HEAD) & (((dead_bits[:, None, None] >> o_pre)
                                    & 1) > 0)
        flat = torch.where(erase, EMPTY, grid).to(I32).reshape(b, hw)

        # ring: push the new heading where alive, pop the tail where the
        # snake moved without eating
        retract = alive1 & ~eats
        ring_head = torch.where(alive1, (s.ring_head - 1) % cap, s.ring_head)
        bit = 2 * (ring_head & 15)
        words = torch.arange(g.ring_words, dtype=I32, device=dev)
        sel = ((ring_head >> 4)[..., None] == words) & alive1[..., None]
        three = torch.full_like(bit, 3)
        blended = ((s.ring & (~(three << bit))[..., None])
                   | ((new_dir & 3) << bit)[..., None])
        ring = torch.where(sel, blended, s.ring)
        ring_len = torch.where(alive1, s.ring_len + 1, s.ring_len)
        old = (ring_head + ring_len - 1) % cap
        word = torch.gather(ring, -1, (old >> 4).long()[..., None])[..., 0]
        popped = (word >> (2 * (old & 15))) & 3
        ring_len = torch.where(retract, ring_len - 1, ring_len)
        new_tail = torch.where(retract[..., None],
                               s.tail + self.delta(popped), s.tail)
        new_head = torch.where(alive1[..., None], tgt, s.head)

        hflat = s.head[..., 0] * w + s.head[..., 1]
        tlflat = s.tail[..., 0] * w + s.tail[..., 1]
        nh = new_head[..., 0] * w + new_head[..., 1]
        nt = new_tail[..., 0] * w + new_tail[..., 1]
        claimed = (tail_eq & alive1[:, None, :]).any(2)
        ids = idx << OWNER_SHIFT
        writes = (
            (hflat, BODY + ids, alive1 & ~(retract & (nt == hflat))),
            (tlflat, torch.full((n,), EMPTY, dtype=I32, device=dev),
             retract & ~claimed),
            (nh, HEAD + ids, alive1), (nt, TAIL + ids, alive1))
        for where_, val, ok in writes:
            for j in range(n):
                ij = where_[:, j:j + 1].long()
                cur = torch.gather(flat, 1, ij)
                flat = flat.scatter(1, ij, torch.where(ok[:, j:j + 1],
                                                       val[j], cur))

        mask = 1.0 - (~alive1).to(F32)
        scores = s.epi_scores + mask * rew
        steps = s.epi_steps + mask
        fruits = s.epi_fruits + mask * fruits_stat
        kills_e = s.epi_kills + mask * kills_stat
        length = s.episode_length + 1
        dones = ~alive1 | (length >= g.max_episode_steps)[:, None]
        done_all = dones.all(1)
        rank = (1 + (scores[:, None, :] > scores[:, :, None]).sum(2)).to(I32)
        out = Out(obs=None, reward=rew, done=dones, rank=rank,
                  episode_scores=scores, episode_steps=steps,
                  episode_fruits=fruits, episode_kills=kills_e,
                  done_all=done_all)
        zero = torch.zeros_like(scores)

        def reset_at_end(x):
            return torch.where(done_all[:, None], zero, x)

        new = State(grid=flat.view(b, h, w), direction=new_dir,
                    head=new_head, tail=new_tail, ring=ring,
                    ring_head=ring_head, ring_len=ring_len, alive=alive1,
                    alive_count=alive_count,
                    epi_scores=reset_at_end(scores),
                    epi_steps=reset_at_end(steps),
                    epi_fruits=reset_at_end(fruits),
                    epi_kills=reset_at_end(kills_e), episode_length=length)
        return new, out, taken

    def step(self, s: State, actions, fruit_u,
             hold: Optional[tuple] = None):
        """One move without reset; ``hold=(keep, out)`` leaves the envs
        where ``keep`` with the state and output they came in with."""
        new, out, taken = self._core(s, actions)
        new.grid = self.place_fruits(new.grid, fruit_u, taken)
        out.obs = self.obs(new.grid)
        if hold is not None:
            keep, old_out = hold
            new, out = select(keep, s, new), select(keep, old_out, out)
        return new, out

    def step_autoreset(self, s: State, actions, fruit_u, reset_spawn_u,
                       reset_fruit_u):
        """One move; where the episode ends, the state and obs are a fresh
        reset's, and the fruits are placed once on the chosen grid."""
        g = self.g
        n, nf = g.num_snakes, g.fruits
        new, out, taken = self._core(s, actions)
        done = out.done_all
        new = select(done, self._fresh(reset_spawn_u), new)
        b, m = s.grid.shape[0], max(n, nf)
        u_step = torch.zeros((b, m), dtype=F32, device=s.grid.device)
        u_step[:, :n] = fruit_u
        u_reset = torch.zeros((b, m), dtype=F32, device=s.grid.device)
        u_reset[:, :nf] = reset_fruit_u
        u = torch.where(done[:, None], u_reset, u_step)
        new.grid = self.place_fruits(new.grid, u,
                                     torch.where(done, nf, taken).to(I32))
        out.obs = self.obs(new.grid)
        return new, out
