"""Device-batched battle arena: hundreds of simultaneous episodes.

The port of the JAX package's ``algo/battle_batch.py``. The host arena
(``algo/battle.py``) steps ONE env and asks each opponent on the host;
here every seat's policy is batched on the device: seat 0 plays the
safety-masked DQN evaluator policy and seats 1..N-1 any of the batched
opponents below, and E episodes run at once with freeze-on-done (the
``evaluate_batch`` pattern, ``algo/evaluator.py``), so the 4-way table
comes with confidence intervals over 100+ episodes.

A step is seat 0's forward and masked choice, each opponent's policy in
seat order, and one launch of the CUDA step kernel's entry without
auto-reset, which holds the envs that were all done before the step
still (``hold``); on the CPU the plain engine does the same. Where the
JAX package runs the battle as one ``lax.scan`` program, the port runs
it in chunks of up to 8 steps, on CUDA as the replays of one captured
graph, with one read-back a chunk; the loop stops after the chunk in
which every env is done, as the steps left would change nothing.

Seat 0 claims first, against an empty claim set, so its masked action
depends on its own obs alone: the forward and the safety mask run over
the E seat-0 frames (``masked_seat0``), not over all E x N agents as the
JAX arena's ``masked_actions`` does, for the same actions and
directions.

Policy parity notes:

* ``BatchedGreedy`` is the reference ``GreedyEnemy`` heuristic
  (train_dqn.py:774-856) vectorized over envs: the same direction
  inference probe order, the same first-nearest fruit (row-major
  argmin), the same illegal->forward fallback; score ties are broken
  uniformly at random (the reference's ``random.choice`` over the argmax
  set) by a <0.5 uniform added to the integer scores, the uniforms a draw
  (``rng.BattleDraws``).
* ``BatchedRandom`` plays the drawn actions.
* ``BatchedDQN`` / ``BatchedPPO`` are the greedy policies of
  ``opponents.DQNAgent`` / ``PPOAgent``, batched.
* ``BatchedNEAT`` runs the frozen-DQN features and the evolved head
  through ``neat_hybrid.PaddedNetBatch`` (``FeedForwardNetwork.activate``
  exactly).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from marlsnake_torch.algo.evaluator import DEADLY_CHANNELS
from marlsnake_torch.algo.neat_hybrid import PaddedNetBatch, as_dqn
from marlsnake_torch.core import types as T
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.ops.safety_mask import safety_mask
from marlsnake_torch.rng import BattleDraws, StepDraws, battle_draws
from marlsnake_torch.utils.cuda_graph import (CapturedLoop, copy_into,
                                              run_chunks, tail_chunk_steps)

# own-body probes of the direction inference, in the reference's order
# (first hit wins; the snake moves away from the body cell)
_PROBES = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _flat_cells(plane: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                ) -> torch.Tensor:
    """``plane`` (B, H, W) read at (B, K) coordinates, clamped to it."""
    h, w = plane.shape[1:]
    idx = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
    return plane.flatten(1).gather(1, idx.long())


@functools.lru_cache(maxsize=None)
def _greedy_constants(device: torch.device):
    """(the probes (4, 2), UP (2,), the deadly channels' indices) on
    ``device``, made once: a captured graph may not copy from the host."""
    return (torch.tensor(_PROBES, dtype=torch.int32, device=device),
            torch.tensor((-1, 0), dtype=torch.int32, device=device),
            torch.tensor(DEADLY_CHANNELS, dtype=torch.long, device=device))


def greedy_step(obs: torch.Tensor, cur_dir: torch.Tensor, u: torch.Tensor):
    """One step of the reference greedy fruit-seeker for B envs.

    ``obs`` (B, H, W, C>=8) uint8 single-agent frames; ``cur_dir`` (B, 2)
    int32 with (0, 0) = not yet inferred (the reference's
    ``current_direction is None``); ``u`` (B, 3) float32 uniforms in
    [0, 1), the tie-break. Returns (action (B,) int32, new_dir (B, 2)).
    """
    b, h, w = obs.shape[:3]
    dev = obs.device
    probes, up, deadly_channels = _greedy_constants(dev)
    rows = torch.arange(b, device=dev)
    flat_head = (obs[..., T.CH_MY_HEAD] == 1).flatten(1)
    head_exists = flat_head.any(-1)
    hidx = flat_head.to(torch.uint8).argmax(-1)      # first head, row-major
    hy = (hidx // w).to(torch.int32)
    hx = (hidx % w).to(torch.int32)

    # direction inference: the first probe that finds own body or tail
    # wins, the snake heads away from it; UP if none (train_dqn.py:795-803)
    body = (obs[..., T.CH_MY_BODY] == 1) | (obs[..., T.CH_MY_TAIL] == 1)
    by = hy[:, None] + probes[:, 0]
    bx = hx[:, None] + probes[:, 1]
    inb = (by >= 0) & (by < h) & (bx >= 0) & (bx < w)
    hits = inb & _flat_cells(body, by, bx)            # (B, 4)
    inferred = torch.where(hits.any(-1, keepdim=True),
                           -probes[hits.to(torch.uint8).argmax(-1)], up)
    uninit = (cur_dir == 0).all(-1, keepdim=True)
    d = torch.where(uninit, inferred, cur_dir)
    dy, dx = d[:, 0], d[:, 1]

    # relative moves: 0 forward, 1 left, 2 right
    moves = torch.stack([torch.stack([dy, dx], -1),
                         torch.stack([-dx, dy], -1),
                         torch.stack([dx, -dy], -1)], 1)   # (B, 3, 2)
    ny = hy[:, None] + moves[..., 0]
    nx = hx[:, None] + moves[..., 1]
    inb = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    deadly = (obs.index_select(-1, deadly_channels) == 1).any(-1)
    legal = inb & ~_flat_cells(deadly, ny, nx)

    # nearest fruit by Manhattan distance, first (row-major) on ties
    fruit = obs[..., T.CH_FRUIT] == 1
    ys = torch.arange(h, dtype=torch.int32, device=dev)
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    dist = ((ys[None, :, None] - hy[:, None, None]).abs()
            + (xs[None, None, :] - hx[:, None, None]).abs())
    dist = torch.where(fruit, dist, 1 << 30)
    fidx = dist.flatten(1).argmin(-1)
    any_fruit = fruit.flatten(1).any(-1)
    ty, tx = fidx // w, fidx % w
    scores = -((ny - ty[:, None]).abs()
               + (nx - tx[:, None]).abs()).to(torch.float32)
    scores = torch.where(any_fruit[:, None], scores, 0.0)
    scores = torch.where(legal, scores, float('-inf'))
    # integer scores differ by >= 1, so +U[0, 0.5) breaks exact ties
    # uniformly without reordering distinct scores (-inf stays -inf)
    chosen = torch.where(legal.any(-1), (scores + u * 0.5).argmax(-1), 0)
    new_dir = moves[rows, chosen]
    act = torch.where(head_exists, chosen, 0).to(torch.int32)
    # no head: direction state is untouched (incl. the uninit sentinel),
    # like the reference's early `return 0` before any inference
    new_dir = torch.where(head_exists[:, None], new_dir, cur_dir)
    return act, new_dir


# Every batched opponent: ``name``; ``draws``, what it draws a step
# ('tiebreak', 'action' or None, ``rng.battle_draws``);
# ``init(num_envs, device)``, its state
# carried from step to step; ``apply(obs (E, H, W, C), state, draw) ->
# (actions (E,) int32, state)``, with ``draw`` that step's of its seat.

class BatchedGreedy:
    name = 'Greedy Bot'
    draws = 'tiebreak'

    def init(self, num_envs: int, device):
        return torch.zeros((num_envs, 2), dtype=torch.int32, device=device)

    def apply(self, obs, aux, draw):
        return greedy_step(obs, aux, draw)


class BatchedRandom:
    name = 'Random'
    draws = 'action'

    def init(self, num_envs: int, device):
        return ()

    def apply(self, obs, aux, draw):
        return draw, aux


class BatchedDQN:
    """The greedy policy of ``net``, a ``DQN`` holding its weights."""
    name = 'DQN'
    draws = None

    def __init__(self, net):
        self.net = net

    def init(self, num_envs: int, device):
        return ()

    def apply(self, obs, aux, draw):
        return self.net(obs).argmax(-1).to(torch.int32), aux


class BatchedPPO:
    """The greedy actor of ``net``, an ``ActorCritic`` holding its
    weights."""
    name = 'PPO'
    draws = None

    def __init__(self, net):
        self.net = net

    def init(self, num_envs: int, device):
        return ()

    def apply(self, obs, aux, draw):
        return self.net(obs)[0].argmax(-1).to(torch.int32), aux


class BatchedNEAT:
    """A hybrid checkpoint's policy: ``dqn`` (the port's ``DQN``, its
    state_dict or flax DQN parameters) built for ``cfg``'s obs, and the
    genome's net as a ``PaddedNetBatch`` of one, on ``device``."""
    name = 'Hybrid NEAT'
    draws = None

    def __init__(self, dqn, genome, neat_config, cfg: T.EnvConfig,
                 device='cuda'):
        dev = resolve_device(device)
        self.net = as_dqn(dqn, cfg, dev)
        self.batch = PaddedNetBatch([genome], neat_config, device=dev)

    def init(self, num_envs: int, device):
        return ()

    def apply(self, obs, aux, draw):
        feats = self.net.features(obs)
        return self.batch.acts(feats[None])[0], aux   # pop-dim of 1


def masked_seat0(obs0: torch.Tensor, q0: torch.Tensor, dir0: torch.Tensor,
                 alive0: torch.Tensor, flood_limit: int = 60):
    """Seat 0's masked action in each of E envs, where seat 0 is the only
    active seat (the single-env arena's ``active = [alive0, False, ...]``):
    obs0 (E, H, W, C) uint8, q0 (E, 3), dir0 (E, 2) with ``(0, 0)``
    unknown, alive0 (E,) bool. Seat 0 claims first, against an empty claim
    set, so this is ``masked_actions(...)[..., 0]`` of the whole env and
    its direction: the safety mask of one snake an env (one launch of its
    kernel on the card). Returns (action (E,) int32, new_dir (E, 2)); an
    inactive seat acts 0 and keeps its direction."""
    out = safety_mask(obs0[:, None], q0[:, None], dir0[:, None],
                      alive0[:, None], None, flood_limit)
    return out.act[:, 0], out.new_dir[:, 0]


@dataclasses.dataclass
class _BattleBuffers:
    """What the battle's chunks carry, at fixed addresses."""
    envs: step_kernel.StaticEnvs
    dones: torch.Tensor    # (E, N) bool
    dirs: torch.Tensor     # (E, 2) int32: seat 0's mask directions
    rew: torch.Tensor      # (E, N) float32
    life: torch.Tensor     # (E, N) float32
    t: torch.Tensor        # (1,) int64: the next step's index
    fruit_u: torch.Tensor  # (max_steps, E, N) float32
    seats: tuple           # each opponent's draws (max_steps, E, ...), or None
    auxs: list             # each opponent's carried state
    params: dict           # seat 0's state_dict
    flags: torch.Tensor    # (1,) int32: [live]


def build_battle_batch(net, cfg: T.EnvConfig, opponents: Sequence,
                       num_envs: int = 128, max_steps: int = 512,
                       flood_limit: int = 60, device='cuda'):
    """``run(params=None, seed=0, draws=None) -> (rewards, lifetimes)``,
    per-episode float32 (num_envs, N) on ``device``: seat 0 plays the
    masked policy of ``net`` (a ``DQN``, under ``params`` when given, a
    state_dict of its layout), seats 1..N-1 ``opponents`` in order.
    ``draws`` (``rng.BattleDraws``) default to draws from a generator
    seeded with ``seed``. A finished seat acts 0; an env whose seats are
    all done is held still. A seat's lifetime counts the steps it began
    alive; its reward adds every step's until its env is frozen.

    The steps run in chunks of ``run.chunk_steps`` (``utils/cuda_graph``):
    on CUDA one captured graph, replayed; on the CPU the same body run
    directly. The host reads one flag a chunk and stops after the chunk
    in which every env was done: the chunk's steps after that point, and
    past ``max_steps``, hold every env still and add nothing. The
    opponents' nets hold their weights at fixed addresses; their carried
    state and each step's draws are buffers of the graph.
    ``run.uncaptured`` runs the same chunks without the graph;
    ``run.captured_loops()`` lists the graph, ``run.buffers`` holds what
    it carries."""
    dev = resolve_device(device)
    n = cfg.num_snakes
    if len(opponents) != n - 1:
        raise ValueError(f'{len(opponents)} opponents for {n - 1} seats')
    if cfg.obs_format != 'uint8':
        raise ValueError('the battle reads the obs as uint8 planes: '
                         f"obs_format={cfg.obs_format!r} is not supported")
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=False, device=dev)
    kinds = tuple(op.draws for op in opponents)
    k = tail_chunk_steps(max_steps)
    rows = max(max_steps, 1)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    seat_shapes = {'tiebreak': ((rows, num_envs, 3), torch.float32),
                   'action': ((rows, num_envs), torch.int32)}
    b = _BattleBuffers(
        envs=step_kernel.StaticEnvs(cfg, num_envs, dev),
        dones=zeros((num_envs, n), torch.bool),
        dirs=zeros((num_envs, 2), torch.int32),
        rew=zeros((num_envs, n)), life=zeros((num_envs, n)),
        t=zeros((1,), torch.int64), fruit_u=zeros((rows, num_envs, n)),
        seats=tuple(None if kind is None else zeros(*seat_shapes[kind])
                    for kind in kinds),
        auxs=[op.init(num_envs, dev) for op in opponents],
        params={name: torch.zeros_like(v)
                for name, v in net.state_dict().items()},
        flags=zeros((1,), torch.int32))

    def chunk():
        """``k`` steps over the buffers, branch-free, no read-back."""
        state, out = b.envs.state, b.envs.out
        dones, dirs, rew, life, t = b.dones, b.dirs, b.rew, b.life, b.t
        auxs = list(b.auxs)
        for _ in range(k):
            # envs all done before the step stand still inside the
            # launch; past max_steps every env does
            frozen = dones.all(-1) | (t >= max_steps)
            go = ~frozen.all()
            row = t.clamp(max=max_steps - 1)
            obs = out.obs
            obs0 = obs[:, 0]
            q0 = torch.func.functional_call(net, b.params, (obs0,))
            a0, new_dirs = masked_seat0(obs0, q0, dirs, ~dones[:, 0],
                                        flood_limit)
            acts = [torch.where(dones[:, 0], 0, a0)]
            for i, op in enumerate(opponents):
                seat = b.seats[i]
                ai, aux = op.apply(obs[:, i + 1], auxs[i],
                                   None if seat is None
                                   else seat.index_select(0, row)[0])
                # a carried state moves only while a step is live
                auxs[i] = (torch.where(go, aux, auxs[i])
                           if isinstance(aux, torch.Tensor) else aux)
                acts.append(torch.where(dones[:, i + 1], 0, ai))
            state, out = step_fn(
                state, torch.stack(acts, 1),
                StepDraws(b.fruit_u.index_select(0, row)[0], None, None),
                hold=(frozen, out))
            dirs = torch.where(frozen[:, None], dirs, new_dirs)
            # the host arena counts a lifetime step BEFORE acting and
            # adds the full reward vector (dead seats earn exactly 0)
            life = life + (~dones & ~frozen[:, None]).to(torch.float32)
            rew = rew + torch.where(frozen[:, None], 0.0, out.reward)
            dones = dones | out.done
            t = t + 1
        b.envs.store(state, out)
        for dst, src in ((b.dones, dones), (b.dirs, dirs), (b.rew, rew),
                         (b.life, life), (b.t, t)):
            dst.copy_(src)
        copy_into(b.auxs, auxs)
        live = ~(dones.all() | (t[0] >= max_steps))
        b.flags.copy_(live.to(torch.int32)[None])

    loop = CapturedLoop(chunk, dev)

    @torch.no_grad()
    def _run(params=None, seed: int = 0,
             draws: Optional[BattleDraws] = None, captured: bool = True):
        if draws is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            draws = battle_draws(cfg, kinds, num_envs, max_steps, gen, dev)
        states, obs = reset_fn(draws.reset)
        b.envs.load(states)
        b.envs.out.obs.copy_(obs)
        for x in (b.dones, b.dirs, b.rew, b.life, b.t, b.flags):
            x.zero_()
        copy_into(b.auxs, [op.init(num_envs, dev) for op in opponents])
        b.fruit_u[:max_steps].copy_(draws.fruit_u[:max_steps])
        for dst, src in zip(b.seats, draws.seat, strict=True):
            if dst is not None:
                dst[:max_steps].copy_(src[:max_steps])
        copy_into(b.params, {**net.state_dict(), **(params or {})})
        run_chunks(loop, b.flags, max_steps, k, captured, name='battle')
        return b.rew.clone(), b.life.clone()

    def run(params=None, seed: int = 0,
            draws: Optional[BattleDraws] = None):
        return _run(params, seed, draws)

    run.uncaptured = functools.partial(_run, captured=False)
    run.chunk_steps = k
    run.captured_loops = lambda: [loop]
    run.buffers = b
    return run


def summarize(rewards, lifetimes, names) -> str:
    """Mean +- 95% CI table over the episode batch."""
    r = torch.as_tensor(rewards).cpu().numpy()
    t = torch.as_tensor(lifetimes).cpu().numpy()
    b = r.shape[0]
    lines = ['=' * 78,
             f'{"ALGORITHM":<20} | {"MEAN REWARD":>20} | '
             f'{"MEAN LIFETIME":>20} | n={b}',
             '-' * 78]
    for i, name in enumerate(names):
        ci_r = 1.96 * r[:, i].std(ddof=1) / np.sqrt(b)
        ci_t = 1.96 * t[:, i].std(ddof=1) / np.sqrt(b)
        lines.append(f'{name:<20} | {r[:, i].mean():>10.2f} ±{ci_r:>7.2f}'
                     f' | {t[:, i].mean():>10.1f} ±{ci_t:>7.1f} |')
    lines.append('=' * 78)
    return '\n'.join(lines)
