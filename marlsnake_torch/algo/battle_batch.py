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
still (``hold``); on the CPU the plain engine does the same. The loop
stops once every env is done, as the steps left would change nothing.

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

from typing import Optional, Sequence

import numpy as np
import torch

from marlsnake_torch.algo.evaluator import DEADLY_CHANNELS
from marlsnake_torch.algo.neat_hybrid import PaddedNetBatch, as_dqn
from marlsnake_torch.core import types as T
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.ops.safety_mask import safety_mask
from marlsnake_torch.rng import BattleDraws, StepDraws, battle_draws

# own-body probes of the direction inference, in the reference's order
# (first hit wins; the snake moves away from the body cell)
_PROBES = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _flat_cells(plane: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                ) -> torch.Tensor:
    """``plane`` (B, H, W) read at (B, K) coordinates, clamped to it."""
    h, w = plane.shape[1:]
    idx = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
    return plane.flatten(1).gather(1, idx.long())


def greedy_step(obs: torch.Tensor, cur_dir: torch.Tensor, u: torch.Tensor):
    """One step of the reference greedy fruit-seeker for B envs.

    ``obs`` (B, H, W, C>=8) uint8 single-agent frames; ``cur_dir`` (B, 2)
    int32 with (0, 0) = not yet inferred (the reference's
    ``current_direction is None``); ``u`` (B, 3) float32 uniforms in
    [0, 1), the tie-break. Returns (action (B,) int32, new_dir (B, 2)).
    """
    b, h, w = obs.shape[:3]
    dev = obs.device
    rows = torch.arange(b, device=dev)
    flat_head = (obs[..., T.CH_MY_HEAD] == 1).flatten(1)
    head_exists = flat_head.any(-1)
    hidx = flat_head.to(torch.uint8).argmax(-1)      # first head, row-major
    hy = (hidx // w).to(torch.int32)
    hx = (hidx % w).to(torch.int32)

    # direction inference: the first probe that finds own body or tail
    # wins, the snake heads away from it; UP if none (train_dqn.py:795-803)
    body = (obs[..., T.CH_MY_BODY] == 1) | (obs[..., T.CH_MY_TAIL] == 1)
    probes = torch.tensor(_PROBES, dtype=torch.int32, device=dev)
    by = hy[:, None] + probes[:, 0]
    bx = hx[:, None] + probes[:, 1]
    inb = (by >= 0) & (by < h) & (bx >= 0) & (bx < w)
    hits = inb & _flat_cells(body, by, bx)            # (B, 4)
    up = torch.tensor((-1, 0), dtype=torch.int32, device=dev)
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
    deadly = (obs[..., list(DEADLY_CHANNELS)] == 1).any(-1)
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
    alive; its reward adds every step's until its env is frozen."""
    dev = resolve_device(device)
    n = cfg.num_snakes
    if len(opponents) != n - 1:
        raise ValueError(f'{len(opponents)} opponents for {n - 1} seats')
    if cfg.obs_format != 'uint8':
        raise ValueError('the battle reads the obs as uint8 planes: '
                         f"obs_format={cfg.obs_format!r} is not supported")
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=False, device=dev)
    kinds = tuple(op.draws for op in opponents)

    def q_values(params, obs0):
        return (net(obs0) if params is None
                else torch.func.functional_call(net, params, (obs0,)))

    @torch.no_grad()
    def run(params=None, seed: int = 0,
            draws: Optional[BattleDraws] = None):
        if draws is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            draws = battle_draws(cfg, kinds, num_envs, max_steps, gen, dev)
        states, obs = reset_fn(draws.reset)
        auxs = [op.init(num_envs, dev) for op in opponents]
        dones = torch.zeros((num_envs, n), dtype=torch.bool, device=dev)
        dirs = torch.zeros((num_envs, 2), dtype=torch.int32, device=dev)
        rew = torch.zeros((num_envs, n), dtype=torch.float32, device=dev)
        life = torch.zeros_like(rew)
        out = None
        for t in range(max_steps):
            frozen = dones.all(-1)
            obs0 = obs[:, 0]
            a0, new_dirs = masked_seat0(obs0, q_values(params, obs0), dirs,
                                        ~dones[:, 0], flood_limit)
            acts = [torch.where(dones[:, 0], 0, a0)]
            for i, op in enumerate(opponents):
                seat = draws.seat[i]
                ai, auxs[i] = op.apply(obs[:, i + 1], auxs[i],
                                       None if seat is None else seat[t])
                acts.append(torch.where(dones[:, i + 1], 0, ai))
            states, out = step_fn(states, torch.stack(acts, 1),
                                  StepDraws(draws.fruit_u[t], None, None),
                                  hold=(frozen, out) if t > 0 else None)
            obs = out.obs
            dirs = torch.where(frozen[:, None], dirs, new_dirs)
            # the host arena counts a lifetime step BEFORE acting and
            # adds the full reward vector (dead seats earn exactly 0)
            life = life + (~dones).to(torch.float32)
            rew = rew + torch.where(frozen[:, None], 0.0, out.reward)
            dones = dones | out.done
            if bool(dones.all()):
                break
        return rew, life

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
