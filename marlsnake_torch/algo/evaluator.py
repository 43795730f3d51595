"""Safety-masked, batched DQN evaluation.

The port of the JAX package's ``algo/evaluator.py`` (the reference's
inference-time masking, ``DQN_Evaluator.get_action``): a snake's three
moves are vetoed when

1. the target is off the board, or holds a wall, a body, a tail or an
   enemy head (the deadly channels),
2. an earlier snake of the same env claimed the target this step,
3. a 4-neighbour of the target holds an enemy head (head-to-head risk),
4. the space reachable from the target on the post-move board (old head
   turned to body, the tail cleared unless the move eats) is smaller than
   the snake's post-move length (``ops/floodfill.py``),

and the snake takes the argmax of its Q-values over what is left (the
first move where all three are vetoed, as ``jnp.argmax`` of three
``-inf``). Every veto but the claims reads one snake's own obs, so all of
them are computed for every (env, snake, move) at once, the flood fills
in one ``flood_limit``-long loop; only the claim and the argmax run snake
by snake, which is exact. A step of ``evaluate_batch`` is one forward, the
masked choice, and one launch of the CUDA step kernel's entry without
auto-reset, which holds the envs that were all done before the step
still (``hold``); on the CPU the plain engine does the same.
``DQNEvaluator`` plays one env at a time through a ``GymAdapter`` with the
same masking, as the reference's evaluator does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from marlsnake_torch.core import types as T
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.ops.floodfill import reachable_count
from marlsnake_torch.rng import ResetDraws, StepDraws, reset_draws

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
    """Every veto of ``masked_action_single`` but the claim set, for obs
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
    space = reachable_count(~board.view(s, 3, h, w),
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


def masked_action_single(obs_i: torch.Tensor, q_i: torch.Tensor,
                         cur_dir: torch.Tensor, claimed: torch.Tensor,
                         flood_limit: int = 60):
    """One snake's masked action, batched over any leading axes: obs
    (..., H, W, C >= 8) uint8, q (..., 3), cur_dir (..., 2) with ``(0, 0)``
    unknown (derived from the body), claimed (..., H, W) bool. Returns
    (action, new_dir (..., 2), next_pos (..., 2), head_exists)."""
    lead = obs_i.shape[:-3]
    flat = obs_i.reshape((-1,) + obs_i.shape[-3:])
    m = _snake_moves(flat, cur_dir.reshape(-1, 2), flood_limit)
    act, new_dir, next_pos = _choose(m, q_i.reshape(-1, 3),
                                     claimed.reshape(flat.shape[:3]))
    return (act.reshape(lead), new_dir.reshape(lead + (2,)),
            next_pos.reshape(lead + (2,)), m.head_exists.reshape(lead))


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
    q = q.reshape(e, n, -1)
    cur_dirs = cur_dirs.reshape(e, n, 2).to(torch.int32)
    active = active.reshape(e, n)
    m = _snake_moves(obs.reshape(e * n, h, w, c), cur_dirs.reshape(-1, 2),
                     flood_limit)
    m = _Moves(*(x.view((e, n) + x.shape[1:]) for x in m))
    claimed = torch.zeros((e, h * w), dtype=torch.bool, device=obs.device)
    acts, dirs = [], []
    for i in range(n):
        mi = m.index(i)
        act, new_dir, nxt = _choose(mi, q[:, i], claimed.view(e, h, w))
        do_claim = (mi.head_exists & active[:, i])[:, None]
        idx = (nxt[:, :1].clamp(0, h - 1) * w
               + nxt[:, 1:].clamp(0, w - 1)).long()
        claimed.scatter_(1, idx, claimed.gather(1, idx) | do_claim)
        acts.append(torch.where(active[:, i], act, 0))
        dirs.append(torch.where(active[:, i, None], new_dir, cur_dirs[:, i]))
    return (torch.stack(acts, -1).reshape(lead + (n,)),
            torch.stack(dirs, 1).reshape(lead + (n, 2)))


class EvalResult(NamedTuple):
    mean_reward: torch.Tensor    # () float32, over envs and snakes
    mean_lifetime: torch.Tensor  # () float32: steps a snake was alive
    steps: int                   # env steps taken


def build_evaluate_batch(net, cfg: T.EnvConfig, num_envs: int = 256,
                         max_steps: int = 512, flood_limit: int = 60,
                         device='cuda'):
    """The batched evaluation ``run(params=None, seed=0, reset=None,
    fruit_u=None) -> EvalResult``: ``num_envs`` episodes at once, each
    step the masked policy of ``net`` (a ``DQN``, under ``params`` when
    given, a state_dict of its layout), the env step, and the freeze of
    every env that was all done before it. ``reset`` (``ResetDraws``) and
    ``fruit_u`` ((max_steps, num_envs, N) float32) default to draws from a
    generator seeded with ``seed``. The loop stops once every env is done,
    as the steps left would change nothing."""
    dev = resolve_device(device)
    if cfg.obs_format != 'uint8':
        raise ValueError('the evaluator reads the obs as uint8 planes: '
                         f"obs_format={cfg.obs_format!r} is not supported")
    n = cfg.num_snakes
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=False, device=dev)

    def policy(params, obs, dirs, active):
        e = obs.shape[0]
        flat = obs.reshape((e * n,) + obs.shape[2:])
        q = (net(flat) if params is None
             else torch.func.functional_call(net, params, (flat,)))
        return masked_actions(obs, q.reshape(e, n, -1), dirs, active,
                              flood_limit)

    @torch.no_grad()
    def run(params=None, seed: int = 0, reset: Optional[ResetDraws] = None,
            fruit_u: Optional[torch.Tensor] = None) -> EvalResult:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if reset is None:
            reset = reset_draws(cfg, num_envs, gen, dev)
        if fruit_u is None:
            fruit_u = torch.rand((max_steps, num_envs, n), generator=gen,
                                 device=dev)
        states, obs = reset_fn(reset)
        dones = torch.zeros((num_envs, n), dtype=torch.bool, device=dev)
        dirs = torch.zeros((num_envs, n, 2), dtype=torch.int32, device=dev)
        rew = torch.zeros((num_envs, n), dtype=torch.float32, device=dev)
        life = torch.zeros_like(rew)
        out, steps = None, 0
        for t in range(max_steps):
            active = ~dones
            frozen = dones.all(-1)
            acts, new_dirs = policy(params, obs, dirs, active)
            # envs all done before the step stand still inside the launch
            states, out = step_fn(states, acts,
                                  StepDraws(fruit_u[t], None, None),
                                  hold=(frozen, out) if t > 0 else None)
            obs = out.obs
            dirs = torch.where(frozen[:, None, None], dirs, new_dirs)
            rew = rew + torch.where(active, out.reward, 0.0)
            life = life + active.to(torch.float32)
            dones = dones | out.done
            steps = t + 1
            if bool(dones.all()):
                break
        return EvalResult(rew.mean(), life.mean(), steps)

    return run


def evaluate_batch(net, params, cfg: T.EnvConfig, num_envs: int = 256,
                   max_steps: int = 512, flood_limit: int = 60,
                   seed: int = 0, device='cuda'):
    """(mean reward, mean lifetime) of ``num_envs`` masked episodes; see
    :func:`build_evaluate_batch`."""
    run = build_evaluate_batch(net, cfg, num_envs, max_steps, flood_limit,
                               device)
    r = run(params, seed)
    return float(r.mean_reward), float(r.mean_lifetime)


class DQNEvaluator:
    """Episode evaluator with safety masking (train_dqn.py:582-676), one
    env at a time through a ``GymAdapter``-style env (``reset() -> obs``,
    ``step(list) -> (obs, rews, dones, info)``, numpy on the host): each
    step the DQN's Q-values of the env's obs on the net's device, the
    masked choice (``masked_actions``) and the env's step. ``params`` is
    a state_dict of the net's layout, or None for the net's own."""

    def __init__(self, env, net, params=None, flood_limit: int = 60):
        self.env = env
        self.net = net
        self.params = params
        self.flood_limit = flood_limit
        self.device = next(net.parameters()).device

    @torch.no_grad()
    def _policy(self, obs, cur_dirs, active):
        q = (self.net(obs) if self.params is None
             else torch.func.functional_call(self.net, self.params, (obs,)))
        return masked_actions(obs, q, cur_dirs, active, self.flood_limit)

    def evaluate(self, num_episodes: int = 1, render: bool = False,
                 max_steps: int = 1000, verbose: bool = True):
        n = self.env.num_snakes
        total_rewards = 0.0
        total_steps = 0.0
        for ep in range(num_episodes):
            obs = self.env.reset()
            dones = [False] * n
            dirs = torch.zeros((n, 2), dtype=torch.int32, device=self.device)
            ep_rewards = np.zeros(n)
            timelifes = np.zeros(n)
            steps = 0
            while not all(dones) and steps < max_steps:
                if render:
                    self.env.render()
                active = np.array([not d for d in dones])
                timelifes += active
                acts, dirs = self._policy(
                    torch.as_tensor(obs, device=self.device), dirs,
                    torch.as_tensor(active, device=self.device))
                obs, rews, dones, _ = self.env.step(acts.tolist())
                ep_rewards += np.asarray(rews)
                steps += 1
            avg_r, avg_t = ep_rewards.mean(), timelifes.mean()
            total_rewards += avg_r
            total_steps += avg_t
            if verbose:
                print(f'Ep {ep + 1:3d}: Avg Reward: {avg_r:6.2f} | '
                      f'Avg Timelife: {avg_t:5.1f} steps')
        final_r = total_rewards / num_episodes
        final_t = total_steps / num_episodes
        if verbose:
            print('-' * 50)
            print(f'FINAL RESULTS OVER {num_episodes} EPISODES:')
            print(f' >> Average Reward per Snake: {final_r:.2f}')
            print(f' >> Average Timelife per Snake: {final_t:.2f} steps')
            print('-' * 50)
        return final_r, final_t
