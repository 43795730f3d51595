"""Safety-masked, batched DQN evaluation.

The port of the JAX package's ``algo/evaluator.py``: the reference's
inference-time masking (``DQN_Evaluator.get_action``) is
``ops/safety_mask.py`` (every veto, the flood fill, the masked argmax and
the claims in snake order), which runs as one launch of its CUDA kernel a
step on the card; ``masked_actions`` and ``masked_action_single`` are
re-exported here. A step of ``evaluate_batch`` is one forward, the masked
choice, and one launch of the CUDA step kernel's entry without
auto-reset, which holds the envs that were all done before the step
still (``hold``); on the CPU the plain engine and the plain mask do the
same. Where the JAX package runs the evaluation as one ``lax.scan``
program, the port runs it in chunks of up to 8 steps, on CUDA as the
replays of one captured graph, with one read-back a chunk.
``DQNEvaluator`` plays one env at a time through a ``GymAdapter`` with
the same masking, as the reference's evaluator does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from marlsnake_torch.core import types as T
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.ops.safety_mask import (  # noqa: F401 (re-exported)
    DEADLY_CHANNELS, masked_action_single, masked_actions)
from marlsnake_torch.rng import ResetDraws, StepDraws, reset_draws
from marlsnake_torch.utils.cuda_graph import (CapturedLoop, copy_into,
                                              run_chunks, tail_chunk_steps)


class EvalResult(NamedTuple):
    mean_reward: torch.Tensor    # () float32, over envs and snakes
    mean_lifetime: torch.Tensor  # () float32: steps a snake was alive
    steps: int                   # env steps taken


@dataclasses.dataclass
class _EvalBuffers:
    """What the evaluation's chunks carry, at fixed addresses."""
    envs: step_kernel.StaticEnvs
    dones: torch.Tensor    # (E, N) bool
    dirs: torch.Tensor     # (E, N, 2) int32: the mask's directions
    rew: torch.Tensor      # (E, N) float32
    life: torch.Tensor     # (E, N) float32
    steps: torch.Tensor    # () int32: steps begun with an env not done
    t: torch.Tensor        # (1,) int64: the next step's index
    fruit_u: torch.Tensor  # (max_steps, E, N) float32
    params: dict           # the net's state_dict
    flags: torch.Tensor    # (2,) int32: [live, steps]


def build_evaluate_batch(net, cfg: T.EnvConfig, num_envs: int = 256,
                         max_steps: int = 512, flood_limit: int = 60,
                         device='cuda'):
    """The batched evaluation ``run(params=None, seed=0, reset=None,
    fruit_u=None) -> EvalResult``: ``num_envs`` episodes at once, each
    step the masked policy of ``net`` (a ``DQN``, under ``params`` when
    given, a state_dict of its layout), the env step, and the freeze of
    every env that was all done before it. ``reset`` (``ResetDraws``) and
    ``fruit_u`` ((max_steps, num_envs, N) float32) default to draws from a
    generator seeded with ``seed``.

    The steps run in chunks of ``run.chunk_steps`` (``utils/cuda_graph``):
    on CUDA one captured graph, replayed; on the CPU the same body run
    directly. The host reads one flag a chunk and stops after the chunk
    in which every env was done, as the steps left would change nothing:
    the chunk's steps after that point, and past ``max_steps``, hold
    every env still and add nothing. ``EvalResult.steps`` is the step at
    which every env was done, or ``max_steps``. ``run.uncaptured`` runs
    the same chunks without the graph; ``run.captured_loops()`` lists
    the graph, ``run.buffers`` holds what it carries."""
    dev = resolve_device(device)
    if cfg.obs_format != 'uint8':
        raise ValueError('the evaluator reads the obs as uint8 planes: '
                         f"obs_format={cfg.obs_format!r} is not supported")
    n = cfg.num_snakes
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=False, device=dev)
    k = tail_chunk_steps(max_steps)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    b = _EvalBuffers(
        envs=step_kernel.StaticEnvs(cfg, num_envs, dev),
        dones=zeros((num_envs, n), torch.bool),
        dirs=zeros((num_envs, n, 2), torch.int32),
        rew=zeros((num_envs, n)), life=zeros((num_envs, n)),
        steps=zeros((), torch.int32), t=zeros((1,), torch.int64),
        fruit_u=zeros((max(max_steps, 1), num_envs, n)),
        params={name: torch.zeros_like(v)
                for name, v in net.state_dict().items()},
        flags=zeros((2,), torch.int32))

    def chunk():
        """``k`` steps over the buffers, branch-free, no read-back."""
        state, out = b.envs.state, b.envs.out
        dones, dirs, rew, life = b.dones, b.dirs, b.rew, b.life
        steps, t = b.steps, b.t
        for _ in range(k):
            # envs all done before the step stand still inside the
            # launch; past max_steps every env does
            frozen = dones.all(-1) | (t >= max_steps)
            active = ~dones & ~frozen[:, None]
            obs = out.obs
            flat = obs.reshape((num_envs * n,) + obs.shape[2:])
            q = torch.func.functional_call(net, b.params, (flat,))
            acts, new_dirs = masked_actions(obs, q.reshape(num_envs, n, -1),
                                            dirs, active, flood_limit)
            fruit = b.fruit_u.index_select(0, t.clamp(max=max_steps - 1))[0]
            state, out = step_fn(state, acts, StepDraws(fruit, None, None),
                                 hold=(frozen, out))
            dirs = torch.where(frozen[:, None, None], dirs, new_dirs)
            rew = rew + torch.where(active, out.reward, 0.0)
            life = life + active.to(torch.float32)
            dones = dones | out.done
            steps = steps + (~frozen.all()).to(torch.int32)
            t = t + 1
        b.envs.store(state, out)
        for dst, src in ((b.dones, dones), (b.dirs, dirs), (b.rew, rew),
                         (b.life, life), (b.steps, steps), (b.t, t)):
            dst.copy_(src)
        live = ~(dones.all() | (t[0] >= max_steps))
        b.flags.copy_(torch.stack([live.to(torch.int32), steps]))

    loop = CapturedLoop(chunk, dev)

    @torch.no_grad()
    def _run(params=None, seed: int = 0, reset: Optional[ResetDraws] = None,
             fruit_u: Optional[torch.Tensor] = None, captured: bool = True
             ) -> EvalResult:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if reset is None:
            reset = reset_draws(cfg, num_envs, gen, dev)
        if fruit_u is None:
            fruit_u = torch.rand((max_steps, num_envs, n), generator=gen,
                                 device=dev)
        states, obs = reset_fn(reset)
        b.envs.load(states)
        b.envs.out.obs.copy_(obs)
        for x in (b.dones, b.dirs, b.rew, b.life, b.steps, b.t, b.flags):
            x.zero_()
        b.fruit_u[:max_steps].copy_(fruit_u[:max_steps])
        copy_into(b.params, {**net.state_dict(), **(params or {})})
        _, steps = run_chunks(loop, b.flags, max_steps, k, captured,
                              name='eval')
        return EvalResult(b.rew.mean(), b.life.mean(), steps)

    def run(params=None, seed: int = 0, reset: Optional[ResetDraws] = None,
            fruit_u: Optional[torch.Tensor] = None) -> EvalResult:
        return _run(params, seed, reset, fruit_u)

    run.uncaptured = functools.partial(_run, captured=False)
    run.chunk_steps = k
    run.captured_loops = lambda: [loop]
    run.buffers = b
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
