"""Capability demo: thousands of snake games stepped as one batch on the
card, the JAX repository's ``examples/demo.py`` on the port.

A batch of envs runs ``--steps`` steps of a random policy with fused
auto-reset, obs, rewards and dones all on the device; then env 0 of the
batch is drawn in ASCII, beside the batch's fruit and death counts and
its throughput. JAX's rollout is one jitted ``lax.scan``; here it is a
loop of steps, each one launch of the auto-reset step kernel (K1) on the
card, with the actions and the step draws drawn up front
(``rng.rollout_draws``) and nothing read back until the end. The first
call (which builds the kernel if it is not built) and the steady state
are timed apart, each ended by a device synchronisation. The last line
printed is one JSON object of the counts, the times and the card.

    python -m marlsnake_torch.examples.demo                 # 1024 envs, 256 steps
    python -m marlsnake_torch.examples.demo --envs 4096 --steps 512
    python -m marlsnake_torch.examples.demo --cpu           # on the CPU
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from marlsnake_torch.core.render import render_ascii
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.rng import StepDraws, rollout_draws
from marlsnake_torch.utils.profiling import block_until_ready, card_label


def demo_config(height: int = 20, width: int = 20,
                snakes: int = 4) -> EnvConfig:
    return EnvConfig(height=height, width=width, num_snakes=snakes,
                     snake_length=5)


def play(env: VectorSnakeEnv, states, actions: torch.Tensor,
         draws: StepDraws):
    """Step ``actions`` (T, B, N) with ``draws`` from ``states``, yielding
    (states, the step's output) after each step."""
    for t in range(actions.shape[0]):
        states, out = env.step(states, actions[t], draws.at(t))
        yield states, out


def start(env: VectorSnakeEnv, steps: int, seed: int):
    """A reset and the draws of ``steps`` random-policy steps, all from
    ``seed``: (states, actions, draws), the arguments of ``play``."""
    states, _ = env.reset(seed)
    return (states,) + rollout_draws(env.cfg, env.num_envs, steps,
                                     env.generator, env.device)


def rollout(env: VectorSnakeEnv, states, actions: torch.Tensor,
            draws: StepDraws):
    """The steps of ``actions`` (T, B, N) and ``draws`` from ``states``:
    (states, fruits eaten, deaths), the counts int32 as JAX's: a fruit is
    a reward above half the fruit reward (a fruit step earns it plus the
    small time and lose terms), a death a snake's done flag."""
    fruits = torch.zeros((), dtype=torch.int32, device=env.device)
    deaths = torch.zeros((), dtype=torch.int32, device=env.device)
    for states, out in play(env, states, actions, draws):
        fruits += (out.reward > 0.5 * env.cfg.reward('fruit')).sum(
            dtype=torch.int32)
        deaths += out.done.sum(dtype=torch.int32)
    return states, fruits, deaths


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--envs', type=int, default=1024)
    p.add_argument('--steps', type=int, default=256)
    p.add_argument('--height', type=int, default=20)
    p.add_argument('--width', type=int, default=20)
    p.add_argument('--snakes', type=int, default=4)
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU (same as --device cpu)')
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    dev = resolve_device('cpu' if a.cpu else a.device)
    card = card_label(dev)
    cfg = demo_config(a.height, a.width, a.snakes)
    env = VectorSnakeEnv(cfg, a.envs, device=dev)
    print(f'{a.envs} envs x {a.steps} steps, {a.height}x{a.width}, '
          f'{a.snakes} snakes on {dev.type}...', flush=True)
    t0 = time.perf_counter()
    block_until_ready(rollout(env, *start(env, a.steps, 0)))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    states, fruits, deaths = block_until_ready(
        rollout(env, *start(env, a.steps, 1)))
    run = time.perf_counter() - t0

    total = a.envs * a.steps
    print(f'first call (incl. build): {first:.2f}s; '
          f'steady state: {run:.3f}s = {total / run:,.0f} env-steps/s')
    print(f'batch totals: {int(fruits)} fruits eaten, {int(deaths)} deaths '
          f'(envs auto-reset on episode end)')
    print('\nenv 0 of the batch after the rollout:')
    print(render_ascii(states.grid[0].cpu().numpy()))
    summary = dict(envs=a.envs, steps=a.steps, height=a.height,
                   width=a.width, snakes=a.snakes, card=card, first_s=first,
                   steady_s=run, env_steps_per_s=total / run,
                   fruits=int(fruits), deaths=int(deaths))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == '__main__':
    main()
