"""Scale demo: 4,096 envs stepped as one batch, the JAX repository's
``examples/vector_rollout.py`` on the port.

The env batch lives on the card as one set of tensors, and each of the
256 steps of uniform random actions is one launch of the auto-reset step
kernel (K1), the actions and step draws drawn up front
(``rng.rollout_draws``); the rollout's result is the mean over the steps
of each step's mean reward over every snake, read back once. The first
call (which builds the kernel if it is not built) is not timed. The last
line printed is one JSON object of the rate, the reward and the card.

    python -m marlsnake_torch.examples.vector_rollout
    python -m marlsnake_torch.examples.vector_rollout --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from marlsnake_torch.algo.optim import mean_of
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.examples.demo import play, start
from marlsnake_torch.rng import StepDraws
from marlsnake_torch.utils.profiling import card_label

NUM_ENVS = 4096
STEPS = 256


def rollout_config() -> EnvConfig:
    return EnvConfig(height=20, width=20, num_snakes=4, snake_length=3)


def mean_reward(env: VectorSnakeEnv, states, actions: torch.Tensor,
                draws: StepDraws) -> torch.Tensor:
    """The mean over the steps of ``actions`` (T, B, N) and ``draws`` of
    each step's mean reward, both means as XLA's (``mean_of``)."""
    return mean_of(torch.stack([mean_of(out.reward) for _, out in
                                play(env, states, actions, draws)]))


def main(argv=None, num_envs: int = NUM_ENVS, steps: int = STEPS) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    card = card_label(dev)
    env = VectorSnakeEnv(rollout_config(), num_envs, device=dev)
    float(mean_reward(env, *start(env, steps, 0)))
    t0 = time.perf_counter()
    r = float(mean_reward(env, *start(env, steps, 1)))
    dt = time.perf_counter() - t0
    print(f'{num_envs * steps / dt:,.0f} env-steps/s '
          f'({num_envs} envs x {steps} steps in {dt:.2f}s), '
          f'mean reward {r:.4f}')
    summary = dict(envs=num_envs, steps=steps, card=card, seconds=dt,
                   env_steps_per_s=num_envs * steps / dt, mean_reward=r)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == '__main__':
    main()
