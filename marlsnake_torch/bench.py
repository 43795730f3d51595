"""Env-steps per second of the auto-reset rollout, the twin of ``bench.py``.

4096 envs of 20x20 with 4 snakes of length 3, pool spawn, uniform random
actions; each step's obs is consumed by a uint8 checksum, so the whole
obs pipeline is in the measurement. Prints ONE JSON line:
``{"metric", "value", "unit", "vs_baseline", "median", "spawn_mode",
"device"}``; ``value`` is the best of three timed blocks and ``median``
their median. Run ``python -m marlsnake_torch.bench`` on the GPU; pass
``--device cpu`` (and small sizes) to run the plain path on the CPU.

``--mode train`` times DQN training instead: milliseconds per episode and
env-steps/s of ``DQNTrainer.train_episode`` at 32 and 256 envs (20x20, 4
snakes of length 3, 256-step episodes, batch 512, ring of 10,000), for
``update_every`` 1 and 4, after one warm-up episode; one JSON line per
row, each with the device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import VectorSnakeEnv

BASELINE_STEPS_PER_SEC = 783.0  # reference single env on one CPU core


def rollout(env: VectorSnakeEnv, states, num_steps: int,
            generator: torch.Generator):
    """``num_steps`` random-action steps; returns (states, a checksum of
    every reward and obs byte)."""
    cfg = env.cfg
    rew = torch.zeros((), dtype=torch.float32, device=env.device)
    check = torch.zeros((), dtype=torch.uint8, device=env.device)
    for _ in range(num_steps):
        actions = torch.randint(0, cfg.num_actions,
                                (env.num_envs, cfg.num_snakes),
                                generator=generator, device=env.device,
                                dtype=torch.int32)
        states, out = env.step(states, actions)
        rew += out.reward.sum()
        check += out.obs.sum(dtype=torch.uint8)
    return states, rew + check.to(torch.float32)


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(num_envs: int = 4096, num_steps: int = 256, iters: int = 4,
        device='cuda', seed: int = 0) -> dict:
    cfg = EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
                    spawn_mode='pool')
    env = VectorSnakeEnv(cfg, num_envs, device=device, seed=seed)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed + 1)
    states, _ = env.reset()
    states, r = rollout(env, states, num_steps, gen)  # warm-up, build
    float(r)
    dts = []
    for _ in range(3):
        _sync(env.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            states, r = rollout(env, states, num_steps, gen)
        float(r)
        dts.append(time.perf_counter() - t0)
    total = num_envs * num_steps * iters
    best = total / min(dts)
    return {
        'metric': f'env-steps/s at {num_envs} parallel envs '
                  '(20x20, 4 snakes)',
        'value': best,
        'unit': 'env-steps/s',
        'vs_baseline': best / BASELINE_STEPS_PER_SEC,
        'median': total / sorted(dts)[1],
        'spawn_mode': cfg.spawn_mode,
        'device': _device_name(env.device),
    }


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')


def run_train(num_envs: int, update_every: int = 1, episodes: int = 3,
              device='cuda', **config) -> dict:
    """Mean wall time of ``episodes`` training episodes after one warm-up
    episode (which also fills the ring). Episodes end when their last env
    does, so ``steps_per_episode`` says how long they were. ``config``
    overrides fields of the ``DQNConfig`` (a small board for a CPU run)."""
    from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
    cfg = DQNConfig(**{**dict(
        height=20, width=20, num_snakes=4, snake_length=3,
        num_envs=num_envs, max_steps_per_episode=256, batch_size=512,
        min_buffer_size=512 * 3, buffer_size=10_000,
        update_every=update_every), **config})
    trainer = DQNTrainer(cfg, device=device)
    ts, m = trainer.train_episode(trainer.init_state())
    _sync(trainer.device)
    steps = updates = 0
    t0 = time.perf_counter()
    for _ in range(episodes):
        ts, m = trainer.train_episode(ts)
        steps += m.episode_length
        updates += m.updates
    _sync(trainer.device)
    dt = (time.perf_counter() - t0) / episodes
    return {
        'metric': f'DQN training episode ({cfg.height}x{cfg.width}, '
                  f'{cfg.num_snakes} snakes)',
        'num_envs': num_envs, 'update_every': update_every,
        'update_batch_size': trainer.update_batch,
        'episode_ms': dt * 1e3,
        'env_steps_per_s': num_envs * steps / episodes / dt,
        'steps_per_episode': steps / episodes,
        'updates_per_episode': updates / episodes,
        'device': _device_name(trainer.device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--num-envs', type=int, default=4096)
    ap.add_argument('--num-steps', type=int, default=256)
    ap.add_argument('--iters', type=int, default=4)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--mode', choices=('rollout', 'train'),
                    default='rollout')
    ap.add_argument('--episodes', type=int, default=3,
                    help='timed episodes per row (train mode)')
    a = ap.parse_args(argv)
    if a.mode == 'train':
        for num_envs in (32, 256):
            for every in (1, 4):
                print(json.dumps(run_train(num_envs, every, a.episodes,
                                           a.device)), flush=True)
        return
    print(json.dumps(run(a.num_envs, a.num_steps, a.iters, a.device,
                         a.seed)))


if __name__ == '__main__':
    main()
