"""Training showcase: the JAX package's ``examples/train_showcase.py`` on
the port. Three short runs that produce learning curves (metrics JSONL)
and, for the DQN and the 20x20 PPO, a checkpoint:

* ``dqn``: 10x10, 2 snakes of length 3, 32 envs, 128 steps an episode,
  batch 256, min buffer 1,024, ring 50,000, epsilon decay 0.99, target
  sync every 20 episodes; 400 episodes, a row every 10;
* ``ppo``: 10x10, 2 snakes of length 3, 128 envs, 64 rollout steps; 150
  updates, a row every 5;
* ``ppo20``: 20x20, 4 snakes of length 5, 256 envs, 128 rollout steps,
  ``ent_coef=0.01``; 400 updates by default, a row every 5.

The configs are the JAX script's field for field, and each row has the
JAX rows' keys. The runs drive the trainers' own entry points:
``DQNTrainer.train_episode`` (the episode as replays of its captured
chunk graph) and ``PPOTrainer.update`` (the rollout as one captured
graph). Curves go to ``OUT/{dqn,ppo,ppo20}_learning_curve.seed{S}.jsonl``
and checkpoints under ``OUT/ckpt/``. Each run ends with one JSON line of
its times and the card they were taken on.

    python -m marlsnake_torch.examples.train_showcase dqn --seed 0
    python -m marlsnake_torch.examples.train_showcase ppo20 --updates 1200
    python -m marlsnake_torch.examples.train_showcase ppo --device cpu \\
        --updates 5 --out /tmp/showcase

The runs take the GPU unless ``--device cpu`` is given. From Python,
``run_dqn``, ``run_ppo`` and ``run_ppo20`` also take ``num_envs`` (a
narrowed run, for a short check on the CPU; refused into the default
``OUT``, whose curves are made at the configs' own widths) and
``every`` (the rows' cadence); the summary line names the width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Iterator, Optional, Sequence, Tuple

import torch

from marlsnake_torch.algo.dqn_trainer import (DQNConfig, DQNTrainer,
                                              EpisodeMetrics, TrainState)
from marlsnake_torch.algo.ppo_trainer import (PPOConfig, PPOMetrics,
                                              PPOTrainer, PPOTrainState)
from marlsnake_torch.utils.profiling import card_label

OUT_DIR = os.path.join('artifacts', 'torch')
DQN_EVERY = 10     # a DQN row every 10 episodes, as the JAX script writes
PPO_EVERY = 5      # a PPO row every 5 updates


def dqn_config(seed: int = 0, out: str = OUT_DIR) -> DQNConfig:
    """The JAX script's ``run_dqn`` config."""
    return DQNConfig(height=10, width=10, num_snakes=2, snake_length=3,
                     num_envs=32, max_steps_per_episode=128,
                     batch_size=256, min_buffer_size=1024,
                     buffer_size=50_000, epsilon_decay=0.99,
                     target_update_freq=20, save_freq=0,
                     save_best_only=False, seed=seed,
                     save_dir=os.path.join(out, 'ckpt', f'dqn.seed{seed}'))


def ppo_config(seed: int = 0, updates: int = 150) -> PPOConfig:
    """The JAX script's ``run_ppo`` config."""
    return PPOConfig(height=10, width=10, num_snakes=2, snake_length=3,
                     num_envs=128, rollout_steps=64, num_updates=updates,
                     seed=seed)


def ppo20_config(seed: int = 0, updates: int = 400,
                 out: str = OUT_DIR) -> PPOConfig:
    """The JAX script's ``run_ppo20`` config."""
    return PPOConfig(height=20, width=20, num_snakes=4, snake_length=5,
                     num_envs=256, rollout_steps=128, num_updates=updates,
                     ent_coef=0.01, seed=seed,
                     save_dir=os.path.join(out, 'ckpt', f'ppo20.seed{seed}'))


def dqn_episodes(tr: DQNTrainer, ts: TrainState, episodes: int,
                 draws: Optional[Sequence[Tuple]] = None
                 ) -> Iterator[Tuple[int, TrainState, EpisodeMetrics]]:
    """(episode, state after it, its metrics) for episodes 1..``episodes``,
    each through ``tr.train_episode``. ``draws[i]`` (a (reset, train
    draws) pair) is handed to episode i + 1 where given; else the
    trainer's generators draw."""
    for ep in range(1, episodes + 1):
        if draws is None:
            ts, m = tr.train_episode(ts)
        else:
            reset, train = draws[ep - 1]
            ts, m = tr.train_episode(ts, train, reset)
        yield ep, ts, m


def dqn_row(ep: int, ts: TrainState, m: EpisodeMetrics,
            elapsed: float) -> dict:
    """A DQN curve row, with the JAX rows' keys and types."""
    return dict(episode=ep, mean_reward=float(m.mean_reward),
                loss=float(m.mean_loss), epsilon=float(ts.epsilon),
                episode_length=float(m.episode_length),
                elapsed=round(elapsed, 1))


def ppo_updates(tr: PPOTrainer, ts: PPOTrainState, updates: int,
                draws: Optional[Sequence] = None
                ) -> Iterator[Tuple[int, PPOTrainState, PPOMetrics]]:
    """(update, state after it, its metrics) for updates 1..``updates``,
    each through ``tr.update``, with ``draws[i]`` (``PPODraws``) where
    given."""
    for u in range(1, updates + 1):
        ts, m = tr.update(ts, None if draws is None else draws[u - 1])
        yield u, ts, m


def ppo_row(u: int, m: PPOMetrics, elapsed: float) -> dict:
    """A PPO curve row, with the JAX rows' keys and types."""
    return dict(update=u, mean_episode_return=float(m.mean_episode_return),
                reward_per_step=float(m.mean_reward_per_step_per_agent),
                entropy=float(m.entropy), approx_kl=float(m.approx_kl),
                episodes=int(m.episodes_collected),
                elapsed=round(elapsed, 1))


def _mean(values: list) -> float:
    return sum(values) / len(values) if values else float('nan')


def _write(rows, out: str, name: str) -> str:
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, name)
    with open(path, 'w') as f:
        for r in rows:
            f.write(json.dumps(r) + '\n')
    return path


def _narrowed(num_envs: Optional[int], out: str) -> None:
    """Refuse a narrowed run into the default ``OUT``, whose curves are
    the full-width ones."""
    if num_envs and os.path.abspath(out) == os.path.abspath(OUT_DIR):
        raise ValueError(f'a run narrowed to {num_envs} envs would '
                         f'overwrite the full-width curves in {OUT_DIR}: '
                         f'give it another out')


def _summary(run: str, seed: int, count: int, num_envs: int, times: list,
             steps: float, rows: list, key: str, path: str,
             card: str) -> dict:
    """The run's width and times (host clock; the first episode or
    update, which captures the graph, apart) and its curve's first-five
    and last-five means."""
    wall = sum(times)
    rest = times[1:]
    out = dict(run=run, seed=seed, count=count, num_envs=num_envs,
               wall_s=wall,
               first_s=times[0] if times else None,
               ms_each_after_first=(1e3 * sum(rest) / len(rest)
                                    if rest else None),
               first5=_mean([r[key] for r in rows[:5]]),
               last5=_mean([r[key] for r in rows[-5:]]),
               curve=path, card=card)
    if steps:
        out['env_steps'] = steps
        out['ms_per_step'] = 1e3 * wall / steps
    print(json.dumps(out), flush=True)
    return out


def run_dqn(episodes: int = 400, seed: int = 0, out: str = OUT_DIR,
            device='cuda', num_envs: Optional[int] = None,
            every: int = DQN_EVERY) -> dict:
    _narrowed(num_envs, out)
    cfg = dqn_config(seed, out)
    if num_envs:
        cfg = dataclasses.replace(cfg, num_envs=num_envs)
    tr = DQNTrainer(cfg, device=device)
    card = card_label(tr.device)
    ts = tr.init_state()
    rows, times, steps = [], [], 0.0
    t0 = last = time.time()
    for ep, ts, m in dqn_episodes(tr, ts, episodes):
        steps += m.episode_length       # read back with the episode's end
        now = time.time()
        times.append(now - last)
        last = now
        if ep % every == 0:
            rows.append(dqn_row(ep, ts, m, now - t0))
            print('dqn', rows[-1], flush=True)
    path = _write(rows, out, f'dqn_learning_curve.seed{seed}.jsonl')
    tr.save_checkpoint(ts, 'showcase')
    return _summary('dqn', seed, episodes, cfg.num_envs, times, steps, rows,
                    'mean_reward', path, card)


def _run_ppo(run: str, cfg: PPOConfig, updates: int, out: str, device,
             every: int, save: bool) -> dict:
    tr = PPOTrainer(cfg, device=device)
    card = card_label(tr.device)
    ts = tr.init_state()
    rows, times = [], []
    t0 = last = time.time()
    for u, ts, m in ppo_updates(tr, ts, updates):
        m.mean_episode_return.item()     # the update has finished
        now = time.time()
        times.append(now - last)
        last = now
        if u % every == 0:
            rows.append(ppo_row(u, m, now - t0))
            print(run, rows[-1], flush=True)
    path = _write(rows, out, f'{run}_learning_curve.seed{cfg.seed}.jsonl')
    if save:
        tr.save_checkpoint(ts, 'showcase')
    key = 'reward_per_step' if run == 'ppo20' else 'mean_episode_return'
    steps = updates * cfg.rollout_steps * cfg.num_envs
    return _summary(run, cfg.seed, updates, cfg.num_envs, times, steps, rows,
                    key, path, card)


def run_ppo(updates: int = 150, seed: int = 0, out: str = OUT_DIR,
            device='cuda', num_envs: Optional[int] = None,
            every: int = PPO_EVERY) -> dict:
    _narrowed(num_envs, out)
    cfg = ppo_config(seed, updates)
    if num_envs:
        cfg = dataclasses.replace(cfg, num_envs=num_envs)
    return _run_ppo('ppo', cfg, updates, out, device, every, save=False)


def run_ppo20(updates: int = 400, seed: int = 0, out: str = OUT_DIR,
              device='cuda', num_envs: Optional[int] = None,
              every: int = PPO_EVERY) -> dict:
    _narrowed(num_envs, out)
    cfg = ppo20_config(seed, updates, out)
    if num_envs:
        cfg = dataclasses.replace(cfg, num_envs=num_envs)
    return _run_ppo('ppo20', cfg, updates, out, device, every, save=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('run', choices=('dqn', 'ppo', 'ppo20'))
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--episodes', type=int, default=400,
                   help='DQN episodes (dqn)')
    p.add_argument('--updates', type=int, default=None,
                   help='PPO updates (ppo: 150, ppo20: 400)')
    p.add_argument('--out', default=OUT_DIR)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    # float32 throughout, as the parity tests pin the nets (cuDNN would
    # take TF32 for the convolutions by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    common = dict(seed=args.seed, out=args.out, device=args.device)
    if args.run == 'dqn':
        return run_dqn(args.episodes, **common)
    fn = run_ppo if args.run == 'ppo' else run_ppo20
    updates = args.updates or (150 if args.run == 'ppo' else 400)
    return fn(updates, **common)


if __name__ == '__main__':
    main()
