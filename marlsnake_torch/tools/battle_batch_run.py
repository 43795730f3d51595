"""Record the trained 4-way battle table: the JAX package's
``tools/battle_batch_run.py`` on the port.

128 device-batched episodes of 20x20 with 4 snakes of length 3, up to 512
steps, seed 0 (``algo/battle_batch.py``):

* seat 0, ``DQN (Main)``: the trained DQN, masked, with the ``dqn_params``
  of the hybrid checkpoint (``artifacts/hybrid_neat_20x20.pkl``, bit-equal
  to the JAX run's ``artifacts/dqn20_ckpt`` ``showcase20``);
* seat 1, ``Random Bot``: the JAX table's seat 1 is the reference PPO
  checkpoint, which is not in the repository; the seat is filled as the
  CLI fills a missing PPO, with ``BatchedRandom``;
* seat 2, ``Hybrid NEAT``: the checkpoint's genome over the DQN's
  features;
* seat 3, ``Greedy Bot``.

Writes ``OUT/battle_results_20x20_batched.txt`` (default
``artifacts/torch``), whose header names the card and its power limit.

    python -m marlsnake_torch.tools.battle_batch_run
    python -m marlsnake_torch.tools.battle_batch_run --device cpu \\
        --episodes 4 --out /tmp/battle

From Python, ``record`` also takes ``max_steps`` (shorter episodes, for a
check on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from marlsnake_torch.algo.battle_batch import (BatchedGreedy, BatchedNEAT,
                                               BatchedRandom,
                                               build_battle_batch, summarize)
from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.models.dqn import make_dqn
from marlsnake_torch.models.weights import dqn_from_flax
from marlsnake_torch.utils.profiling import (card_label, device_profile,
                                             per_step)

HYBRID = os.path.join('artifacts', 'hybrid_neat_20x20.pkl')
OUT_DIR = os.path.join('artifacts', 'torch')
SEED = 0
NAMES = ['DQN (Main)', 'Random Bot', 'Hybrid NEAT', 'Greedy Bot']


def battle_config() -> EnvConfig:
    """The JAX tool's board: 20x20, 4 snakes of length 3."""
    return EnvConfig(height=20, width=20, num_snakes=4, snake_length=3)


def lineup(raw: dict, cfg: EnvConfig, device='cuda'):
    """(seat 0's DQN with the trained weights, the three opponents in
    seat order, the seats' names) from ``raw``, the hybrid checkpoint as
    ``load_hybrid_raw`` reads it."""
    dev = resolve_device(device)
    net = make_dqn(cfg, device=dev)
    net.load_state_dict(dqn_from_flax(raw['dqn_params'],
                                      (cfg.height, cfg.width)))
    net.requires_grad_(False)
    opponents = [BatchedRandom(),
                 BatchedNEAT(raw['dqn_params'], raw['neat_genome'],
                             raw['neat_config'], cfg, device=dev),
                 BatchedGreedy()]
    return net, opponents, list(NAMES)


def record(hybrid: str = HYBRID, episodes: int = 128, out: str = OUT_DIR,
           device='cuda', max_steps: int = 512,
           profile_steps: int = 0) -> dict:
    """Play the battle, write the table to ``out`` and return its summary:
    the width, loop steps (taken, and run in whole chunks), wall seconds
    and ms a step taken (host clock, after a warm-up battle that builds
    the kernels and captures the graph), the card, each seat's mean
    reward and lifetime,
    the table's path and, with ``profile_steps``, a torch.profiler window
    of a battle of that many steps at the same width (CUDA only).
    ``max_steps`` below 512 shortens the episodes (a check on the CPU);
    such a run is refused into the default ``out``."""
    if max_steps != 512 and os.path.abspath(out) == os.path.abspath(
            OUT_DIR):
        raise ValueError(f'a battle cut to {max_steps} steps would '
                         f'overwrite the table in {OUT_DIR}: give it '
                         f'another out')
    # float32 throughout, as the parity tests pin the nets (cuDNN would
    # take TF32 for the convolutions by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(device)
    card = card_label(dev)
    cfg = battle_config()
    net, opponents, names = lineup(load_hybrid_raw(hybrid), cfg, dev)

    def battle(steps):
        return build_battle_batch(net, cfg, opponents, num_envs=episodes,
                                  max_steps=steps, device=dev)

    def chunked(taken):
        k = run.chunk_steps
        return -(-taken // k) * k

    run = battle(max_steps)
    # warm-up: builds the kernels and captures the chunk's graph
    _, warm = run(seed=SEED + 1)
    t0 = time.perf_counter()
    rew, life = run(seed=SEED)
    rew, life = rew.cpu(), life.cpu()
    wall = time.perf_counter() - t0
    steps = int(life.max())
    table = summarize(rew, life, names)
    header = (
        f'{episodes} simultaneous device-batched episodes (20x20, 4 '
        f'snakes, length 3, max {max_steps} steps, seed {SEED}) '
        f'in {wall:.1f}s wall ({steps} loop steps, '
        f'{1e3 * wall / steps:.2f} ms a step after a warm-up) on '
        f'{card}.\n'
        f'marlsnake_torch: the DQN and Hybrid NEAT seats are '
        f'{os.path.basename(hybrid)}; the Random Bot replaces the '
        f'reference PPO checkpoint of the JAX table, which is not in the '
        f'repository.\n\n')
    text = header + table + '\n'
    print(text)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, 'battle_results_20x20_batched.txt')
    with open(path, 'w') as f:
        f.write(text)
    summary = dict(episodes=episodes, max_steps=max_steps, steps=steps,
                   steps_run=chunked(steps),
                   warmup_steps_run=chunked(int(warm.max())), wall_s=wall,
                   ms_per_step=1e3 * wall / steps, card=card,
                   mean_reward=rew.mean(0).tolist(),
                   mean_lifetime=life.mean(0).tolist(), table=path)
    if profile_steps:
        short = battle(profile_steps)
        summary['window'] = dict(steps=profile_steps, **per_step(
            device_profile(lambda: short(seed=SEED)), profile_steps))
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--hybrid', default=HYBRID)
    p.add_argument('--episodes', type=int, default=128)
    p.add_argument('--out', default=OUT_DIR)
    p.add_argument('--device', default='cuda')
    p.add_argument('--profile-steps', type=int, default=0,
                   help='after the battle, a torch.profiler window of a '
                        'battle of this many steps at the same width '
                        '(CUDA only)')
    args = p.parse_args(argv)
    return record(args.hybrid, args.episodes, args.out, args.device,
                  profile_steps=args.profile_steps)


if __name__ == '__main__':
    main()
