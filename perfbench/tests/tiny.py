"""Cells at a size the CPU runs in a second: an 8x8 board with two snakes
of length 5, four envs, a small batch and ring, short rollouts."""

from __future__ import annotations

import copy
import os

from perfbench import harness

TINY_ENV = dict(height=8, width=8, num_snakes=2, snake_length=5)
TINY_TRAIN = dict(batch_size=16, buffer_size=40, min_buffer_size=12,
                  max_steps_per_episode=32)
TINY_PARAMS = dict(num_envs=4, rollout_steps=8, steps=8)
SEED = 2 ** 31 + 12345


def cell(name: str) -> harness.Cell:
    """The cell ``name`` (its workload file; its BENCHMARK.json entry
    where it has one) cut to the tiny size."""
    workload = copy.deepcopy(harness.load_json(os.path.join(
        harness.HERE, 'workloads', f'{name}.json')))
    config = copy.deepcopy(harness.load_json(os.path.join(
        harness.HERE, 'configs', f'{workload["config"]}.json')))
    config['env'].update(TINY_ENV)
    if 'batch_size' in config['train']:
        config['train'].update(TINY_TRAIN)
    workload['params'].update({k: v for k, v in TINY_PARAMS.items()
                               if k in workload['params']})
    bench = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
    entry = next((w for w in bench['workloads'] if w['name'] == name),
                 {'name': name, 'config': workload['config'],
                  'traffic': workload['traffic'], 'chips': 1})
    return harness.Cell(name, entry, workload, config, bench)


def driver(c: harness.Cell, seed: int = SEED, device='cpu'):
    return harness.load_module('drivers', c.workload['driver']).Driver(
        c.config, c.workload['params'], seed, device)


def run(c: harness.Cell, seconds: float = 0.3, seed: int = SEED,
        device='cpu'):
    """Set-up, a short window, release; the driver, ready to check."""
    import torch
    harness.set_precision(c.config)
    d = driver(c, seed, device)
    d.setup()
    harness.run_window(d, seconds, torch.device(device))
    d.release()
    return d


def over(c: harness.Cell, numbers: dict) -> dict:
    """The numbers over their limits, or not finite."""
    return {k: v for k, v in c.checks(numbers).items()
            if harness.over_limit(v['value'], v['limit'])}


CELLS = ('dqn_20x20x4.train-256', 'ppo_20x20x4.train-256',
         'dqn_20x20x4.rollout-4096')

