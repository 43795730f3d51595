"""Counts of the dqn_20x20x4 configuration (``configs/dqn_20x20x4.json``):
the DQN learner's FLOPs and the env step's bytes."""

from __future__ import annotations

from perfbench.counts import formulas as f


def _env(config: dict):
    e = config['env']
    h, w, n = e['height'], e['width'], e['num_snakes']
    ring_words = -(-((h - 2) * (w - 2)) // 16)
    fruits = e['num_fruits'] if e['num_fruits'] >= 0 else round(0.8 * n)
    return h, w, n, ring_words, fruits, e['spawn_mode'] == 'pool'


def train_flops_per_env_step(config: dict, params: dict) -> float:
    """Model FLOPs a trained env-step costs: every step the acting forward
    over every agent of every env; every ``update_every`` steps one TD
    update, the online net's forward and backward over the batch and the
    target net's forward over it."""
    h, w, n, *_ = _env(config)
    t = config['train']
    envs = params['num_envs']
    fwd = f.dqn_forward(h, w, 8, config['net']['actions'])
    bwd = f.backward(fwd, f.conv3x3(8, 32, h, w))
    acting = envs * n * fwd
    update = t['batch_size'] * (2 * fwd + bwd)
    return (acting + update / params['update_every']) / envs


def k1_bytes_per_env_step(config: dict, params: dict) -> float:
    """K1's needed bytes for one env-step (``formulas.k1_bytes``)."""
    h, w, n, words, fruits, pool = _env(config)
    envs = params['num_envs']
    return f.k1_bytes(h, w, n, words, fruits, envs, pool) / envs
