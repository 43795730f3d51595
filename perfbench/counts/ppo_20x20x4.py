"""Counts of the ppo_20x20x4 configuration (``configs/ppo_20x20x4.json``):
the PPO learner's FLOPs."""

from __future__ import annotations

from perfbench.counts import formulas as f


def train_flops_per_env_step(config: dict, params: dict) -> float:
    """Model FLOPs a trained env-step costs: an update's rollout (a forward
    of every agent every step, and one more for the bootstrap value)
    and its epochs (a forward and a backward of every sample each epoch),
    over the update's env-steps."""
    e, t = config['env'], config['train']
    h, w, n = e['height'], e['width'], e['num_snakes']
    envs, steps = params['num_envs'], params['rollout_steps']
    fwd = f.actor_critic_forward(h, w, 8, config['net']['actions'])
    bwd = f.backward(fwd, f.conv3x3(8, 32, h, w))
    samples = steps * envs * n
    rollout = (steps + 1) * envs * n * fwd
    epochs = params['update_epochs'] * samples * (fwd + bwd)
    return (rollout + epochs) / (steps * envs)
