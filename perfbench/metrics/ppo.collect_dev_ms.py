"""Milliseconds an update of ``PPOTrainer.collect`` (copy-in, the rollout
graph with GAE, the clones), between its two stamps on the device's
clock, over the traced pass (``perfbench/traced.py``); no sync."""

from perfbench import traced


def read(ctx):
    return traced.ppo_per_update_ms(ctx, 'ppo.collect.end')
