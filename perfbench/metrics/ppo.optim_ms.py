"""Milliseconds an update of the PPO minibatches' ``ppo.optim`` phases,
summed, on the device's clock, over the traced pass
(``perfbench/traced.py``)."""

from perfbench import traced


def read(ctx):
    return traced.ppo_per_update_ms(ctx, 'ppo.optim')
