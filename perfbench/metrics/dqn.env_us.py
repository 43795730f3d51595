"""Microseconds an episode step of the DQN chunk's ``dqn.env`` phase,
on the device's clock, over the traced pass (``perfbench/traced.py``)."""

from perfbench import traced


def read(ctx):
    return traced.dqn_per_step_us(ctx, 'dqn.env')
