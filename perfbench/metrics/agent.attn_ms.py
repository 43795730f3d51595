"""Milliseconds an update of the agent's attention: the phases ended by
the mark ``agent.attn`` (each layer's attention, from the mark before it)
in the rollout graph's forwards, summed, on the device's clock, over the
traced pass (``perfbench/traced_agent.py``)."""

from perfbench import traced_agent


def read(ctx):
    return traced_agent.per_update_ms(ctx, 'agent.attn')
