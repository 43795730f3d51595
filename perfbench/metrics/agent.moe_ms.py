"""Milliseconds an update of the agent's expert layers' feed-forward: the
phases ended by the mark ``agent.moe`` (router, dispatch, the held
experts' grouped products, the shared experts) in the rollout graph's
forwards, summed, on the device's clock, over the traced pass
(``perfbench/traced_agent.py``)."""

from perfbench import traced_agent


def read(ctx):
    return traced_agent.per_update_ms(ctx, 'agent.moe')
