"""The share of the router's choices in the rollout that land on the
experts this chip holds: the device counts ``agent.held`` over
``agent.routed`` of the traced pass (``perfbench/traced_agent.py``);
nominal 16 of 64 experts, 25%."""

from perfbench import traced_agent


def read(ctx):
    held = traced_agent.counter(ctx, 'agent.held')
    routed = traced_agent.counter(ctx, 'agent.routed')
    if not routed:
        return None
    return 100.0 * held / routed
