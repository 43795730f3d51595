"""The busiest held expert's load over the mean held load, in the expert
layer where that ratio is largest: the device count ``agent.held_load``
(expert layers x held experts: the router's choices of each over the
rollout) of the traced pass (``perfbench/traced_agent.py``). 1 is an even
load; the grouped products' rows and a deployment's busiest chip follow
it."""

from perfbench import traced_agent


def read(ctx):
    loads = traced_agent.counter(ctx, 'agent.held_load')
    ratios = [max(row) * len(row) / sum(row) for row in loads or ()
              if sum(row)]
    return max(ratios) if ratios else None
