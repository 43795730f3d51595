"""Milliseconds a PPO update (its rollout and its minibatch epochs): the
window's seconds over the updates it completed, all calls and all time.
None for a cell whose traffic has no rollout of ``rollout_steps``."""


def read(ctx):
    p, w = ctx.cell.workload['params'], ctx.window
    if 'rollout_steps' not in p or w.units <= 0:
        return None
    return 1e3 * w.seconds * p['num_envs'] * p['rollout_steps'] / w.units
