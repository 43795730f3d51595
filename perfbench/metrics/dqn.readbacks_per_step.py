"""Device-to-host copies an episode step in the profiled episode."""


def read(ctx):
    p = ctx.profile
    if not p or not p['units']:
        return None
    return p['dtoh'] / (p['units'] / ctx.cell.workload['params']['num_envs'])
