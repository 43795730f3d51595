"""K1's needed bytes over its device time in the profiled calls, as a
share of the chip's memory bandwidth."""

KERNEL = 'step_autoreset_kernel'


def read(ctx):
    p, peak = ctx.profile, ctx.peak.get('hbm_bytes_per_s')
    if not p or not peak:
        return None
    names = [k for k in p['ops'] if KERNEL in k]
    launches = sum(p['op_counts'][k] for k in names)
    seconds = sum(p['ops'][k] for k in names)
    if not launches or seconds <= 0:
        return None
    params = ctx.cell.workload['params']
    nbytes = launches * params['num_envs'] * ctx.counts.k1_bytes_per_env_step(
        ctx.cell.config, params)
    return 100.0 * nbytes / seconds / peak
