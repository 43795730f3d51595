"""The rollout's needed bytes (K1's, ``counts/<config>.py``) over the
window's seconds, as a share of the chip's memory bandwidth: the step
runs no model and is bound by bytes."""


def read(ctx):
    w, peak = ctx.window, ctx.peak.get('hbm_bytes_per_s')
    if ctx.driver.work != 'rollout_env_steps' or not peak or w.seconds <= 0:
        return None
    nbytes = w.units * ctx.counts.k1_bytes_per_env_step(
        ctx.cell.config, ctx.cell.workload['params'])
    return 100.0 * nbytes / w.seconds / peak
