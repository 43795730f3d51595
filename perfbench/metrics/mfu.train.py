"""The training step's model FLOPs (``counts/<config>.py``) over the
window's seconds, as a share of the chip's float32 peak."""


def read(ctx):
    w, peak = ctx.window, ctx.peak.get('fp32_flops_per_s')
    if ctx.driver.work != 'train_env_steps' or not peak or w.seconds <= 0:
        return None
    flops = w.units * ctx.counts.train_flops_per_env_step(
        ctx.cell.config, ctx.cell.workload['params'])
    return 100.0 * flops / w.seconds / peak
