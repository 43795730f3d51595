"""The agent's training model FLOPs (``counts/<config>.py``) over the
window's seconds, as a share of the card's dense bfloat16 peak (the
configuration's precision); None on a card whose peak is not listed."""

import torch

# NVIDIA H100 data sheet, SXM part, dense (no sparsity), at the 700 W limit
BF16_PEAK = {'NVIDIA H100 80GB HBM3': 989.4e12}


def read(ctx):
    w = ctx.window
    dev = ctx.driver.device
    if ctx.driver.work != 'train_env_steps' or w.seconds <= 0 \
            or dev.type != 'cuda':
        return None
    peak = BF16_PEAK.get(torch.cuda.get_device_name(dev))
    if peak is None:
        return None
    flops = w.units * ctx.counts.train_flops_per_env_step(
        ctx.cell.config, ctx.cell.workload['params'])
    return 100.0 * flops / w.seconds / peak
