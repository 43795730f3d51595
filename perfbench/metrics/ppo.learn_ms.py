"""Milliseconds an update in ``PPOTrainer.learn`` (the minibatch epochs),
host clock from a sync to a sync, mean over the traced window."""


def read(ctx):
    s = ctx.spans.get('ppo.learn')
    return 1e3 * sum(s) / len(s) if s else None
