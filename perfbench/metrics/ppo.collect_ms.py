"""Milliseconds an update in ``PPOTrainer.collect`` (the rollout graph and
GAE), host clock from a sync to a sync, mean over the traced window."""


def read(ctx):
    s = ctx.spans.get('ppo.collect')
    return 1e3 * sum(s) / len(s) if s else None
