"""Trained env-steps over the window's seconds, all calls and all time."""


def read(ctx):
    w = ctx.window
    if ctx.driver.work != 'train_env_steps' or w.seconds <= 0:
        return None
    return w.units / w.seconds
