"""Milliseconds a DQN episode spends outside its chunks and the gaps
between them, on the device's clock: from the prologue's start stamp to
the first chunk's (draws, reset, copy-in, the first launch) and from the
last chunk's end stamp to the epilogue's end (the last read-back, the
metrics, the clones, ``_end_episode``); mean over the traced pass's
episodes (``perfbench/traced.py``)."""

from perfbench import traced


def read(ctx):
    got = traced.window(ctx)
    episodes = traced.count(got, 'dqn.prologue.end')
    if not episodes:
        return None
    ns = sum(sum(traced.durations(got, name, after)) for name, after in (
        ('dqn.prologue.end', None),
        ('dqn.chunk.start', 'dqn.prologue.end'),
        ('dqn.epilogue.start', 'dqn.chunk.end'),
        ('dqn.epilogue.end', None)))
    return 1e-6 * ns / episodes
