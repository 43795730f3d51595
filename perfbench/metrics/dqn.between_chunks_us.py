"""Microseconds from one chunk's end stamp to the next chunk's start stamp
inside a DQN episode (the flag's read-back and the next replay's launch),
mean over the traced pass's gaps (``perfbench/traced.py``)."""

from perfbench import traced


def read(ctx):
    gaps = traced.durations(traced.window(ctx), 'dqn.chunk.start',
                            after='dqn.chunk.end')
    return 1e-3 * sum(gaps) / len(gaps) if gaps else None
