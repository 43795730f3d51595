"""Chunk steps an episode run after the DQN episode's last live step (a
chunk's no-op steps, each paying its update): the program's count
``dqn.tail_steps`` over the traced pass's episodes
(``perfbench/traced.py``)."""

from perfbench import traced


def read(ctx):
    got = traced.window(ctx)
    if not got:
        return None
    episodes = sum(s['name'] == 'dqn.episode' for s in got['spans'])
    if not episodes or 'dqn.tail_steps' not in got['counts']:
        return None
    return got['counts']['dqn.tail_steps'] / episodes
