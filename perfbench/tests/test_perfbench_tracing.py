"""The readers of the program's phases (``perfbench/traced.py``): None
where the program gives no trace, the right means on a synthetic one,
every one reported by a traced run at the tiny size; and, on the card,
set-up's results byte-equal with the program's tracer on and off."""

import sys

import pytest
import torch

from perfbench import harness, traced
from perfbench.tests import tiny

DQN = ('dqn.act_us', 'dqn.env_us', 'dqn.td_grad_us', 'dqn.optim_us',
       'dqn.between_chunks_us', 'dqn.episode_edges_ms', 'dqn.tail_steps')
PPO = ('ppo.collect_dev_ms', 'ppo.gather_ms', 'ppo.fwd_bwd_ms',
       'ppo.optim_ms')
US = 1000   # ns


def _context(got):
    ctx = harness.Context(tiny.cell(tiny.CELLS[0]), object(), 0.0,
                          harness.Window(), None, None, {}, 'cpu')
    ctx.program_trace = got
    return ctx


def _read(name, got):
    return harness.load_module('metrics', name).read(_context(got))


class _Clock:
    """Stamps of a synthetic flush, each ``dt`` us after the one before."""

    def __init__(self):
        self.t, self.stamps = 0, []

    def __call__(self, name, dt, sid=1):
        self.t += dt * US
        self.stamps.append({'name': name, 'id': sid, 't_ns': self.t})


def _dqn_trace(episodes=2, chunks=3, k=8, every=1):
    """``episodes`` episodes of ``chunks`` chunks of ``k`` steps: act 10
    us, env 2, and on every ``every``-th step TD gradient 20, optimizer
    3; stores 1; 30 between chunks; prologue 100 and 50 to the first
    chunk; 40 to the epilogue, 60 in it; 500 between episodes."""
    stamp = _Clock()
    for e in range(1, episodes + 1):
        stamp('dqn.prologue.start', 500, e)
        stamp('dqn.prologue.end', 100, e)
        for c in range(chunks):
            stamp('dqn.chunk.start', 50 if c == 0 else 30, e)
            for i in range(k):
                stamp('dqn.act', 10, e)
                stamp('dqn.env', 2, e)
                if (i + 1) % every == 0:
                    stamp('dqn.td_grad', 20, e)
                    stamp('dqn.optim', 3, e)
            stamp('dqn.chunk.end', 1, e)
        stamp('dqn.epilogue.start', 40, e)
        stamp('dqn.epilogue.end', 60, e)
    spans = [{'name': 'dqn.episode', 'id': e, 'parent': None}
             for e in range(1, episodes + 1)]
    return {'stamps': stamp.stamps, 'spans': spans,
            'counts': {'dqn.tail_steps': 7}}


def _ppo_trace(updates=2, minibatches=16):
    stamp = _Clock()
    for u in range(updates):
        stamp('ppo.collect.start', 900, 2 * u + 1)
        stamp('ppo.collect.end', 70_000, 2 * u + 1)
        stamp('ppo.learn.start', 100, 2 * u + 2)
        for _ in range(minibatches):
            for name, dt in (('ppo.gather', 2_000), ('ppo.fwd_bwd', 40_000),
                             ('ppo.optim', 1_000)):
                stamp(name, dt, 2 * u + 2)
        stamp('ppo.learn.end', 500, 2 * u + 2)
    return {'stamps': stamp.stamps, 'spans': [], 'counts': {}}


@pytest.mark.parametrize('name', DQN + PPO)
def test_reader_reads_nothing_without_the_programs_trace(name):
    assert _read(name, None) is None
    assert _read(name, {'stamps': [], 'spans': [], 'counts': {}}) is None


@pytest.mark.parametrize('name,want', [
    ('dqn.act_us', 10.0), ('dqn.env_us', 2.0), ('dqn.td_grad_us', 20.0),
    ('dqn.optim_us', 3.0), ('dqn.between_chunks_us', 30.0),
    ('dqn.episode_edges_ms', 0.25), ('dqn.tail_steps', 3.5)])
def test_dqn_reader_means(name, want):
    assert _read(name, _dqn_trace()) == pytest.approx(want)
    # the other cell's trace gives a DQN reader nothing
    assert _read(name, _ppo_trace()) is None


@pytest.mark.parametrize('name,want', [
    ('ppo.collect_dev_ms', 70.0), ('ppo.gather_ms', 32.0),
    ('ppo.fwd_bwd_ms', 640.0), ('ppo.optim_ms', 16.0)])
def test_ppo_reader_means(name, want):
    assert _read(name, _ppo_trace()) == pytest.approx(want)
    assert _read(name, _dqn_trace()) is None


def test_a_dqn_step_without_an_update_still_counts_as_a_step():
    """With updates every other step, the TD phases are shared out over
    every step run."""
    got = _dqn_trace(every=2)
    assert _read('dqn.act_us', got) == pytest.approx(10.0)
    assert _read('dqn.td_grad_us', got) == pytest.approx(10.0)
    assert _read('dqn.optim_us', got) == pytest.approx(1.5)


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, 'marlsnake_torch.utils.profiling',
                        None)
    ctx = harness.Context(tiny.cell(tiny.CELLS[0]), object(), 0.0,
                          harness.Window(), None, None, {}, 'cpu')
    assert traced.window(ctx) is None
    assert harness.load_module('metrics', 'dqn.act_us').read(ctx) is None


@pytest.mark.parametrize('name', tiny.CELLS[:2])
def test_a_traced_run_reports_the_programs_phases(name):
    """A ``--trace 1`` run of the cell at the tiny size, on the CPU: its
    line holds every new metric (the tiny DQN's episodes may end inside
    their first chunk, and leave no gap between chunks), and it is
    correct; the tracer is off again."""
    import time
    from marlsnake_torch.utils.profiling import tracer
    c = tiny.cell(name)
    result = harness.run_cell(c, tiny.SEED, 0.3, True, 'cpu',
                              time.perf_counter())
    assert result['correct']
    want = set(DQN) - {'dqn.between_chunks_us'} if 'dqn' in name \
        else set(PPO)
    assert want <= set(result['metrics'])
    assert not tracer.on


# --- on the card --------------------------------------------------------------

def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


@pytest.mark.card
@pytest.mark.parametrize('name', tiny.CELLS[:2])
def test_setup_is_byte_equal_with_the_tracer_on_and_off(name):
    """The cell at its own size and a driver's seed: set-up (DQN: its three
    episodes, the chunk graph's capture among them; PPO: its first
    update) with the program's tracer off, on, off again, cuDNN
    deterministic; what the check reads (metrics, Adam's state, the
    parameters, the ring; PPO's loss terms, advantages, first moment and
    parameters) is byte-equal in the three."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the stamps and graphs exist only '
                    'there')
    from marlsnake_torch.utils.profiling import tracer
    c = harness.Cell.find(name)
    harness.set_precision(c.config)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for on in (False, True, False):
            if on:
                tracer.enable('cuda')
            d = tiny.driver(c, device='cuda')
            d.setup()
            got = tracer.flush()
            tracer.disable()
            d.release()
            runs.append((d.program, got))
            del d
    finally:
        torch.backends.cudnn.deterministic = deterministic
        tracer.disable()
    (off, _), (on, got), (again, _) = runs
    assert _equal(off, again)
    assert _equal(off, on)
    assert got['stamps']
