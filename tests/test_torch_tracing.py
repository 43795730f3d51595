"""The program's tracer (``utils/profiling.Tracer``) on the CPU: spans and
their ids, parents and self times; nothing recorded and no stamp placed
while it is off; a captured loop's graphs with and without marks, and its
stamps refused by a ring on another device; the DQN episode's and the PPO
update's phases, with results bit-identical on and off; the phases' track
in a profiler's trace."""

import collections
import json
import time

import pytest
import torch

from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
from marlsnake_torch.ops import stamp
from marlsnake_torch.utils import cuda_graph, profiling
from marlsnake_torch.utils.profiling import tracer
from test_torch_dqn_trainer import SMALL

PPO_SMALL = dict(height=8, width=8, num_snakes=2, snake_length=2,
                 num_envs=4, rollout_steps=8, num_minibatches=2,
                 update_epochs=2)
DQN_PHASES = ('dqn.act', 'dqn.env', 'dqn.td_grad', 'dqn.optim')


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    tracer.disable()
    tracer.flush()
    yield
    tracer.disable()
    tracer.flush()


def _names(got) -> collections.Counter:
    return collections.Counter(s['name'] for s in got['stamps'])


def _phases(got) -> list:
    """The name of each phase of a flush: that of the stamp ending it."""
    return [s['name'] for s in got['stamps'][1:]]


def _counting_stamps(monkeypatch) -> list:
    """The tracer's stamps, each also listed in the returned list and
    counted as a launch of the stamp kernel, as on the card."""
    placed = []

    def counted(slots, i):
        placed.append(i)
        slots[i] = time.perf_counter_ns()
        stamp.stamp.launches += 1
    monkeypatch.setattr(profiling, 'stamp', counted)
    return placed


def test_spans_nest_with_parents_ids_and_self_times():
    tracer.enable('cpu')
    with tracer.span('a'):
        with tracer.span('b'):
            time.sleep(0.002)
            tracer.mark('b.phase')
        with tracer.span('c', device=True):
            time.sleep(0.001)
    with tracer.span('d'):
        tracer.count('n', 2)
        tracer.count('n', 3)
    got = tracer.flush()
    spans = got['spans']
    assert [(s['name'], s['id'], s['parent']) for s in spans] == [
        ('a', 1, None), ('b', 1, 0), ('c', 1, 0), ('d', 2, None)]
    a, b, c, d = spans
    for s in spans:
        assert s['end_ns'] > s['start_ns']
    assert b['self_ns'] == b['end_ns'] - b['start_ns']
    assert a['self_ns'] == (a['end_ns'] - a['start_ns']
                            - (b['end_ns'] - b['start_ns'])
                            - (c['end_ns'] - c['start_ns']))
    assert b['self_ns'] >= 2_000_000 and a['self_ns'] < b['self_ns']
    # the stamps in order, each with the id of the span it was placed in
    assert [(s['name'], s['id']) for s in got['stamps']] == [
        ('b.phase', 1), ('c.start', 1), ('c.end', 1)]
    times = [s['t_ns'] for s in got['stamps']]
    assert times == sorted(times) and times[2] - times[1] >= 1_000_000
    assert _phases(got) == ['c.start', 'c.end']
    assert got['counts'] == {'n': 5} and got['clock'] == 'perf_counter'
    # a flush forgets what it returned
    empty = tracer.flush()
    assert empty['spans'] == [] and empty['stamps'] == []
    assert empty['counts'] == {}


def test_the_tracer_off_records_nothing_and_places_no_stamp(monkeypatch):
    placed = _counting_stamps(monkeypatch)
    stamp.stamp.launches = 0
    tr = DQNTrainer(DQNConfig(**SMALL), device='cpu')
    ts, _ = tr.train_episode(tr.init_state())
    ppo = PPOTrainer(PPOConfig(**PPO_SMALL), device='cpu')
    ppo.update(ppo.init_state())
    with tracer.span('x', device=True):
        tracer.mark('y')
        tracer.count('z')
    assert tracer.span('x') is profiling._NULL
    got = tracer.flush()
    assert got['spans'] == [] and got['stamps'] == [] and got['counts'] == {}
    assert placed == [] and stamp.stamp.launches == 0


class _Graph:
    """A captured graph as far as the loop sees it: replays count; the
    body's Python does not run."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_capture(monkeypatch):
    """CapturedLoop's CUDA steps replaced on the CPU: the warm-up runs the
    body, a capture runs it once more (marks going where a capture sends
    them), the loop's slots live on the CPU, a stamp counts as a launch
    of its kernel. Returns the list of graphs captured."""
    graphs = []
    _counting_stamps(monkeypatch)

    def record(self):
        self.body()
        graphs.append(_Graph())
        return graphs[-1], 0.0, 0
    monkeypatch.setattr(cuda_graph.CapturedLoop, '_warm_up',
                        lambda self: self.body())
    monkeypatch.setattr(cuda_graph.CapturedLoop, '_record', record)
    monkeypatch.setattr(cuda_graph, 'LoopSlots',
                        lambda device: profiling.LoopSlots('cpu'))
    return graphs


@pytest.mark.parametrize('first_on', [False, True])
def test_a_body_without_marks_is_captured_once(monkeypatch, first_on):
    graphs = _fake_capture(monkeypatch)
    runs = []
    loop = cuda_graph.CapturedLoop(lambda: runs.append(1), 'cuda')
    for on in (first_on, not first_on, first_on, not first_on):
        tracer.enable('cpu') if on else tracer.disable()
        loop()
    assert len(graphs) == 1 and loop.marks == 0
    assert loop.graph is graphs[0] and loop.traced_graph is None
    assert graphs[0].replays == 3
    assert tracer.flush()['stamps'] == []


@pytest.mark.parametrize('first_on', [False, True])
def test_a_body_with_marks_has_a_traced_graph(monkeypatch, first_on):
    """Off, the untraced graph replays and its probe counted the marks;
    on, the traced graph replays and each replay copies its slots into
    the ring under the names the capture saw; each graph is captured
    once."""
    graphs = _fake_capture(monkeypatch)
    loop = cuda_graph.CapturedLoop(
        lambda: (tracer.mark('p'), tracer.mark('q')), 'cuda')
    stamp.stamp.launches = 0
    order = [first_on, not first_on] * 3
    for on in order:
        tracer.enable('cpu') if on else tracer.disable()
        with tracer.span('call'):
            loop()
    assert len(graphs) == 2 and loop.marks == 2
    traced, plain = ((graphs[0], graphs[1]) if first_on
                     else (graphs[1], graphs[0]))
    assert loop.traced_graph is traced and loop.graph is plain
    assert traced.replays == 2 and plain.replays == 2
    got = tracer.flush()
    # the traced warm-up's marks go straight to the ring; each traced
    # replay's two slots follow, tagged with the span it ran in
    assert [s['name'] for s in got['stamps']] == ['p', 'q'] * 3
    ids = [s['id'] for s in got['stamps']]
    assert ids[0::2] == ids[1::2] and len(set(ids)) == 3
    assert loop.traced_tally.by_name() == {'stamp': 2}
    # the traced warm-up's two, two a traced replay; the capture's two
    # went into the traced graph's tally
    assert stamp.stamp.launches == 2 + 2 * 2


@pytest.mark.parametrize('where', ['capture', 'replay'])
def test_the_ring_refuses_stamps_of_another_device(where):
    """A ring on the CPU takes no slots of another device, at a traced
    capture or after a replay: their copy would wait for that device and
    their clock is not the ring's."""
    tracer.enable('cpu')
    elsewhere = profiling.LoopSlots('meta')
    with pytest.raises(ValueError, match='enable the tracer'):
        if where == 'capture':
            with tracer.capturing(elsewhere):
                pass
        else:
            tracer.replayed(elsewhere.slots[:2], ['a', 'b'])
    assert tracer.flush()['stamps'] == []


def _same_dqn_runs(**kwargs):
    """Two episodes of SMALL's trainer from one seed, the tracer off, then
    on: (states, metrics, flushes) of each."""
    out = []
    for on in (False, True):
        tracer.enable('cpu') if on else tracer.disable()
        tr = DQNTrainer(DQNConfig(**dict(SMALL, **kwargs)), device='cpu')
        ts, runs = tr.init_state(), []
        for _ in range(2):
            ts, m = tr.train_episode(ts)
            runs.append((ts, m, tracer.flush()))
        out.append(runs)
    return out


def test_dqn_episode_is_bit_identical_with_the_tracer_on_and_off():
    off, on = _same_dqn_runs()
    for (a, ma, _), (b, mb, got) in zip(off, on):
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.count, b.opt_state.count)
        for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                        b.opt_state.mu + b.opt_state.nu):
            assert torch.equal(x, y)
        for name, t in a.buffer.fields():
            assert torch.equal(t, getattr(b.buffer, name)), name
        assert torch.equal(a.epsilon, b.epsilon)
        assert torch.equal(ma.mean_reward, mb.mean_reward)
        assert torch.equal(ma.mean_loss, mb.mean_loss)
        assert (ma.episode_length, ma.updates) == (mb.episode_length,
                                                  mb.updates)
        assert got['stamps']


@pytest.mark.parametrize('mode', [{}, {'fused_act_update': True},
                                  {'update_every': 2}],
                         ids=['per_step', 'fused', 'every_2'])
def test_dqn_records_each_phase_a_step_and_its_tail_steps(mode):
    _, on = _same_dqn_runs(**mode)
    k = cuda_graph.chunk_steps(SMALL['max_steps_per_episode'],
                               mode.get('update_every', 1))
    for _, m, got in on:
        names = _names(got)
        chunks = names['dqn.chunk.start']
        assert chunks == names['dqn.chunk.end'] == -(
            -int(m.episode_length) // k)
        run = chunks * k
        updating = run // mode.get('update_every', 1)
        assert [names[p] for p in DQN_PHASES] == [run, run, updating,
                                                  updating]
        assert got['counts'] == {'dqn.tail_steps':
                                 run - int(m.episode_length)}
        assert names['dqn.prologue.start'] == names['dqn.epilogue.end'] == 1
        spans = got['spans']
        assert spans[0]['name'] == 'dqn.episode'
        inner = collections.Counter(s['name'] for s in spans[1:]
                                    if s['parent'] == 0)
        assert inner == {'dqn.prologue': 1, 'dqn.epilogue': 1,
                         'dqn.replay': chunks, 'dqn.readback': chunks}
        assert len({s['id'] for s in spans}) == 1
        # every phase between the prologue's start and the epilogue's
        # end lies inside the episode's one id, in device order
        first, *rest = _phases(got)
        assert first == 'dqn.prologue.end' and rest[-1] == 'dqn.epilogue.end'


def test_ppo_update_is_bit_identical_with_three_marks_a_minibatch():
    runs = []
    for on in (False, True):
        tracer.enable('cpu') if on else tracer.disable()
        tr = PPOTrainer(PPOConfig(**PPO_SMALL), device='cpu')
        ts = tr.init_state()
        ts, m = tr.update(ts)
        runs.append((ts, m, tracer.flush()))
    (a, ma, _), (b, mb, got) = runs
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    for f in ('loss_actor', 'loss_value', 'entropy', 'approx_kl',
              'mean_reward_per_step_per_agent', 'mean_episode_return'):
        assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    minibatches = PPO_SMALL['update_epochs'] * PPO_SMALL['num_minibatches']
    order = [s['name'] for s in got['stamps']]
    assert order == (['ppo.collect.start', 'ppo.collect.end',
                      'ppo.learn.start']
                     + ['ppo.gather', 'ppo.fwd_bwd', 'ppo.optim']
                     * minibatches + ['ppo.learn.end'])
    assert [(s['name'], s['parent']) for s in got['spans']] == [
        ('ppo.update', None), ('ppo.collect', 0), ('ppo.learn', 0)]


def test_trace_writes_the_phases_as_a_track_on_the_profilers_clock(
        tmp_path):
    """On the CPU: the records go to ``marlsnake_trace.json`` and the
    profiler's trace holds the episode's range, but no track, since no
    stamp launched a kernel there to place it by."""
    tracer.enable('cpu')
    tr = DQNTrainer(DQNConfig(**SMALL), device='cpu')
    ts = tr.init_state()
    with profiling.trace(str(tmp_path)):
        tr.train_episode(ts)
    doc = json.load(open(tmp_path / 'trace.json'))
    got = json.load(open(tmp_path / 'marlsnake_trace.json'))
    assert _names(got)['dqn.act'] > 0
    ranges = [e for e in doc['traceEvents']
              if e.get('name') == 'marlsnake:dqn.episode']
    assert len(ranges) == 1
    assert not [e for e in doc['traceEvents']
                if e.get('pid') == 'marlsnake phases']
    assert tracer.flush()['stamps'] == []


def test_the_track_is_placed_by_the_stamps_own_kernels(tmp_path):
    """A flush whose first stamp came before the profile: the trace's
    three stamp kernels are its last three stamps, and each phase runs
    from kernel to kernel, whatever the stamps' own clock reads."""
    path = tmp_path / 'trace.json'
    kernel = {'ph': 'X', 'cat': 'kernel', 'name': 'stamp_kernel(unsigned '
              'long*)', 'pid': 0, 'tid': 7, 'dur': 1.5}
    other = {'ph': 'X', 'cat': 'kernel', 'name': 'sgemm', 'pid': 0,
             'tid': 7, 'ts': 101.0, 'dur': 30.0}
    doc = {'traceEvents': [dict(kernel, ts=140.0), other,
                           dict(kernel, ts=100.0), dict(kernel, ts=175.5)]}
    json.dump(doc, open(path, 'w'))
    got = {'stamps': [{'name': n, 'id': i, 't_ns': t} for n, i, t in (
        ('a', 1, 5_000_000), ('b', 1, 9_000_000_000),
        ('c', 1, 9_000_040_000), ('d', 2, 9_000_075_200))]}
    profiling.add_phase_track(str(path), got)
    track = [e for e in json.load(open(path))['traceEvents']
             if e.get('pid') == 'marlsnake phases' and e['ph'] == 'X']
    assert [(e['name'], e['ts'], e['dur'], e['args']) for e in track] == [
        ('c', 100.0, 40.0, {'id': 1, 'stamp_ns': 40_000}),
        ('d', 140.0, 35.5, {'id': 2, 'stamp_ns': 35_200})]
