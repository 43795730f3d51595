"""marlsnake_torch.tools.neat_flagship and es_flagship against the JAX
repository's ``tools/neat_flagship.py`` and ``tools/es_flagship.py``, on
the CPU.

* the programs' configurations: the JAX scripts are run with their
  trainers replaced by stand-ins that record what they were given (and
  their ``open`` pointed into a temporary directory), and every argument
  is held against the port's; the ES default is JAX's canonical run, the
  config header of the committed ``artifacts/es_flagship_curve.jsonl``;
* the trained DQN: the hybrid pickle's ``dqn_params``, which the port
  reads, EQUAL to the orbax ``showcase20`` that the JAX scripts load;
* the files: a 2-generation run of each program at a tiny size writes
  rows with exactly the keys, order and types of JAX's committed rows,
  and the holdout line JAX's keys and ``seed_sem``;
* the committed curves of the card's runs (``artifacts/torch/``) at the
  levels of JAX's: the NEAT curve's median best within 2 x 18.0 (its
  standard deviation over generations) of 165.5 and its mean rising, the
  ES seed's holdout mean within 3 sqrt(2) ``seed_sem`` of 161.61.
"""

import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

from marlsnake_torch.tools import es_flagship as EF
from marlsnake_torch.tools import neat_flagship as NF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYBRID = os.path.join(REPO, NF.HYBRID)
JAX_NEAT_CURVE = os.path.join(REPO, 'artifacts', 'neat_flagship_curve.jsonl')
JAX_ES_CURVE = os.path.join(REPO, 'artifacts', 'es_flagship_curve.jsonl')
TORCH = os.path.join(REPO, 'artifacts', 'torch')


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def jax_tool(name, tmp_path):
    """The JAX script as a module, its ``open`` writing into
    ``tmp_path`` whatever path it is given."""
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.open = lambda path, mode='r': open(
        tmp_path / os.path.basename(path), mode)
    return mod


class _Stop(Exception):
    pass


def stub_jax_trainers(monkeypatch, got):
    """JAX's DQNTrainer loads nothing; its NEAT and ES trainers record
    their arguments and run as no-ops."""
    from marlsnake_tpu.algo import dqn_trainer as JD
    from marlsnake_tpu.algo import neat_hybrid as JH

    class DQNTrainer:
        def __init__(self, config):
            got['dqn_config'] = config

        def init_state(self):
            return None

        def load_checkpoint(self, name, ts):
            got['checkpoint'] = name
            return type('TS', (), {'params': 'trained'})(), None

    class Trainer:
        def __init__(self, params, **kwargs):
            got['params'], got['kwargs'] = params, kwargs
            self._seed_theta = 'seed'

        def eval_genomes(self, genomes, cfg):
            pass

        def run(self, **kwargs):
            got['run'] = kwargs
            if 'val_episodes' in kwargs:
                return 'theta', 0.0, []
            return type('G', (), {'fitness': 0.0})()

        def holdout_compare(self, a, b, episodes):
            got['holdout'] = episodes
            return 0.0, 0.0, 0.0, 1.0

    monkeypatch.setattr(JD, 'DQNTrainer', DQNTrainer)
    monkeypatch.setattr(JH, 'HybridNEATTrainer', Trainer)
    monkeypatch.setattr(JH, 'HeadESTrainer', Trainer)


def port_trainer_args(monkeypatch, module, name, run):
    """The arguments the port's program gives its trainer."""
    got = {}

    def stop(params, **kwargs):
        got['params'], got['kwargs'] = params, kwargs
        raise _Stop

    monkeypatch.setattr(module, name, stop)
    with pytest.raises(_Stop):
        run()
    return got


def test_neat_defaults_are_the_jax_script_s(monkeypatch, tmp_path):
    """The JAX script's DQN (20x20x4, length 3, ``showcase20``), its
    NEAT config, trainer arguments and generations against the port's:
    equal, the result file apart (the port's own under artifacts/torch)."""
    got = {}
    stub_jax_trainers(monkeypatch, got)
    monkeypatch.setattr(sys, 'argv', ['neat_flagship.py'])
    jax_tool('neat_flagship', tmp_path).main()
    c = got['dqn_config']
    assert (c.height, c.width, c.num_snakes, c.snake_length) == (20, 20, 4, 3)
    assert got['checkpoint'] == 'showcase20'
    want = got['kwargs']
    assert got['run']['num_generations'] == NF.DEFAULTS['generations']
    mine = port_trainer_args(monkeypatch, NF, 'HybridNEATTrainer',
                             lambda: NF.run(out=str(tmp_path),
                                            hybrid=HYBRID, device='cpu'))
    assert dataclasses.asdict(mine['kwargs'].pop('neat_cfg')) == \
        dataclasses.asdict(want.pop('neat_cfg'))
    for key in ('episode_steps', 'fitness_episodes'):
        assert mine['kwargs'][key] == want[key] == NF.DEFAULTS[key], key
    assert os.path.basename(want['result_file']) == NF.WINNER
    assert mine['kwargs']['result_file'] == os.path.join(
        str(tmp_path), 'ckpt', NF.WINNER)
    # the trainer's default env: 20x20, 4 snakes of length 5, GA reward
    assert mine['kwargs'].get('env_cfg') is None
    assert set(mine['params']['params']) == {'conv1', 'conv2', 'conv3',
                                             'fc1', 'fc2', 'fc3'}


def test_es_default_is_jax_s_canonical_run(monkeypatch, tmp_path):
    """The port's default run is the config header of JAX's committed
    curve; the JAX script run at that config writes the same header and
    gives its trainer the port's arguments."""
    header = lines(JAX_ES_CURVE)[0]
    assert header == {'config': EF.CANONICAL}
    assert list(header['config']) == list(EF.CANONICAL)
    got = {}
    stub_jax_trainers(monkeypatch, got)
    c = EF.CANONICAL
    monkeypatch.setattr(sys, 'argv', ['es_flagship.py'] + [str(c[k]) for k in (
        'generations', 'pop_size', 'sigma', 'lr', 'val_episodes')])
    monkeypatch.delenv('ES_HOLDOUT_EPISODES', raising=False)
    jax_tool('es_flagship', tmp_path).main()
    assert lines(tmp_path / 'es_flagship_curve.jsonl')[0] == header
    assert got['holdout'] == EF.HOLDOUT_EPISODES == EF.holdout_episodes()
    assert got['run']['num_generations'] == c['generations']
    assert got['run']['val_episodes'] == c['val_episodes']
    want = got['kwargs']
    mine = port_trainer_args(monkeypatch, EF, 'HeadESTrainer',
                             lambda: EF.run(out=str(tmp_path),
                                            hybrid=HYBRID, device='cpu'))
    assert dataclasses.asdict(mine['kwargs'].pop('neat_cfg')) == \
        dataclasses.asdict(want.pop('neat_cfg'))
    for key in ('episode_steps', 'pop_size', 'sigma', 'lr',
                'fitness_episodes', 'seed'):
        assert mine['kwargs'][key] == want[key], key
    monkeypatch.setenv('ES_HOLDOUT_EPISODES', '12')
    assert EF.holdout_episodes() == 12


def test_pickle_dqn_params_equal_the_orbax_showcase20():
    """The DQN the port reads (the hybrid pickle's) is the one the JAX
    scripts load (``DQNTrainer.load_checkpoint('showcase20')``)."""
    import jax
    from marlsnake_tpu.algo.dqn_trainer import DQNConfig, DQNTrainer
    tr = DQNTrainer(DQNConfig(
        height=20, width=20, num_snakes=4, snake_length=3,
        save_dir=os.path.join(REPO, 'artifacts', 'dqn20_ckpt')))
    ts, _ = tr.load_checkpoint('showcase20', tr.init_state())
    want = jax.tree_util.tree_leaves_with_path(ts.params)
    got = dict(jax.tree_util.tree_leaves_with_path(NF.load_dqn_params(
        HYBRID)))
    assert len(want) == len(got) == 12
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


def assert_like(row, model, where):
    """The same keys in the same order, each value of the same type."""
    assert list(row) == list(model), where
    for k in model:
        assert type(row[k]) is type(model[k]), (where, k)


def test_two_generation_runs_write_jax_s_rows(tmp_path):
    """Pop 4, K=1, 8-step episodes, 2 generations: NEAT's rows, ES's
    header, rows and holdout line against JAX's committed curves; the
    summaries (the last line printed) hold the run's numbers."""
    neat = NF.run(generations=2, pop_size=4, fitness_episodes=1,
                  episode_steps=8, out=str(tmp_path), hybrid=HYBRID,
                  device='cpu')
    model = lines(JAX_NEAT_CURVE)[0]
    rows = lines(tmp_path / NF.CURVE)
    assert [r['gen'] for r in rows] == [0, 1]
    for r in rows:
        assert_like(r, model, 'neat row')
    assert neat['env_steps'] == 16 and neat['mean_episode_steps'] == 8
    assert len(neat['generation_s']) == 2 and neat['card'] == 'cpu'
    assert neat['checkpoint_writes'] >= 1
    assert neat['env_steps_by_width'] == {'4': 16}
    for g in neat['generation_s']:
        assert 0.0 < g['episodes_s'] <= g['eval_s']
        assert min(g['batch_build_s'], g['reproduction_s']) > 0.0
    assert os.path.exists(tmp_path / 'ckpt' / NF.WINNER)
    w = neat['winner']
    assert (w['nodes'], w['hidden_nodes']) == (3, 0)
    assert w['max_abs_weight_delta'] >= 0.0

    es = EF.run(generations=2, pop_size=4, val_episodes=2,
                fitness_episodes=1, episode_steps=8, holdout=4,
                out=str(tmp_path), hybrid=HYBRID, device='cpu')
    jax_lines = lines(JAX_ES_CURVE)
    got = lines(tmp_path / EF.CURVE)
    assert len(got) == 1 + 2 + 1
    assert list(got[0]) == ['config']
    assert list(got[0]['config']) == list(jax_lines[0]['config'])
    for r in got[1:3]:
        assert_like(r, jax_lines[1], 'es row')
    holdout = got[-1]['holdout']
    assert list(holdout) == list(jax_lines[-1]['holdout']) + ['seed_sem']
    assert_like({k: v for k, v in holdout.items() if k != 'seed_sem'},
                jax_lines[-1]['holdout'], 'holdout')
    assert holdout['holdout_episodes'] == 4 and holdout['seed_sem'] >= 0.0
    assert es['holdout'] == holdout and len(es['generation_s']) == 2
    # fitness at 1 + 2 x 2 members, validation at 2, holdout 2 x 4
    assert set(es['env_steps_by_width']) == {'5', '2', '8'}
    assert sum(es['env_steps_by_width'].values()) == es['env_steps']
    for g in es['generation_s']:
        assert 0.0 < g['fitness_s'] + g['validation_s'] <= g['wall_s']
    assert os.path.exists(tmp_path / 'ckpt' / 'hybrid_es_20x20.pkl')


def test_narrowed_runs_are_refused_into_the_committed_curves(tmp_path):
    for run in (lambda: NF.run(generations=2, device='cpu'),
                lambda: NF.run(episode_steps=8, device='cpu'),
                lambda: EF.run(generations=2, device='cpu'),
                lambda: EF.run(holdout=8, device='cpu'),
                lambda: EF.run(curve=EF.BROAD_CURVE, device='cpu'),
                lambda: EF.run(curve='other.jsonl', device='cpu')):
        with pytest.raises(ValueError, match='would overwrite'):
            run()


def test_command_lines(monkeypatch):
    """JAX's positional counts and the flags reach ``run``; without
    ``--device`` the programs ask for CUDA."""
    got = {}
    monkeypatch.setattr(NF, 'run', lambda *a: got.setdefault('neat', a))
    monkeypatch.setattr(EF, 'run', lambda *a: got.setdefault('es', a))
    NF.main(['7', '9', '--episode-steps', '16', '--device', 'cpu'])
    assert got['neat'][:5] == (7, 9, 4, 16, NF.OUT_DIR)
    assert got['neat'][-1] == 'cpu'
    EF.main(['3', '8', '0.1', '0.01', '--curve', EF.BROAD_CURVE])
    assert got['es'][:5] == (3, 8, 0.1, 0.01, 32)
    assert got['es'][-3:] == (EF.BROAD_CURVE, NF.HYBRID, 'cuda')


def test_programs_run_on_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid here')
    for main in (NF.main, EF.main):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            main(['--out', str(tmp_path), '--hybrid', HYBRID])


def test_programs_import_no_jax():
    code = ('import marlsnake_torch.tools.neat_flagship, '
            'marlsnake_torch.tools.es_flagship, '
            'marlsnake_torch.bench_table; '
            'import sys; bad = [m for m in sys.modules if m.split(".")[0] '
            'in ("jax", "jaxlib", "flax", "optax", "orbax", "marlsnake_tpu")]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)


def test_committed_neat_curve_meets_jax_s_levels():
    """50 rows of pop 100 from the card with JAX's keys; the median best
    within 2 x 18.0 of JAX's 165.5; the mean of the last five generations
    above the first five's."""
    rows = lines(os.path.join(TORCH, NF.CURVE))
    model = lines(JAX_NEAT_CURVE)[0]
    assert [r['gen'] for r in rows] == list(range(50))
    for r in rows:
        assert_like(r, model, 'committed row')
    median = statistics.median(r['best'] for r in rows)
    assert abs(median - 165.5) <= 2 * 18.0, median
    means = [r['mean'] for r in rows]
    assert np.mean(means[-5:]) > np.mean(means[:5])


def test_committed_es_curve_meets_jax_s_levels():
    """JAX's canonical header, 100 generation rows and a holdout of 256
    episodes; the seed's holdout mean within 3 sqrt(2) seed_sem of
    JAX's 161.61."""
    got = lines(os.path.join(TORCH, EF.CURVE))
    assert got[0] == {'config': EF.CANONICAL}
    assert [r['gen'] for r in got[1:-1]] == list(range(100))
    h = got[-1]['holdout']
    assert h['holdout_episodes'] == 256
    assert abs(h['seed_mean'] - 161.61) <= 3 * 2 ** 0.5 * h['seed_sem']
    assert isinstance(h['champion_beats_seed'], bool)
