"""marlsnake_torch.examples.train_showcase against the JAX package's
``examples/train_showcase.py`` and its trainers, on the CPU.

The programs take JAX's draws (derived from its key schedule, as the
trainers' own tests derive them) and are held against JAX's chains of
episodes and updates. Tolerances, each where it is used:

* the configs: every field the JAX script sets EQUAL;
* the DQN carried over 6 episodes: epsilon, the episode count, the target
  sync schedule, the ring (count, pointer and rows), the Adam count, the
  update count, the episode length and the mean reward EQUAL; the mean
  loss within 1e-4 relative and the parameters (online and target)
  within 1e-3 absolute, those of ``test_episode_matches_jax``;
* PPO carried over 4 updates: the rollouts (obs, actions, rewards, done
  flags), the env states, the episode counters and the Adam count EQUAL;
  the losses and episode metrics within 1e-4 relative (1e-6 absolute for
  the losses near 0 by construction) and the parameters and moments
  within 1e-3 absolute, those of ``test_two_updates_match_jax``;
* the rows: exactly the keys, in order, and the types of JAX's committed
  rows.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
from marlsnake_torch.algo.flax_states import (ppo_train_state_from_flax,
                                              train_state_from_flax)
from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
from marlsnake_torch.examples import train_showcase as S
from test_torch_dqn_trainer import SMALL
from test_torch_dqn_trainer import assert_params_close as dqn_params_close
from test_torch_dqn_trainer import episode_draws
from test_torch_dqn_trainer import numpy_state as dqn_numpy_state
from test_torch_dqn_trainer import trainers as dqn_trainers
from test_torch_engine import assert_fields_equal
from test_torch_ppo import LOSSES, EPISODE
from test_torch_ppo import assert_params_close as ppo_params_close
from test_torch_ppo import numpy_state as ppo_numpy_state
from test_torch_ppo import replay_jax_rollout
from test_torch_replay import assert_rings_equal

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (as test_torch_neat.py): small-op
    episodes spin slower on many threads beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_showcase():
    spec = importlib.util.spec_from_file_location(
        'jax_train_showcase',
        os.path.join(REPO, 'examples', 'train_showcase.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Built(Exception):
    pass


@pytest.mark.parametrize('run', ['dqn', 'ppo', 'ppo20'])
def test_configs_are_the_jax_script_s_field_for_field(run, monkeypatch):
    """The JAX script's run_* builds its trainer from a config: stop it
    there and hold every field against the port's (the checkpoint
    directory of the runs that save one apart, which is the port's own
    under artifacts/torch)."""
    from marlsnake_tpu.algo import dqn_trainer as JD
    from marlsnake_tpu.algo import ppo_trainer as JP
    got = {}

    def stop(config, *args, **kwargs):
        got['config'] = config
        raise _Built

    module = JD if run == 'dqn' else JP
    monkeypatch.setattr(module, 'DQNTrainer' if run == 'dqn'
                        else 'PPOTrainer', stop)
    jax_run = getattr(jax_showcase(), f'run_{run}')
    with pytest.raises(_Built):
        jax_run(12)
    want = got['config']
    mine = {'dqn': lambda: S.dqn_config(0),
            'ppo': lambda: S.ppo_config(0, 12),
            'ppo20': lambda: S.ppo20_config(0, 12)}[run]()
    own_dir = run != 'ppo'
    for f in dataclasses.fields(want):
        if f.name == 'compute_dtype' or (own_dir and f.name == 'save_dir'):
            continue
        assert getattr(mine, f.name) == getattr(want, f.name), f.name
    assert str(mine.compute_dtype).split('.')[-1] == \
        np.dtype(want.compute_dtype).name
    if own_dir:
        assert mine.save_dir == os.path.join('artifacts', 'torch', 'ckpt',
                                             f'{run}.seed0')


def test_dqn_carry_over_six_episodes_matches_jax():
    """8x8, 2 snakes, 2 envs, 12 steps, a ring of 24 that wraps, target
    sync every 2 episodes, epsilon decay 0.9 (so that later episodes act
    on Q), through the showcase's episode loop with JAX's draws for
    each episode, against JAX's ``_train_episode`` chain."""
    cfg = dict(SMALL, epsilon_decay=0.9, target_update_freq=2)
    jtr, tr = dqn_trainers(**cfg)
    hw = (8, 8)
    jts = jtr.init_state()
    ts = train_state_from_flax(dqn_numpy_state(jts), hw, 'cpu')
    draws, chain = [], []
    for _ in range(6):
        draws.append(episode_draws(jtr, jts, tr))
        jts, jm = jtr._train_episode(jts)
        chain.append((jts, jm))
    wraps = greedy = 0
    for ep, ts, m in S.dqn_episodes(tr, ts, 6, draws):
        jts, jm = chain[ep - 1]
        where = f'episode {ep}'
        assert ts.episode == int(jts.episode) == ep
        assert float(ts.epsilon) == float(jts.epsilon), where
        assert_rings_equal(jts.buffer, ts.buffer, where)
        assert int(ts.opt_state.count) == int(jts.opt_state[1][0].count)
        assert ts.global_step == int(jts.global_step), where
        assert m.updates == int(jm.updates), where
        assert m.episode_length == float(jm.episode_length), where
        assert float(m.mean_reward) == float(jm.mean_reward), where
        np.testing.assert_allclose(float(m.mean_loss), float(jm.mean_loss),
                                   rtol=1e-4, err_msg=where)
        # the target sync: JAX copies the parameters in, the port hands
        # them over by reference, on episodes 2, 4 and 6 only
        synced = all(ts.target_params[k] is ts.params[k] for k in ts.params)
        jsynced = all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(jts.target_params), jax.tree.leaves(jts.params)))
        assert synced == jsynced == (ep % 2 == 0), where
        dqn_params_close(jts.params, ts.params, hw, 1e-3, where)
        dqn_params_close(jts.target_params, ts.target_params, hw, 1e-3,
                         f'{where} target')
        wraps += int(jts.buffer.ptr) < int(chain[ep - 2][0].buffer.ptr) \
            if ep > 1 else 0
        greedy += float(jts.epsilon) < 0.75
    assert wraps > 0 and greedy > 0 and ts.global_step > 0


def test_ppo_carry_over_four_updates_matches_jax():
    """run_ppo's config (10x10, 2 snakes of length 3) at 3 envs and 8
    rollout steps, four updates chained through the showcase's update
    loop with JAX's draws, against JAX's ``_update`` chain."""
    cfg = dataclasses.replace(S.ppo_config(0, 4), num_envs=3,
                              rollout_steps=8)
    from marlsnake_tpu.algo.ppo_trainer import PPOConfig as JConfig
    from marlsnake_tpu.algo.ppo_trainer import PPOTrainer as JTrainer
    kwargs = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(JConfig)
              if f.name not in ('compute_dtype',)}
    jtr = JTrainer(JConfig(**kwargs))
    tr = PPOTrainer(cfg, device='cpu')
    jts = jtr.init_state()
    ts = ppo_train_state_from_flax(ppo_numpy_state(jts), 'cpu')
    draws, chain, min_gap = [], [], np.inf
    for _ in range(4):
        d, rec, gap, _ = replay_jax_rollout(jtr, jts, tr.env_cfg)
        min_gap = min(min_gap, gap)
        jts, jm = jtr._update(jts)
        draws.append(d)
        chain.append((jts, jm, rec))
    episodes = 0
    for u, ts, m in S.ppo_updates(tr, ts, 4, draws):
        jts, jm, rec = chain[u - 1]
        where = f'update {u}'
        traj = tr.trajectory
        for name in ('obs', 'action', 'reward', 'valid', 'next_done'):
            np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                          rec[name], err_msg=f'{name} {where}')
        assert_fields_equal(jts.env_states, ts.env_states, where)
        np.testing.assert_array_equal(np.asarray(jts.obs), ts.obs.numpy())
        np.testing.assert_array_equal(np.asarray(jts.agent_done),
                                      ts.agent_done.numpy())
        assert int(ts.episodes) == int(jts.episodes), where
        assert ts.update == int(jts.update) == u
        assert int(ts.opt_state.count) == int(jts.opt_state[1][0].count) \
            == 16 * u
        np.testing.assert_allclose(ts.ep_return_acc.numpy(),
                                   np.asarray(jts.ep_return_acc), atol=1e-5)
        for name in LOSSES:
            np.testing.assert_allclose(
                float(getattr(m, name)), float(getattr(jm, name)),
                rtol=1e-4, atol=1e-6, err_msg=f'{name} {where}')
        for name in EPISODE:
            np.testing.assert_allclose(
                float(getattr(m, name)), float(getattr(jm, name)),
                rtol=1e-4, atol=0, err_msg=f'{name} {where}')
        episodes += int(m.episodes_collected)
        ppo_params_close(jts.params, ts.params, 1e-3, where)
    assert min_gap > 1e-4 and episodes > 0
    adam = jts.opt_state[1][0]
    for name in ('mu', 'nu'):
        ppo_params_close(getattr(adam, name), dict(zip(
            ts.params, getattr(ts.opt_state, name))), 1e-3, name)


def jax_rows(name):
    with open(os.path.join(REPO, 'artifacts', name)) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize('run,count,every', [
    ('dqn', 2, 1), ('ppo', 5, None), ('ppo20', 2, 1)])
def test_rows_have_the_jax_rows_keys_and_types(run, count, every, tmp_path):
    """A short run of each program on the CPU, narrowed to 2 envs: its
    rows have exactly the keys (in order) and the types of JAX's
    committed rows; the default cadence is JAX's (a DQN row every 10
    episodes, a PPO row every 5 updates: the ``ppo`` case runs 5 updates
    at the default and gets one row); the summary names the width."""
    fn = {'dqn': S.run_dqn, 'ppo': S.run_ppo, 'ppo20': S.run_ppo20}[run]
    kwargs = dict(seed=1, out=str(tmp_path), device='cpu', num_envs=2)
    if every:
        kwargs['every'] = every
    summary = fn(count, **kwargs)
    with open(tmp_path / f'{run}_learning_curve.seed1.jsonl') as f:
        rows = [json.loads(line) for line in f]
    want = jax_rows(f'{run}_learning_curve.jsonl')
    counter = 'episode' if run == 'dqn' else 'update'
    cadence = S.DQN_EVERY if run == 'dqn' else S.PPO_EVERY
    assert [r[counter] for r in want] == list(
        range(cadence, cadence * len(want) + 1, cadence))
    step = every or cadence
    assert [r[counter] for r in rows] == list(range(step, count + 1, step))
    for row in rows:
        assert list(row) == list(want[0])
        assert [type(v) for v in row.values()] == \
            [type(v) for v in want[0].values()], row
    assert summary['count'] == count and summary['card'] == 'cpu'
    assert summary['num_envs'] == 2
    if run != 'ppo':
        assert (tmp_path / 'ckpt' / f'{run}.seed1').is_dir()


@pytest.mark.parametrize('run', ['dqn', 'ppo', 'ppo20'])
def test_narrowed_run_is_refused_into_the_committed_curves(run):
    """A run narrowed below its config's width may not write into the
    default ``OUT``, where the committed full-width curves are: it is
    refused before anything is built."""
    fn = {'dqn': S.run_dqn, 'ppo': S.run_ppo, 'ppo20': S.run_ppo20}[run]
    with pytest.raises(ValueError, match='full-width curves'):
        fn(1, device='cpu', num_envs=2)


def test_programs_run_on_the_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    for build in (lambda: DQNTrainer(DQNConfig()),
                  lambda: PPOTrainer(PPOConfig())):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            build()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        S.main(['ppo', '--updates', '1'])


def test_programs_import_no_jax():
    """Both programs, and everything they import, load no module of JAX
    or of the JAX package."""
    code = ('import marlsnake_torch.examples.train_showcase, '
            'marlsnake_torch.tools.battle_batch_run, sys; '
            'bad = [m for m in sys.modules if m.split(".")[0] in ("jax", '
            '"jaxlib", "flax", "optax", "orbax", "marlsnake_tpu")]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)


CRITERIA = [
    # (curve, key, window, at least, at least this above the first five)
    ('dqn_learning_curve.seed{}.jsonl', 'mean_reward', 5, 4.0, 4.0),
    ('ppo_learning_curve.seed{}.jsonl', 'mean_episode_return', 5, 2.9, None),
    ('ppo20_learning_curve.seed{}.jsonl', 'reward_per_step', 4, 0.0227,
     None),
]


@pytest.mark.parametrize('curve,key,window,least,gain', CRITERIA,
                         ids=['dqn', 'ppo', 'ppo20'])
def test_committed_curves_learn(curve, key, window, least, gain):
    """The port's committed curves (artifacts/torch/, made on the card by
    the programs at their full widths) learn as JAX's did, at half of
    JAX's level: the mean of the last ``window`` rows at least ``least``
    (JAX: 8.02 over the DQN's last five rows, 5.89 over PPO's, 0.0454
    over PPO20's at update 1,200), and for the DQN at least ``gain``
    above the first five rows' mean, for every seed committed. The full
    length of each run is required (400 episodes, 150 and 1,200
    updates)."""
    paths = [os.path.join(REPO, 'artifacts', 'torch', curve.format(s))
             for s in range(3)]
    paths = [p for p in paths if os.path.exists(p)]
    assert paths, curve
    for path in paths:
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        counter = list(rows[0])[0]
        assert rows[-1][counter] == {'dqn': 400, 'ppo': 150,
                                     'ppo20': 1200}[curve.split('_')[0]]
        last = np.mean([r[key] for r in rows[-window:]])
        first = np.mean([r[key] for r in rows[:5]])
        assert last >= least, (path, first, last)
        if gain is not None:
            assert last - first >= gain, (path, first, last)
