"""The port's checkpoints (utils/checkpoint.py and the DQN and PPO
trainers' save, load, delete and resume), on the CPU.

A round trip returns every field as it was saved (equal, not close). A
``full=True`` checkpoint also holds the replay ring and the generator's
state, so an episode run after loading it equals the episode the
uninterrupted run takes next. A JAX training state carried across by
``train_state_from_flax`` gives the next update the JAX trainer gives,
within the tolerance of test_torch_dqn_trainer.py's one-update test. A
PPO checkpoint holds ``{params, opt_state, update}``, and with
``full=True`` every field of the training state and the generator's, so
that the next update from it equals the uninterrupted run's.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
from marlsnake_torch.models.weights import train_state_from_flax
from marlsnake_torch.utils import checkpoint as ckpt
from marlsnake_torch.utils.metrics import MetricWriter
from test_torch_dqn_trainer import (SMALL, _t, assert_grads_close,
                                    assert_params_close, episode_draws,
                                    jax_loss_and_grads, numpy_state,
                                    trainers)
from test_torch_replay import assert_rings_equal

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def small_trainer(tmp_path, **kwargs):
    cfg = DQNConfig(**dict(SMALL, save_dir=str(tmp_path / 'ckpt'),
                           log_dir=str(tmp_path / 'runs'), **kwargs))
    return DQNTrainer(cfg, device='cpu')


def assert_states_equal(a, b, buffer=True):
    for name in ('params', 'target_params'):
        pa, pb = getattr(a, name), getattr(b, name)
        assert list(pa) == list(pb)
        for k in pa:
            assert torch.equal(pa[k], pb[k]), (name, k)
    assert int(a.opt_state.count) == int(b.opt_state.count)
    for name in ('mu', 'nu'):
        for x, y in zip(getattr(a.opt_state, name),
                        getattr(b.opt_state, name)):
            assert torch.equal(x, y), name
    assert float(a.epsilon) == float(b.epsilon)
    assert (a.episode, a.global_step) == (b.episode, b.global_step)
    if buffer:
        for (name, x), (_, y) in zip(a.buffer.fields(), b.buffer.fields()):
            assert torch.equal(x, y), name


def test_save_restore_round_trip_and_checks(tmp_path):
    payload = {'a': {'w': torch.arange(6.).view(2, 3),
                     'n': [torch.ones(2, dtype=torch.int32)]},
               'step': 7, 'best': float('-inf'), 'flag': torch.tensor(True)}
    path = str(tmp_path / 'deep' / 'x.pt')
    ckpt.save(path, payload)
    assert os.listdir(tmp_path / 'deep') == ['x.pt']  # no temporary left
    template = {'a': {'w': torch.zeros(2, 3),
                      'n': [torch.zeros(2, dtype=torch.int32)]},
                'step': 0, 'best': 0.0, 'flag': torch.tensor(False)}
    got = ckpt.restore(path, template)
    assert torch.equal(got['a']['w'], payload['a']['w'])
    assert torch.equal(got['a']['n'][0], payload['a']['n'][0])
    assert got['step'] == 7 and got['best'] == float('-inf')
    assert bool(got['flag'])
    ckpt.save(path, {'a': payload['a']})               # overwrite in place
    with pytest.raises(KeyError):
        ckpt.restore(path, template)
    with pytest.raises(ValueError):
        ckpt.restore(path, {'a': {'w': torch.zeros(3, 2),
                                  'n': [torch.zeros(2, dtype=torch.int32)]}})
    with pytest.raises(ValueError):
        ckpt.restore(path, {'a': {'w': torch.zeros(2, 3, dtype=torch.int32),
                                  'n': [torch.zeros(2, dtype=torch.int32)]}})


def test_async_checkpointer_round_trip(tmp_path):
    """``AsyncCheckpointer.save`` snapshots the payload before it returns
    (changing the tensors after does not reach the file), writes in the
    background, one write after the other; ``wait`` raises a failed
    write's error; ``close`` leaves every file written and no temporary."""
    w = torch.arange(6.).view(2, 3)
    payload = {'params': {'w': w}, 'step': 3}
    template = {'params': {'w': torch.zeros(2, 3)}, 'step': 0}
    saver = ckpt.AsyncCheckpointer()
    try:
        saver.save(str(tmp_path / 'a' / 'c1.pt'), payload)
        w.add_(100.0)                          # training goes on
        saver.save(str(tmp_path / 'a' / 'c2.pt'), dict(payload, step=4))
        saver.wait()
        first = ckpt.restore(str(tmp_path / 'a' / 'c1.pt'), template)
        second = ckpt.restore(str(tmp_path / 'a' / 'c2.pt'), template)
        assert torch.equal(first['params']['w'], torch.arange(6.).view(2, 3))
        assert torch.equal(second['params']['w'], w)
        assert (first['step'], second['step']) == (3, 4)
        (tmp_path / 'file').write_text('')
        saver.save(str(tmp_path / 'file' / 'c3.pt'), payload)
        with pytest.raises(OSError):
            saver.wait()
        saver.save(str(tmp_path / 'a' / 'c3.pt'), payload)
    finally:
        saver.close()
    assert sorted(os.listdir(tmp_path / 'a')) == ['c1.pt', 'c2.pt', 'c3.pt']


@pytest.mark.parametrize('full', [False, True], ids=['light', 'full'])
def test_trainer_checkpoint_round_trip(tmp_path, full):
    tr = small_trainer(tmp_path)
    ts = tr.init_state()
    for _ in range(2):
        ts, _ = tr.train_episode(ts)
    assert ts.global_step > 0
    tr.best_mean_reward = 1.25
    gen_state = tr.generator.get_state()
    tr.save_checkpoint(ts, 'probe', full=full)
    path = tmp_path / 'ckpt' / 'shared_model_probe.pt'
    assert path.exists()
    with open(tmp_path / 'ckpt' / 'shared_model_probe.meta.json') as f:
        assert json.load(f) == {'obs_pad_channels': 0, 'obs_format': 'uint8'}

    fresh = small_trainer(tmp_path, seed=5)
    got, extra = fresh.load_checkpoint('probe', fresh.init_state(),
                                       full=full)
    assert extra == {'best_mean_reward': 1.25}
    assert_states_equal(got, ts, buffer=full)
    if full:
        assert torch.equal(fresh.generator.get_state(), gen_state)
    else:
        assert int(got.buffer.size) == 0            # the fresh ring
        with pytest.raises(KeyError):
            fresh.load_checkpoint('probe', fresh.init_state(), full=True)
    tr.delete_checkpoint('probe')
    assert os.listdir(tmp_path / 'ckpt') == []
    tr.delete_checkpoint('probe')                    # absent: no error


def test_full_resume_repeats_the_uninterrupted_run(tmp_path):
    tr = small_trainer(tmp_path)
    ts = tr.init_state()
    ts, _ = tr.train_episode(ts)
    tr.save_checkpoint(ts, 'mid', full=True)
    resumed = small_trainer(tmp_path, seed=9)
    rs, _ = resumed.load_checkpoint('mid', resumed.init_state(), full=True)
    for _ in range(2):
        # in turns: an episode updates its state's ring in place
        ts_want, m_want = ts, _ = tr.train_episode(ts)
        rs, m = resumed.train_episode(rs)
        assert m.episode_length == m_want.episode_length
        assert m.updates == m_want.updates
        assert float(m.mean_reward) == float(m_want.mean_reward)
        assert float(m.mean_loss) == float(m_want.mean_loss)
        assert_states_equal(rs, ts_want)


def test_train_saves_periodic_checkpoints_keeps_the_last_n_and_resumes(
        tmp_path, capsys):
    tr = small_trainer(tmp_path, save_freq=1, keep_last_n=2,
                       save_best_only=False)
    ts = tr.train(num_episodes=4, log=False)
    names = sorted(os.listdir(tmp_path / 'ckpt'))
    assert names == sorted(
        f'shared_model_{tag}.{ext}' for tag in (3, 4, 'final')
        for ext in ('pt', 'meta.json'))
    assert ts.episode == 4
    assert 'Ep     4 |' in capsys.readouterr().out
    assert not (tmp_path / 'runs').exists()

    again = small_trainer(tmp_path, save_freq=0, resume_from='final')
    ts2 = again.train(num_episodes=6, log=True)
    assert ts2.episode == 6 and ts2.global_step >= ts.global_step
    out = capsys.readouterr().out
    assert 'Ep     6 |' in out and 'Ep     4 |' not in out
    runs = os.listdir(tmp_path / 'runs')
    assert len(runs) == 1
    with open(tmp_path / 'runs' / runs[0] / 'metrics.jsonl') as f:
        tags = {json.loads(line)['tag'] for line in f}
    assert {'Train/Mean_Reward', 'Train/Epsilon',
            'Train/Episode_Length'} <= tags


def test_best_checkpoint_is_saved_from_episode_50_on(tmp_path):
    tr = small_trainer(tmp_path, save_freq=0, max_steps_per_episode=2,
                       min_buffer_size=10_000)
    tr.train(num_episodes=51, log=False)
    names = set(os.listdir(tmp_path / 'ckpt'))
    assert {'shared_model_best.pt', 'shared_model_final.pt'} <= names
    assert tr.best_mean_reward > float('-inf')


def test_jax_train_state_carries_over_so_that_the_next_update_matches(
        tmp_path):
    """A JAX TrainState after a warm episode (non-zero Adam moments, a
    partly filled ring), as numpy, becomes the port's; the next update
    on the same sampled batch gives the JAX trainer's loss and gradients,
    and parameters within Adam's reach (see test_torch_dqn_trainer.py)."""
    hw = (8, 8)
    jtr, tr = trainers(**SMALL)
    jts = jtr.init_state()
    jts, jm = jtr._train_episode(jts)
    assert int(jm.updates) > 0
    ts = train_state_from_flax(numpy_state(jts), hw, 'cpu')
    assert_rings_equal(jts.buffer, ts.buffer, 'carried ring')
    assert ts.episode == 1 and ts.global_step == int(jts.global_step)
    assert float(ts.epsilon) == float(jts.epsilon)
    adam = jts.opt_state[1][0]
    assert int(ts.opt_state.count) == int(adam.count)
    for name in ('mu', 'nu'):
        assert_params_close(getattr(adam, name),
                            dict(zip(ts.params, getattr(ts.opt_state, name))),
                            hw, 0.0, name)
    assert_params_close(jts.params, ts.params, hw, 0.0, 'params')

    from marlsnake_tpu.algo import replay as JR
    from marlsnake_torch.algo import replay as TR
    import jax
    key = jax.random.key(3)
    jbatch = JR.sample(jts.buffer, key, 8)
    batch = TR.sample(ts.buffer, 8, _t(jax.random.uniform(key, (24,))))
    jloss, jgrads = jax_loss_and_grads(jtr, jts.params, jts.target_params,
                                       jbatch)
    loss, grads, _ = tr.loss_and_grads(ts.params, ts.target_params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert_grads_close(jgrads, dict(zip(ts.params, grads)), hw, 'grad')
    jp, jopt, _ = jtr._td_update(jts.params, jts.target_params,
                                 jts.opt_state, jbatch)
    p2, opt2, _, _ = tr._td_update(ts.params, ts.target_params,
                                   ts.opt_state, batch)
    assert int(opt2.count) == int(jopt[1][0].count)
    assert_params_close(jp, p2, hw, 1e-3, 'updated params')

    # and the carried state saves and loads like any other
    tr.config.save_dir = str(tmp_path)
    tr.save_checkpoint(ts, 'carried', full=True)
    back, _ = tr.load_checkpoint('carried', tr.init_state(), full=True)
    assert_states_equal(back, ts)


def test_metric_writer(tmp_path):
    w = MetricWriter(str(tmp_path / 'log'))
    w.add_scalars({'a': 1.5, 'b': 2}, step=3)
    w.flush()
    w.close()
    with open(tmp_path / 'log' / 'metrics.jsonl') as f:
        rows = [json.loads(line) for line in f]
    assert [(r['tag'], r['value'], r['step']) for r in rows] == [
        ('a', 1.5, 3), ('b', 2.0, 3)]


# --- PPO checkpoints (the mirror of tests/test_checkpoint.py's PPO cases) ---

PPO_SMALL = dict(height=8, width=8, num_snakes=2, snake_length=2,
                 num_envs=4, rollout_steps=8, num_minibatches=2)

def small_ppo_trainer(tmp_path, **kwargs):
    cfg = PPOConfig(**dict(PPO_SMALL, update_epochs=1,
                           save_dir=str(tmp_path / 'ckpt'),
                           log_dir=str(tmp_path / 'runs'), **kwargs))
    return PPOTrainer(cfg, device='cpu')


def assert_train_states_equal(a, b, full=True):
    assert list(a.params) == list(b.params)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert a.update == b.update
    if full:
        for (name, x), (_, y) in zip(a.env_states.fields(),
                                     b.env_states.fields()):
            assert torch.equal(x, y), name
        for name in ('obs', 'agent_done', 'episodes', 'ep_return_acc',
                     'finished_return_sum', 'finished_count'):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_ppo_partial_and_full_checkpoint_round_trip(tmp_path):
    tr = small_ppo_trainer(tmp_path)
    ts, _ = tr.update(tr.init_state())
    tr.save_checkpoint(ts, 'p')
    tr.save_checkpoint(ts, 'f', full=True)
    assert os.path.exists(tmp_path / 'ckpt' / 'ppo_p')
    other = small_ppo_trainer(tmp_path, seed=5)
    fresh = other.init_state()
    part = other.load_checkpoint('p', fresh)
    assert_train_states_equal(part, ts, full=False)
    assert part.env_states is fresh.env_states    # the rest stays as given
    full = other.load_checkpoint('f', other.init_state(), full=True)
    assert_train_states_equal(full, ts)
    assert torch.equal(other.generator.get_state(), tr.generator.get_state())
    with pytest.raises(KeyError):                 # a partial file lacks it
        other.load_checkpoint('p', fresh, full=True)


def test_ppo_kill_and_resume_matches_uninterrupted(tmp_path):
    """A full checkpoint mid-run: the next update from the loaded state,
    in a second trainer, equals the one the first trainer makes."""
    tr = small_ppo_trainer(tmp_path)
    ts, _ = tr.update(tr.init_state())
    tr.save_checkpoint(ts, 'mid', full=True)
    ts_a, m_a = tr.update(ts)
    tr2 = small_ppo_trainer(tmp_path, seed=3)
    ts_b = tr2.load_checkpoint('mid', tr2.init_state(), full=True)
    ts_b, m_b = tr2.update(ts_b)
    for f in dataclasses.fields(m_a):
        assert float(getattr(m_a, f.name)) == float(getattr(m_b, f.name))
    assert_train_states_equal(ts_a, ts_b)


def test_ppo_resume_from_config_routes(tmp_path):
    """``resume_from`` continues from a saved tag with warm optimizer
    state and the update counter advanced; ``train`` logs the seven
    scalars."""
    tr = small_ppo_trainer(tmp_path, num_updates=2, rollout_steps=4)
    ts = tr.train(log=True)
    assert ts.update == 2
    (run,) = os.listdir(tmp_path / 'runs')
    with open(tmp_path / 'runs' / run / 'metrics.jsonl') as f:
        tags = {json.loads(line)['tag'] for line in f}
    assert tags == {'loss/actor', 'loss/value', 'policy/entropy',
                    'policy/approx_kl', 'env/mean_reward_per_step_per_agent',
                    'env/mean_episode_return', 'env/episodes_collected'}
    tr2 = small_ppo_trainer(tmp_path, num_updates=3, rollout_steps=4,
                        resume_from='final')
    ts2 = tr2.train(log=False)
    assert ts2.update == 3                 # resumed at 3, ran one update
    # warm moments: two minibatches an update, three updates in all
    assert int(ts2.opt_state.count) == 6
