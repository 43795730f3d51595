"""marlsnake_torch.algo.ppo_trainer against marlsnake_tpu.algo.ppo_trainer.

Both trainers start from the same state (the JAX ``PPOTrainState``
carried across by ``models/weights.ppo_train_state_from_flax``) and take
the same random numbers: the JAX trainer's from its key schedule
(ppo_trainer.py:191, 227, 321-324), the envs' from their own keys, and the
port takes exactly those numbers as ``PPODraws``. The JAX rollout is
replayed step by step beside the jitted update to read its actions, keys
and obs; ``jax.random.categorical`` is ``argmax(logits + gumbel)`` with
the Gumbel noise of the same key, which the test checks. Float32 on the
CPU, TF32 off. Tolerances, each where it is used:

* the rollout (actions, rewards, done flags, obs, final env states):
  EQUAL; an action is exact while ``logits + gumbel`` has no near-tie, so
  the smallest top-two gap over the test's steps is asserted above 1e-4;
* advantages and returns within 1e-5 absolute;
* ``loss_actor``, ``loss_value``, ``entropy``, ``approx_kl`` and the
  episode metrics within 1e-4 relative (1e-6 absolute for the losses
  that are near 0 by construction: the first minibatch's ratio is 1, so
  its actor loss and KL are sums of terms of both signs);
* parameters and Adam moments within 1e-3 absolute after two updates (as
  the DQN trainer's episode test: Adam moves an element by about ``lr``
  whatever the size of its gradient).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo.ppo_trainer import PPOConfig as JConfig
from marlsnake_tpu.algo.ppo_trainer import PPOTrainer as JTrainer
from marlsnake_torch.algo.dqn_trainer import mean_of
from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
from marlsnake_torch.models.weights import (actor_critic_to_flax,
                                            ppo_train_state_from_flax)
from marlsnake_torch.rng import PPODraws, StepDraws, ppo_draws
from test_torch_engine import _t, assert_fields_equal, step_draws_from_keys

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(height=8, width=8, num_snakes=2, snake_length=2, num_envs=4,
             rollout_steps=8, num_minibatches=2, update_epochs=2)


def trainers(**kwargs):
    """The same configuration in both packages, the port on the CPU."""
    return JTrainer(JConfig(**kwargs)), PPOTrainer(PPOConfig(**kwargs),
                                                   device='cpu')


def numpy_state(jts):
    """A JAX PPOTrainState with numpy leaves (keys as their raw data)."""
    env = jts.env_states
    return jax.tree.map(np.asarray, jts.replace(
        key=jax.random.key_data(jts.key),
        env_states=env.replace(key=jax.random.key_data(env.key))))


@functools.lru_cache(maxsize=None)
def _jitted(jtr):
    return jax.jit(jtr._policy), jax.jit(jtr._step_env)


def replay_jax_rollout(jtr, jts, env_cfg, axis_index=None):
    """The rollout the JAX trainer's next update takes from ``jts``
    (ppo_trainer.py:188-239), step by step. Returns (PPODraws for the
    port, what each step recorded, the smallest top-two gap of
    ``logits + gumbel``, the obs after the last step). With
    ``axis_index``, that device's rollout of a data-parallel mesh: ``jts``
    holds the device's rows, ``jtr`` has its ``num_envs``, and its stream
    folds in its index (ppo_trainer.py:227-230)."""
    cfg = jtr.config
    policy, step_env = _jitted(jtr)
    key, _ = jax.random.split(jts.key)
    if axis_index is not None:
        key = jax.random.fold_in(key, axis_index)
    env_states, obs, agent_done = jts.env_states, jts.obs, jts.agent_done
    rec = {k: [] for k in ('obs', 'action', 'value', 'reward', 'valid',
                           'next_done')}
    step, noise, gap = [], [], np.inf
    for _ in range(cfg.rollout_steps):
        key, k_act = jax.random.split(key)
        logits, value = policy(jts.params, obs)
        g = jax.random.gumbel(k_act, logits.shape)
        z = np.asarray(logits + g)
        action = z.argmax(-1)
        np.testing.assert_array_equal(
            action, np.asarray(jax.random.categorical(k_act, logits)))
        top2 = np.sort(z, -1)[..., -2:]
        gap = min(gap, float((top2[..., 1] - top2[..., 0]).min()))
        action = np.where(np.asarray(agent_done), 0, action).astype(np.int32)
        step.append(step_draws_from_keys(env_cfg, env_states.key))
        noise.append(np.asarray(g))
        valid = ~np.asarray(agent_done)
        env_states, out = step_env(env_states, jnp.asarray(action))
        ep_done = np.asarray(out.done_all)
        rec['obs'].append(np.asarray(obs).reshape(obs.shape[0]
                                                  * obs.shape[1], -1))
        rec['action'].append(action)
        rec['value'].append(np.asarray(value))
        rec['reward'].append(np.where(valid, np.asarray(out.reward), 0.0))
        rec['valid'].append(valid)
        rec['next_done'].append(np.asarray(out.done) | ep_done[:, None])
        agent_done = np.where(ep_done[:, None], False, np.asarray(out.done))
        obs = out.obs
    key, k_perm = jax.random.split(key)
    b = cfg.rollout_steps * cfg.num_envs * cfg.num_snakes
    perm = np.stack([np.asarray(jax.random.permutation(k, b))
                     for k in jax.random.split(k_perm, cfg.update_epochs)])
    draws = PPODraws(StepDraws(*(torch.stack(x) for x in zip(*step))),
                     _t(np.stack(noise)), _t(perm).long())
    _, last_value = policy(jts.params, obs)
    return draws, {k: np.stack(v) for k, v in rec.items()}, gap, last_value


def jax_gae(cfg, rec, last_value):
    """The JAX trainer's GAE scan (ppo_trainer.py:244-255) on the
    replayed rollout."""
    def body(carry, step):
        gae, next_value = carry
        nonterminal = 1.0 - step['next_done'].astype(jnp.float32)
        delta = (step['reward'] + cfg.gamma * next_value * nonterminal
                 - step['value'])
        gae = delta + cfg.gamma * cfg.gae_lambda * nonterminal * gae
        return (gae, step['value']), (gae, gae + step['value'])

    traj = {k: jnp.asarray(rec[k]) for k in ('reward', 'value', 'next_done')}
    _, (adv, ret) = jax.lax.scan(
        body, (jnp.zeros_like(last_value), last_value), traj, reverse=True)
    return np.asarray(adv), np.asarray(ret)


def assert_params_close(jparams, params, atol, what):
    got = actor_critic_to_flax(params)['params']
    for layer, leaves in jparams['params'].items():
        for name, want in leaves.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(want),
                                       rtol=0, atol=atol,
                                       err_msg=f'{what} {layer}/{name}')


LOSSES = ('loss_actor', 'loss_value', 'entropy', 'approx_kl')
EPISODE = ('mean_reward_per_step_per_agent', 'mean_episode_return',
           'episodes_collected')


@pytest.mark.parametrize('mode', [
    dict(), dict(obs_format='packed', frame_stack=2), dict(vision_range=2)],
    ids=['uint8', 'packed-stack2', 'vision2'])
def test_two_updates_match_jax(mode):
    """8x8, 2 snakes of length 2, 4 envs, 8 rollout steps, 2 minibatches,
    2 epochs: two updates from the same carried state and draws."""
    jtr, tr = trainers(**SMALL, **mode)
    jts = jtr.init_state()
    ts = ppo_train_state_from_flax(numpy_state(jts), 'cpu')
    min_gap, episodes = np.inf, 0
    for u in range(2):
        where = f'update {u}'
        draws, rec, gap, last_value = replay_jax_rollout(jtr, jts,
                                                         tr.env_cfg)
        min_gap = min(min_gap, gap)
        jts, jm = jtr._update(jts)
        ts, m = tr.update(ts, draws)
        traj = tr.trajectory
        for name in ('obs', 'action', 'reward', 'valid', 'next_done'):
            np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                          rec[name], err_msg=f'{name} {where}')
        assert_fields_equal(jts.env_states, ts.env_states, where)
        np.testing.assert_array_equal(np.asarray(jts.obs), ts.obs.numpy())
        np.testing.assert_array_equal(np.asarray(jts.agent_done),
                                      ts.agent_done.numpy())
        assert int(ts.episodes) == int(jts.episodes)
        assert ts.update == int(jts.update) == u + 1
        np.testing.assert_allclose(ts.ep_return_acc.numpy(),
                                   np.asarray(jts.ep_return_acc), atol=1e-5)
        if u == 0:
            # the same parameters made both rollouts' values
            adv, ret = jax_gae(jtr.config, rec, last_value)
            np.testing.assert_allclose(traj.advantages.numpy(), adv,
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(traj.returns.numpy(), ret,
                                       rtol=0, atol=1e-5)
        for name in LOSSES:
            np.testing.assert_allclose(
                float(getattr(m, name)), float(getattr(jm, name)),
                rtol=1e-4, atol=1e-6, err_msg=f'{name} {where}')
        for name in EPISODE:
            np.testing.assert_allclose(
                float(getattr(m, name)), float(getattr(jm, name)),
                rtol=1e-4, atol=0, err_msg=f'{name} {where}')
        episodes += int(m.episodes_collected)
    assert min_gap > 1e-4 and episodes > 0
    assert_params_close(jts.params, ts.params, 1e-3, 'params')
    adam = jts.opt_state[1][0]
    assert int(ts.opt_state.count) == int(adam.count) == 8
    for name in ('mu', 'nu'):
        assert_params_close(getattr(adam, name), dict(zip(
            ts.params, getattr(ts.opt_state, name))), 1e-3, name)


def test_metric_means_are_xla_s_means_exactly(monkeypatch):
    """The update's means as the JAX trainer's compiled ``jnp.mean`` gives
    them, the sum times the count's float32 reciprocal
    (``dqn_trainer.mean_of``), pinned with ``==``: at 3 snakes, where
    ``Tensor.mean``'s division differs in the last bit in about a third
    of the rows, and 3 epochs x 1 minibatch, 3 losses a metric. The
    episode return's per-env mean over the snakes (ppo_trainer.py:204)
    goes through the trainer on JAX's own rollout, whose returns are
    EQUAL, so the whole metric is compared with JAX's. A time penalty
    makes the returns other than whole numbers; a loss of -2 puts a
    finished env's sum of returns near -6, where a division and the
    product disagree for every other hundredth (near -3 they agree for
    most); and the test checks that a division would have given another
    metric in at least one update
    (the reward per step is a sum of 48 rows, whose order differs, and
    ``test_two_updates_match_jax`` holds it within 1e-4).
    The four loss metrics agree with JAX's only within 1e-4 (each
    minibatch's loss does), so their mean (ppo_trainer.py:326) is held
    against the JAX program's mean of the port's own minibatch losses.
    At 5 or more values a sum's order differs between XLA and torch as
    well, and equality is out of reach there."""
    kwargs = dict(SMALL, num_snakes=3, num_envs=2, num_minibatches=1,
                  update_epochs=3, reward_dict=dict(
                      fruit=1.0, kill=0.0, lose=-2.0, win=0.0, time=-0.01))
    jtr, tr = trainers(**kwargs)
    jts = jtr.init_state()
    ts = ppo_train_state_from_flax(numpy_state(jts), 'cpu')
    auxs = []
    loss_and_grads = tr.loss_and_grads

    def recorded(params, mb):
        out = loss_and_grads(params, mb)
        auxs.append(out[1].numpy())
        return out

    monkeypatch.setattr(tr, 'loss_and_grads', recorded)
    jmean = jax.jit(lambda x: x.mean(0))
    episodes, division_differs = 0, False
    for u in range(2):
        acc = ts.ep_return_acc
        draws, rec, _, _ = replay_jax_rollout(jtr, jts, tr.env_cfg)
        jts, jm = jtr._update(jts)
        auxs.clear()
        ts, m = tr.update(ts, draws)
        assert len(auxs) == 3
        want = np.asarray(jmean(jnp.asarray(np.stack(auxs))))
        got = np.array([float(getattr(m, name)) for name in LOSSES],
                       np.float32)
        np.testing.assert_array_equal(got, want, err_msg=f'update {u}')
        for name in ('mean_episode_return', 'episodes_collected'):
            assert float(getattr(m, name)) == float(getattr(jm, name)), \
                (name, u)
        # the finished episodes' returns summed with each mean taken both
        # ways (done_mode 'all': an env ends when all its snakes are done)
        sums = torch.zeros(2)
        for reward, done in zip(_t(rec['reward']), _t(rec['next_done'])):
            acc = acc + reward
            ended = done.all(-1)[:, None]
            sums += torch.where(ended, torch.stack(
                [acc.mean(-1), mean_of(acc, -1)], -1), 0.0).sum(0)
            acc = acc.masked_fill(ended, 0.0)
        division_differs |= bool(sums[0] != sums[1])
        episodes += int(m.episodes_collected)
    assert episodes > 0 and division_differs


def test_one_minibatch_loss_and_gradients_match_jax():
    """The loss of one minibatch and its gradients against jax.grad of
    the JAX trainer's loss on the same rows (ppo_trainer.py:273-296),
    some rows masked out: loss within 1e-6 relative, gradients within
    1e-6 + 1e-5 x their largest magnitude."""
    from marlsnake_torch.algo.ppo_trainer import Minibatch
    from marlsnake_torch.models.weights import actor_critic_from_flax
    jtr, tr = trainers(**SMALL)
    params = jtr.init_state().params
    rng = np.random.default_rng(0)
    m = 48
    batch = dict(
        obs=(rng.random((m, 8 * 8 * 8)) < 0.2).astype(np.uint8),
        action=rng.integers(0, 3, m).astype(np.int32),
        logprob=np.log(rng.uniform(0.2, 0.5, m)).astype(np.float32),
        adv=rng.normal(size=m).astype(np.float32),
        ret=rng.normal(size=m).astype(np.float32),
        valid=rng.random(m) < 0.8)
    cfg = jtr.config

    def jloss(p):
        obs = batch['obs'].reshape((m,) + jtr.env_cfg.obs_shape[1:])
        logits, value = jtr.net.apply(p, obs)
        logp_all = jax.nn.log_softmax(logits)
        logp = jnp.take_along_axis(logp_all, batch['action'][:, None],
                                   -1)[:, 0]
        v = batch['valid'].astype(jnp.float32)
        vsum = jnp.maximum(v.sum(), 1.0)
        ratio = jnp.exp(logp - batch['logprob'])
        adv = batch['adv']
        adv = (adv - (adv * v).sum() / vsum) / (
            jnp.sqrt(((adv - (adv * v).sum() / vsum) ** 2 * v).sum()
                     / vsum) + 1e-8)
        pg = jnp.maximum(-adv * ratio, -adv * jnp.clip(
            ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps))
        return ((pg * v).sum() / vsum
                + cfg.vf_coef * (0.5 * (value - batch['ret']) ** 2
                                 * v).sum() / vsum
                - cfg.ent_coef * (-(jnp.exp(logp_all) * logp_all).sum(-1)
                                  * v).sum() / vsum)

    want, jgrads = jax.value_and_grad(jloss)(params)
    mb = Minibatch(*(_t(batch[k]) for k in ('obs', 'action', 'logprob',
                                             'adv', 'ret', 'valid')))
    tparams = actor_critic_from_flax(params)
    total, aux, grads = tr.loss_and_grads(tparams, mb)
    np.testing.assert_allclose(float(total), float(want), rtol=1e-6)
    assert aux.shape == (4,) and not aux.requires_grad
    assert not total.requires_grad
    got = actor_critic_to_flax(dict(zip(tparams, grads)))['params']
    for layer, leaves in jgrads['params'].items():
        for name, g in leaves.items():
            g = np.asarray(g)
            np.testing.assert_allclose(got[layer][name], g, rtol=0,
                                       atol=1e-6 + 1e-5 * np.abs(g).max(),
                                       err_msg=f'{layer}/{name}')


def test_config_defaults_and_checks_match_jax():
    jdefaults = {f.name: f.default for f in dataclasses.fields(JConfig)
                 if f.default is not dataclasses.MISSING}
    defaults = {f.name: f.default for f in dataclasses.fields(PPOConfig)
                if f.default is not dataclasses.MISSING}
    assert list(defaults) == list(jdefaults)
    assert jdefaults.pop('compute_dtype') is jnp.float32
    assert defaults.pop('compute_dtype') is torch.float32
    assert defaults == jdefaults
    assert PPOConfig().reward_dict == JConfig().reward_dict
    cfg = PPOConfig().env_config()
    assert (cfg.height, cfg.width, cfg.num_snakes, cfg.snake_length) == (
        20, 20, 4, 5)
    assert cfg.spawn_mode == 'pool' and cfg.rewards == (1.0, 0, 0, 0, 0)
    for config in (JConfig, PPOConfig):
        with pytest.raises(KeyError):
            config(reward_dict={'fruit': 1.0}).env_config()


def test_update_with_own_draws_is_reproducible():
    """The trainer's own draws: two trainers of one seed give equal
    updates, the parameters move, the generator ends in one place, and
    the rollout buffer keeps the last rollout."""
    runs = []
    for _ in range(2):
        tr = PPOTrainer(PPOConfig(**SMALL), device='cpu')
        ts0 = tr.init_state()
        ts, m = tr.update(ts0)
        runs.append((tr, ts0, ts, m))
    (ta, a0, a, ma), (tb, _, b, mb) = runs
    assert torch.equal(ta.generator.get_state(), tb.generator.get_state())
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert float(ma.loss_value) == float(mb.loss_value)
    assert not torch.equal(a.params['actor_fc2.weight'],
                           a0.params['actor_fc2.weight'])
    assert torch.equal(ta.trajectory.obs, tb.trajectory.obs)
    # the entropy of a fresh policy over 3 actions is near ln 3
    assert abs(float(ma.entropy) - np.log(3)) < 0.1
    draws = ppo_draws(ta.env_cfg, 4, 8, 2, torch.Generator().manual_seed(0),
                      'cpu')
    assert draws.gumbel.shape == (8, 4, 2, 3)
    assert draws.perm.shape == (2, 64) and draws.perm.dtype == torch.int64
    assert torch.equal(draws.perm[0].sort().values, torch.arange(64))
    assert draws.step.fruit_u.shape == (8, 4, 2)


def test_main_runs_on_the_cpu(tmp_path):
    """``python -m marlsnake_torch.algo.ppo_trainer --device cpu``: the
    default board, one update of two envs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, '-m', 'marlsnake_torch.algo.ppo_trainer',
         '--device', 'cpu', '--updates', '1', '--num-envs', '2',
         '--no-log'], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert 'update    1 | return' in out.stdout
    assert (tmp_path / 'checkpoints_ppo' / 'ppo_final').exists()
    assert not (tmp_path / 'runs').exists()
