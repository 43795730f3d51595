"""marlsnake_torch.parallel.dqn_dp against marlsnake_tpu.parallel.dqn_dp on
two ranks.

JAX's ``DistributedDQN`` runs in this process on a two-device mesh of the
virtual CPU devices (``tests/conftest.py``); the port's runs in two gloo
ranks on the CPU (``parallel.runner``, file rendezvous in ``tmp_path``),
from the same per-rank states (``flax_states.dp_train_states_from_flax``)
and with each rank's draws from JAX's own key schedule, the axis index
folded in. Float32, TF32 off. Tolerances, as
``test_torch_dqn_trainer.test_episode_matches_jax``: each rank's ring,
the episode length (a mean over ranks), the update count, the mean reward
and epsilon EQUAL; the mean loss within 1e-4 relative; the parameters
within 1e-3 absolute of JAX's; and the two ranks' parameters bit-equal.

JAX's episode program is built as ``dqn_dp.py:64-80`` builds it, but with
``shard_map``'s ``check_vma`` off (``jax_dqn_dp``): with it on, JAX's
default, the replicated parameters' cotangent is summed over the devices
before the trainer's ``pmean``, so the devices' gradients are summed, not
averaged (``test_jax_default_shard_map_sums_replicated_gradients``). The
port averages, as the trainers' ``pmean`` means to (``ROADMAP.md`` §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from marlsnake_tpu.algo.dqn_trainer import DQNConfig as JConfig
from marlsnake_tpu.algo.dqn_trainer import DQNTrainer as JTrainer
from marlsnake_tpu.parallel import dqn_dp as jax_dqn_dp_module
from marlsnake_tpu.parallel.mesh import make_mesh as jax_mesh
from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
from marlsnake_torch.algo.flax_states import dp_train_states_from_flax
from marlsnake_torch.models.weights import dqn_to_flax
from marlsnake_torch.parallel.runner import run_job
from test_torch_dqn_trainer import (SMALL, assert_grads_close,
                                    assert_params_close, episode_draws,
                                    jax_grads_with_port_gates, numpy_state,
                                    port_preacts)
from test_torch_replay import assert_rings_equal

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

WORLD = 2


class _Local:
    """What ``episode_draws`` reads of a port trainer: one rank's config
    and env config."""

    def __init__(self, config: DQNConfig):
        self.config = config
        self.env_cfg = config.env_config()
        self.update_batch = config.update_batch_size or config.batch_size


def jax_dqn_dp(config: JConfig):
    """JAX's DistributedDQN on two devices, its episode program built with
    ``check_vma=False`` (dqn_dp.py:64-80 otherwise), under which the
    trainer's ``pmean`` of the gradients is their mean."""
    jd = jax_dqn_dp_module.DistributedDQN(config, jax_mesh(WORLD))

    def episode_local(ts):
        buf = ts.buffer
        ts = ts.replace(buffer=buf.replace(ptr=buf.ptr[0], size=buf.size[0]))
        ts, metrics = jd.trainer._episode_impl(ts)
        buf = ts.buffer
        return ts.replace(buffer=buf.replace(ptr=buf.ptr[None],
                                             size=buf.size[None])), metrics

    specs = jax_dqn_dp_module._state_specs(jax.eval_shape(
        jd.trainer.init_state, jax.random.key(0)))
    jd._episode = jax.jit(jax.shard_map(
        episode_local, mesh=jd.mesh, in_specs=(specs,),
        out_specs=(specs, P()), check_vma=False))
    return jd


def test_jax_default_shard_map_sums_replicated_gradients():
    """Why ``jax_dqn_dp`` turns ``check_vma`` off: the trainers' pattern,
    ``value_and_grad`` of a device's loss in replicated parameters and a
    ``pmean`` of the gradient, gives the SUM of the devices' gradients
    under JAX's default and their mean without the check."""
    def grad(w, x):
        g = jax.grad(lambda w: jnp.mean(x * w))(w)
        return jax.lax.pmean(g, 'data')

    x = jnp.array([1.0, 2.0, 3.0, 4.0])          # device means 1.5, 3.5
    for check, want in ((True, 5.0), (False, 2.5)):
        fn = jax.jit(jax.shard_map(grad, mesh=jax_mesh(WORLD),
                                   in_specs=(P(), P('data')), out_specs=P(),
                                   check_vma=check))
        assert float(fn(jnp.float32(1.0), x)) == want


def run_both(tmp_path, episodes=2, calls=0, **kwargs):
    """``episodes`` episodes of JAX's DistributedDQN on two devices and of
    the port's on two ranks, from the same state and draws; each rank
    keeps its first ``calls`` learner calls (the runner's ``'check'``).
    Returns (JAX states and metrics after each episode, each rank's
    results, the grid's (H, W), JAX's start state)."""
    jd = jax_dqn_dp(JConfig(**kwargs))
    jts = start = jd.init_state()
    local = _Local(DQNConfig(**dict(kwargs,
                                    num_envs=kwargs['num_envs'] // WORLD)))
    hw = (local.env_cfg.obs_height, local.env_cfg.obs_width)
    states = dp_train_states_from_flax(numpy_state(jts), hw, WORLD, 'cpu')
    draws, jax_runs = [], []
    for _ in range(episodes):
        per_rank = []
        for r in range(WORLD):
            reset, d = episode_draws(None, jts, local, axis_index=r)
            per_rank.append((d, reset))
        draws.append(per_rank)
        jts, jm = jd.train_episode(jts)
        jax_runs.append((numpy_state(jts), jm))
    results = run_job({'device': 'cpu', 'backend': None, 'tasks': [
        {'kind': 'dqn', 'config': kwargs, 'episodes': episodes,
         'states': states, 'draws': draws, 'check': calls}]}, WORLD,
        str(tmp_path))
    return jax_runs, [r[0] for r in results], hw, numpy_state(start)


def rank_ring(jbuf, r):
    """Device r's shard of the JAX mesh-global ring."""
    cap = jbuf.obs.shape[0] // WORLD
    rows = slice(r * cap, (r + 1) * cap)
    return jbuf.replace(obs=jbuf.obs[rows], action=jbuf.action[rows],
                        reward=jbuf.reward[rows],
                        next_obs=jbuf.next_obs[rows], done=jbuf.done[rows],
                        ptr=jbuf.ptr[r], size=jbuf.size[r])


def assert_matches(jax_runs, ranks, hw, params=True):
    """Each rank against JAX's episodes; the parameters too unless
    ``params`` is False."""
    for ep, (jts, jm) in enumerate(jax_runs):
        for r, res in enumerate(ranks):
            where = f'episode {ep} rank {r}'
            ts, m = res['states'][ep], res['metrics'][ep]
            assert_rings_equal(rank_ring(jts.buffer, r), ts.buffer, where)
            assert m.episode_length == float(jm.episode_length), where
            assert m.updates == int(jm.updates), where
            assert float(m.mean_reward) == float(jm.mean_reward), where
            assert float(ts.epsilon) == float(jts.epsilon), where
            assert ts.episode == int(jts.episode) == ep + 1
            assert ts.global_step == int(jts.global_step), where
            np.testing.assert_allclose(float(m.mean_loss),
                                       float(jm.mean_loss), rtol=1e-4,
                                       err_msg=where)
            if params:
                assert_params_close(jts.params, ts.params, hw, 1e-3, where)
            assert int(ts.opt_state.count) == int(jts.opt_state[1][0].count)
        a, b = (res['states'][ep] for res in ranks)
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), (ep, k)
            assert torch.equal(a.target_params[k], b.target_params[k])
        # the mean over ranks of their own episode lengths
        steps = [res['env_steps'][ep] for res in ranks]
        assert np.float32(sum(steps)) / np.float32(WORLD) == \
            float(jm.episode_length)


@pytest.mark.parametrize('mode', [
    dict(update_every=1), dict(update_every=2), dict(fused_act_update=True)],
    ids=['every-1', 'every-2', 'fused'])
def test_two_episodes_on_two_ranks_match_jax(tmp_path, mode):
    """8x8, 2 snakes, 4 global envs (2 a rank), 12 steps, batch 8, a ring
    of 24 a rank: two episodes, the second from a warm ring."""
    kwargs = dict(SMALL, num_envs=4, **mode)
    jax_runs, ranks, hw, _ = run_both(tmp_path, **kwargs)
    assert_matches(jax_runs, ranks, hw)
    assert sum(m.updates for m in ranks[0]['metrics']) > 0
    for res in ranks:
        assert int(res['states'][-1].buffer.size) > 0


# --- ReLU gates at a kink ---------------------------------------------------

def replay_with_port_gates(jtr, tr, start, ranks, hw):
    """Every TD update of the ranks' episode again in JAX, on the
    minibatches each rank recorded: (1) at the port's parameters, JAX's
    gradient with the port's ReLU gates, whose mean over the ranks must be
    the port's all-reduced gradient (``assert_grads_close``); (2) optax
    from ``start`` on those gradients, which must end within 1e-3 of the
    port's parameters. Returns the number of units whose gate JAX and the
    port set apart, and the largest |JAX pre-activation| among them."""
    recs = [res['record'] for res in ranks]
    params, opt = start.params, jtr.tx.init(start.params)
    flips, largest = 0, 0.0
    for k in range(len(recs[0]['args'])):
        grads = []
        for rec in recs:
            p, target, batch = rec['args'][k][:3]
            _, g, n, big = jax_grads_with_port_gates(
                jtr, dqn_to_flax(p, hw), dqn_to_flax(target, hw),
                tuple(jnp.asarray(x.numpy()) for x in batch),
                port_preacts(tr, p, batch[0]))
            grads.append(g)
            flips, largest = flips + n, max(largest, big)
        mean = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
        for rec in recs:
            assert_grads_close(mean, dict(zip(p, rec['reduced'][k][:-1])),
                               hw, f'update {k}')
        updates, opt = jtr.tx.update(mean, opt, params)
        params = optax.apply_updates(params, updates)
    assert_params_close(params, ranks[0]['states'][-1].params, hw, 1e-3,
                        'replayed with the port gates')
    return flips, largest


@pytest.mark.parametrize('seed,first,kinks', [(2, 1, False), (3, 0, True)],
                         ids=['seed-2', 'seed-3-relu-kink'])
def test_a_rank_that_finishes_first_stops_its_steps_and_every_update(
        tmp_path, seed, first, kinks):
    """16 steps at most, a ring warm after the first step: rank ``first``'s
    envs all finish before the other rank's. Its env steps stop there
    while the other steps on, no rank updates after it (JAX's ``pmin``),
    and both match JAX's episode, whose length is the mean of the two.

    Every update is then replayed in JAX (``replay_with_port_gates``): the
    all-reduced gradient is the mean of the two ranks' gradients as JAX
    computes them on the same minibatches at the same parameters, within
    1e-6 + 1e-5 x the largest magnitude, as
    ``test_td_update_loss_and_gradients_match_jax``, and optax on them ends
    within 1e-3 of the port's parameters. The replay takes the port's ReLU
    gate at a unit whose float32 pre-activation lies on the other side of
    zero in the port than in JAX; such a unit must be within 1e-6 of zero.
    Seed 3 has one: a conv3 unit of rank 1's first minibatch (three
    positions) at +7.5e-9 in XLA's float32 convolution and below zero in
    the port's. Its gate moves rank 1's first conv gradients, and since
    Adam's first step moves every entry by lr whatever its gradient's
    size, the parameters end up to 1.4e-3 from JAX's episode: they are
    held against the replay only. Seed 2 has one such unit too (6.1e-9 in
    JAX), whose effect stays within 1e-3, so its parameters are also held
    against JAX's episode."""
    kwargs = dict(SMALL, num_envs=4, max_steps_per_episode=16,
                  min_buffer_size=4, seed=seed)
    jax_runs, ranks, hw, start = run_both(tmp_path, episodes=1, calls=16,
                                          **kwargs)
    assert_matches(jax_runs, ranks, hw, params=not kinks)
    steps = [res['env_steps'][0] for res in ranks]
    updates = ranks[0]['metrics'][0].updates
    assert steps[first] < steps[1 - first], steps
    assert 0 < updates <= steps[first], (updates, steps)
    assert len(ranks[0]['record']['args']) == updates

    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as the ranks compute
    try:
        local = dict(kwargs, num_envs=kwargs['num_envs'] // WORLD)
        flips, largest = replay_with_port_gates(
            JTrainer(JConfig(**local)),
            DQNTrainer(DQNConfig(**local), device='cpu'), start, ranks, hw)
    finally:
        torch.set_num_threads(threads)
    if kinks:
        assert flips > 0, flips
    assert largest <= 1e-6, largest
