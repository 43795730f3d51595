"""marlsnake_torch.parallel.ppo_dp against marlsnake_tpu.parallel.ppo_dp on
two ranks.

JAX's ``DistributedPPO`` runs in this process on a two-device mesh of the
virtual CPU devices, its update program built with ``shard_map``'s
``check_vma`` off (``jax_ppo_dp``; see ``test_torch_parallel_dqn.py``:
with it on, the devices' gradients are summed, not averaged). The port's
runs in two gloo ranks on the CPU (``parallel.runner``), from the same
per-rank states (``flax_states.dp_ppo_train_states_from_flax``), each rank
with its device's draws from JAX's key schedule (the rollout replayed per
device, ``test_torch_ppo.replay_jax_rollout`` with the axis index folded
in). Tolerances, as ``test_torch_ppo.test_two_updates_match_jax``: each
rank's env states, obs and done flags EQUAL (an action is exact while
``logits + gumbel`` has no near-tie: the smallest top-two gap is
asserted above 1e-4); the loss terms within 1e-4 relative (1e-6
absolute), the episode metrics within 1e-4 relative; parameters and Adam
moments within 1e-3 absolute after two updates; the two ranks'
parameters bit-equal.
"""

import jax
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from marlsnake_tpu.algo.ppo_trainer import PPOConfig as JConfig
from marlsnake_tpu.parallel import ppo_dp as jax_ppo_dp_module
from marlsnake_tpu.parallel.mesh import make_mesh as jax_mesh
from marlsnake_torch.algo.flax_states import dp_ppo_train_states_from_flax
from marlsnake_torch.algo.ppo_trainer import PPOConfig
from marlsnake_torch.parallel.runner import run_job
from test_torch_engine import assert_fields_equal
from test_torch_ppo import (EPISODE, LOSSES, SMALL, assert_params_close,
                            numpy_state, replay_jax_rollout)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

WORLD = 2


def jax_ppo_dp(config: JConfig):
    """JAX's DistributedPPO on two devices, its update program built with
    ``check_vma=False`` (ppo_dp.py:44-50 otherwise)."""
    jd = jax_ppo_dp_module.DistributedPPO(config, jax_mesh(WORLD))
    specs = jax_ppo_dp_module._state_specs(jax.eval_shape(
        jd._global_trainer.init_state, jax.random.key(0)))
    jd._update = jax.jit(jax.shard_map(
        jd.trainer._update_impl, mesh=jd.mesh, in_specs=(specs,),
        out_specs=(specs, P()), check_vma=False))
    return jd


def device_rows(jts, r, e):
    """Device r's view of the mesh-global JAX state: its rows of the env
    states, obs, done flags and return accumulators (keys kept typed)."""
    rows = slice(r * e, (r + 1) * e)
    return jts.replace(
        env_states=jax.tree.map(lambda x: x[rows], jts.env_states),
        obs=jts.obs[rows], agent_done=jts.agent_done[rows],
        ep_return_acc=jts.ep_return_acc[rows],
        params=jax.tree.map(np.asarray, jts.params))


def test_two_updates_on_two_ranks_match_jax(tmp_path):
    """8x8, 2 snakes of length 2, 4 global envs (2 a rank), 8 rollout
    steps, 2 minibatches, 2 epochs: two updates."""
    jd = jax_ppo_dp(JConfig(**SMALL))
    e = SMALL['num_envs'] // WORLD
    env_cfg = PPOConfig(**dict(SMALL, num_envs=e)).env_config()
    jts = jd.init_state()
    states = dp_ppo_train_states_from_flax(numpy_state(jts), WORLD, 'cpu')
    draws, jax_runs, min_gap = [], [], np.inf
    for _ in range(2):
        per_rank = []
        for r in range(WORLD):
            d, _, gap, _ = replay_jax_rollout(jd.trainer,
                                              device_rows(jts, r, e),
                                              env_cfg, axis_index=r)
            per_rank.append((d,))
            min_gap = min(min_gap, gap)
        draws.append(per_rank)
        jts, jm = jd.train_update(jts)
        jax_runs.append((numpy_state(jts), jm))
    ranks = [res[0] for res in run_job(
        {'device': 'cpu', 'backend': None, 'tasks': [
            {'kind': 'ppo', 'config': SMALL, 'updates': 2, 'states': states,
             'draws': draws, 'check': 0}]}, WORLD, str(tmp_path))]

    episodes = 0
    for u, (jts, jm) in enumerate(jax_runs):
        for r, res in enumerate(ranks):
            where = f'update {u} rank {r}'
            ts, m = res['states'][u], res['metrics'][u]
            local = device_rows(jts, r, e)
            assert_fields_equal(local.env_states, ts.env_states, where)
            np.testing.assert_array_equal(np.asarray(local.obs),
                                          ts.obs.numpy(), err_msg=where)
            np.testing.assert_array_equal(np.asarray(local.agent_done),
                                          ts.agent_done.numpy())
            np.testing.assert_allclose(ts.ep_return_acc.numpy(),
                                       np.asarray(local.ep_return_acc),
                                       atol=1e-5, err_msg=where)
            assert int(ts.episodes) == int(jts.episodes), where
            assert ts.update == int(jts.update) == u + 1
            for name in LOSSES:
                np.testing.assert_allclose(
                    float(getattr(m, name)), float(getattr(jm, name)),
                    rtol=1e-4, atol=1e-6, err_msg=f'{name} {where}')
            for name in EPISODE:
                np.testing.assert_allclose(
                    float(getattr(m, name)), float(getattr(jm, name)),
                    rtol=1e-4, atol=0, err_msg=f'{name} {where}')
            assert res['env_steps'][u] == SMALL['rollout_steps']
        a, b = (res['states'][u] for res in ranks)
        assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
        episodes += int(ranks[0]['metrics'][u].episodes_collected)
    assert min_gap > 1e-4 and episodes > 0
    ts = ranks[0]['states'][-1]
    assert_params_close(jts.params, ts.params, 1e-3, 'params')
    adam = jts.opt_state[1][0]
    assert int(ts.opt_state.count) == int(adam.count) == 8
    for name in ('mu', 'nu'):
        assert_params_close(getattr(adam, name), dict(zip(
            ts.params, getattr(ts.opt_state, name))), 1e-3, name)
