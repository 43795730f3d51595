"""marlsnake_torch.parallel: the mesh, world 1 against the single-device
trainers, the local cluster, the scaling harness and the collectives
audit, on the CPU with gloo.

Ranks of more than one process run through ``parallel.runner`` and
``distributed.launch_local_cluster`` (file rendezvous), and this file is
itself the program of the ranks that check the mesh (``mesh_rank``). A
world of one is
a gloo group of this process alone, made and ended by the ``world_one``
fixture; there, the data-parallel trainers must EQUAL the single-device
ones, since an all-reduce over one rank and a division by 1.0 change no
bit. Each test runs on one torch thread, as the ranks do.
"""

import dataclasses
import json
import sys

import pytest
import torch
import torch.distributed as dist

from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.parallel import distributed
from marlsnake_torch.parallel.dqn_dp import DistributedDQN
from marlsnake_torch.parallel.mesh import (Mesh, make_mesh, replicate,
                                           replicate_tree, shard_rows,
                                           shard_rows_tree)
from marlsnake_torch.parallel.ppo_dp import DistributedPPO
from marlsnake_torch.parallel.runner import run_job
from marlsnake_torch.rng import ppo_draws, reset_draws, step_draws, \
    train_draws

DQN_SMALL = dict(height=8, width=8, num_snakes=2, snake_length=3,
                 num_envs=4, max_steps_per_episode=12, batch_size=8,
                 buffer_size=24, min_buffer_size=8, epsilon_start=1.0)
PPO_SMALL = dict(height=8, width=8, num_snakes=2, snake_length=2,
                 num_envs=4, rollout_steps=8, num_minibatches=2,
                 update_epochs=2)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def world_one(tmp_path):
    distributed.initialize(f'file://{tmp_path}/rendezvous', 1, 0,
                           device='cpu')
    try:
        yield make_mesh(1, device='cpu')
    finally:
        dist.destroy_process_group()


def assert_equal_trees(a, b, where):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_equal_trees(getattr(a, f.name), getattr(b, f.name),
                               f'{where}.{f.name}')
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_equal_trees(a[k], b[k], f'{where}[{k}]')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_trees(x, y, f'{where}[{i}]')
    else:
        assert a == b, (where, a, b)


# --- the mesh ----------------------------------------------------------------

def test_mesh_of_one_process_needs_no_group():
    mesh = make_mesh(device='cpu')
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.device == torch.device('cpu')
    x = torch.arange(6).reshape(3, 2)
    rows, same = shard_rows(x, mesh), replicate(x, mesh)
    assert torch.equal(rows, x) and torch.equal(same, x)
    assert rows.data_ptr() != x.data_ptr() != same.data_ptr()
    assert mesh.mean([torch.ones(2), torch.full((1, 3), 3.0)])[1].shape \
        == (1, 3)
    with pytest.raises(ValueError, match='requested 2 devices, have 1'):
        make_mesh(2, device='cpu')
    with pytest.raises(ValueError, match='do not split'):
        shard_rows(torch.arange(3), Mesh(2, 0, torch.device('cpu')))


def test_mean_keeps_each_tensors_memory_layout():
    """Conv weight gradients come channels-last: the mean hands each one
    back in its own layout, so that the clip's norm sums it in the same
    order as without a mesh."""
    mesh = make_mesh(device='cpu')
    w = torch.randn(4, 3, 3, 3).to(memory_format=torch.channels_last)
    gap = torch.randn(5, 4)[:, :3]                  # not one run of memory
    out = mesh.mean([w, torch.randn(7), gap, torch.tensor(2.0)])
    assert out[0].stride() == w.stride() and torch.equal(out[0], w)
    assert out[2].is_contiguous() and torch.equal(out[2], gap)
    assert out[3].shape == () and float(out[3]) == 2.0


def test_world_one_group_mesh(world_one):
    assert (world_one.world, world_one.rank) == (1, 0)
    assert world_one.group is not None
    t = torch.tensor([3, -4], dtype=torch.int32)
    assert torch.equal(world_one.all_reduce(t.clone(), 'min'), t)
    mean = world_one.mean([torch.tensor([1.5, 2.5]), torch.tensor(7.0)])
    assert mean[0].tolist() == [1.5, 2.5] and float(mean[1]) == 7.0
    flags = torch.tensor([True, False])
    assert torch.equal(replicate(flags, world_one), flags)


# --- world 1 against the single-device trainers ------------------------------

def test_world_one_dqn_equals_the_single_device_trainer(world_one):
    """Two episodes at the same draws: parameters, target parameters,
    Adam state, the ring, epsilon and the metrics EQUAL."""
    ddqn = DistributedDQN(DQNConfig(**DQN_SMALL), world_one)
    single = DQNTrainer(DQNConfig(**DQN_SMALL), device='cpu')
    ts_dp, ts = ddqn.init_state(), single.init_state()
    assert_equal_trees(ts_dp, ts, 'init')
    gen = torch.Generator().manual_seed(5)
    cfg, ecfg = single.config, single.env_cfg
    for ep in range(2):
        reset = reset_draws(ecfg, cfg.num_envs, gen, 'cpu')
        draws = train_draws(ecfg, cfg.num_envs, cfg.max_steps_per_episode,
                            cfg.buffer_size, cfg.batch_size, gen, 'cpu')
        ts_dp, m_dp = ddqn.train_episode(ts_dp, draws, reset)
        ts, m = single.train_episode(ts, draws, reset)
        assert_equal_trees(ts_dp, ts, f'episode {ep}')
        assert_equal_trees(m_dp, m, f'metrics {ep}')
    assert ts.global_step > 0


def test_world_one_ppo_equals_the_single_device_trainer(world_one):
    """The same reset from the seed, then two updates at the same draws:
    every state field and metric EQUAL."""
    dppo = DistributedPPO(PPOConfig(**PPO_SMALL), world_one)
    single = PPOTrainer(PPOConfig(**PPO_SMALL), device='cpu')
    ts_dp, ts = dppo.init_state(), single.init_state()
    assert_equal_trees(ts_dp, ts, 'init')
    gen = torch.Generator().manual_seed(6)
    cfg = single.config
    for u in range(2):
        draws = ppo_draws(single.env_cfg, cfg.num_envs, cfg.rollout_steps,
                          cfg.update_epochs, gen, 'cpu')
        ts_dp, m_dp = dppo.train_update(ts_dp, draws)
        ts, m = single.update(ts, draws)
        assert_equal_trees(ts_dp, ts, f'update {u}')
        assert_equal_trees(m_dp, m, f'metrics {u}')


def test_rank_checkpoint_carries_both_generators(world_one, tmp_path):
    """A data-parallel rank draws its resets and its steps from two
    generators (``rng.rank_seed``); a full checkpoint carries both, so the
    next episode with the rank's own draws repeats after a resume."""
    cfg = dict(DQN_SMALL, save_dir=str(tmp_path))
    a = DistributedDQN(DQNConfig(**cfg), world_one).trainer
    b = DistributedDQN(DQNConfig(**dict(cfg, seed=9)), world_one).trainer
    assert a.reset_generator is not a.generator
    ts, _ = a.train_episode(a.init_state())
    a.save_checkpoint(ts, 'rank', full=True)
    ts_b, _ = b.load_checkpoint('rank', b.init_state(), full=True)
    ts, m = a.train_episode(ts)
    ts_b, m_b = b.train_episode(ts_b)
    assert_equal_trees(ts_b, ts, 'resumed')
    assert_equal_trees(m_b, m, 'resumed metrics')


def test_global_env_count_must_split_over_the_ranks():
    mesh = Mesh(3, 0, torch.device('cpu'))
    with pytest.raises(ValueError, match='not divisible'):
        DistributedDQN(DQNConfig(**DQN_SMALL), mesh)
    with pytest.raises(ValueError, match='not divisible'):
        DistributedPPO(PPOConfig(**PPO_SMALL), mesh)


# --- two ranks: the cluster, the mesh, scaling and the audit -----------------

def test_local_cluster_of_two_ranks_agrees():
    results = distributed.launch_local_cluster(2, device='cpu')
    assert sorted(r['process_id'] for r in results) == [0, 1]
    assert all(r['num_processes'] == 2 and r['updates'] > 0
               for r in results)
    assert len({r['param_digest'] for r in results}) == 1
    assert len({r['mean_reward'] for r in results}) == 1


def test_mp_worker_is_one_rank_of_the_local_cluster(tmp_path):
    """``mp_worker`` ranks print, as JSON lines, what
    ``launch_local_cluster`` returns for the same episode."""
    rendezvous = f'file://{tmp_path}/rendezvous'
    outputs = distributed.run_ranks(
        [('-m', 'marlsnake_torch.parallel.mp_worker', r, 2, rendezvous,
          'cpu', 'gloo') for r in range(2)], timeout=120)
    printed = [json.loads(out.splitlines()[-1]) for out in outputs]
    assert printed == distributed.launch_local_cluster(2, device='cpu')


def mesh_rank(rank: int, world: int, rendezvous: str, out: str) -> None:
    """One rank of the mesh check (this file run as a program):
    ``shard_rows`` of ``arange(6)`` and ``replicate`` of values that
    differ by rank, alone and in a tree, saved to ``out``."""
    torch.set_num_threads(1)
    distributed.initialize(rendezvous, world, rank, device='cpu')
    try:
        mesh = make_mesh(world, device='cpu')
        values = torch.arange(6)
        mine = torch.full((3,), float(rank))
        flags = torch.tensor([rank == 0, rank == 1])
        torch.save({'world': mesh.world, 'rows': shard_rows(values, mesh),
                    'replicated': replicate(mine, mesh),
                    'replicated_bool': replicate(flags, mesh),
                    'rows_tree': shard_rows_tree(
                        {'a': values, 'b': (values * 2,)}, mesh),
                    'replicated_tree': replicate_tree([mine, 7], mesh)},
                   out)
    finally:
        dist.destroy_process_group()


def test_two_ranks_mesh_scaling_and_collective_counts(tmp_path):
    """Two ranks: ``shard_rows`` and ``replicate`` alone and in a tree
    (``mesh_rank``); then one job of the scaling harness (positive rates,
    emulated on the CPU) and of the collectives of one DQN episode and
    one PPO update, from a profiler window. A DQN episode all-reduces
    once before its first step, once a loop step (until no env of any
    rank is live), once an update and twice for its metrics; a PPO update
    once a minibatch and twice for its counters."""
    rendezvous = f'file://{tmp_path}/rendezvous'
    outs = [str(tmp_path / f'mesh{r}.pt') for r in range(2)]
    distributed.run_ranks([(__file__, r, 2, rendezvous, outs[r])
                           for r in range(2)], timeout=120)
    ranks = run_job({'device': 'cpu', 'backend': None, 'tasks': [
        {'kind': 'scaling', 'env': dict(height=8, width=8, num_snakes=2,
                                        snake_length=2),
         'envs_per_device': 8, 'num_steps': 4},
        {'kind': 'dqn', 'config': DQN_SMALL, 'episodes': 1,
         'profile': True, 'check': 0},
        {'kind': 'ppo', 'config': PPO_SMALL, 'updates': 1,
         'profile': True}]}, 2, str(tmp_path))
    for r, (scaling, dqn, ppo) in enumerate(ranks):
        mesh = torch.load(outs[r], weights_only=False)
        assert mesh['world'] == 2
        assert mesh['rows'].tolist() == [3 * r, 3 * r + 1, 3 * r + 2]
        assert mesh['rows_tree']['b'][0].tolist() == [6 * r, 6 * r + 2,
                                                      6 * r + 4]
        assert mesh['replicated'].tolist() == [0.0] * 3
        assert mesh['replicated_bool'].tolist() == [True, False]
        assert mesh['replicated_tree'][1] == 7
        step, scale = scaling['step_time'], scaling['scaling']
        assert step['devices'] == scale['devices'] == 2
        assert step['emulated'] and scale['emulated']
        assert step['unsharded_ms_per_step'] > 0
        assert step['sharded_ms_per_step'] > 0
        assert scale['single'] > 0 and scale['full'] > 0
        assert scale['efficiency'] > 0
        loops = max(res['env_steps'][0] for res in (ranks[0][1],
                                                    ranks[1][1]))
        updates = dqn['metrics'][0].updates
        assert updates > 0
        assert dqn['collectives'] == {'all-reduce': 1 + loops + updates + 2}
        assert ppo['collectives'] == {'all-reduce': 2 * 2 + 2}
        assert ppo['collective_times']['host_us'] > 0
        assert ppo['collective_times']['gloo_us'] > 0
    assert ranks[0][0] == ranks[1][0]      # both ranks report alike


def test_a_plain_rollout_issues_no_collective():
    from torch.profiler import ProfilerActivity, profile
    cfg = EnvConfig(height=8, width=8, num_snakes=2, snake_length=2)
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=True, device='cpu')
    gen = torch.Generator().manual_seed(0)
    states, _ = reset_fn(reset_draws(cfg, 4, gen, 'cpu'))
    acts = torch.zeros((4, 2), dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            states, _ = step_fn(states, acts, step_draws(cfg, 4, gen, 'cpu'))
    assert distributed.collective_counts(prof) == {}
    assert distributed.collective_times(prof) == {
        'device_us': 0.0, 'host_us': 0.0, 'gloo_us': 0.0}


if __name__ == '__main__':
    mesh_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
