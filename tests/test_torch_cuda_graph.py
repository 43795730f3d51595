"""The port's captured loops (``marlsnake_torch/utils/cuda_graph.py``) on
the CPU, where each runs the body its graph captures on the card.

* the DQN chunk body against the JAX trainer's ``_episode_impl`` with the
  same draws, in episodes whose last env finishes inside a chunk and
  whose ring turns warm inside one: the ring, ``ptr``, ``size``, the
  episode length, the update count, the mean reward, epsilon,
  ``global_step`` and Adam's count EQUAL; the mean loss within 1e-4
  relative and the parameters within 1e-3 absolute, the tolerances of
  ``test_torch_dqn_trainer.py``;
* the chunk body against the data-parallel step loop at world 1 on gloo:
  every field EQUAL;
* the runner hands back copies: a state a caller holds does not change
  when the next episode or update runs over the same buffers;
* the PPO rollout through the runner against JAX's updates;
* the bench rollout through the runner against its loop: EQUAL;
* the launch counters over a captured-style run, with the kernel library
  stood in for by the plain version.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from marlsnake_torch import bench
from marlsnake_torch.algo import replay
from marlsnake_torch.algo.dqn_trainer import (DQNConfig, DQNTrainer,
                                              chunk_steps)
from marlsnake_torch.algo.flax_states import (ppo_train_state_from_flax,
                                              train_state_from_flax)
from marlsnake_torch.core import engine
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.parallel import distributed
from marlsnake_torch.parallel.mesh import make_mesh
from marlsnake_torch.rng import (ppo_draws, reset_draws, rollout_draws,
                                 train_draws)
from marlsnake_torch.utils import cuda_graph
from test_torch_dqn_trainer import (SMALL, assert_params_close,
                                    episode_draws, numpy_state, trainers)
from test_torch_engine import assert_fields_equal
from test_torch_parallel_cluster import assert_equal_trees
from test_torch_replay import assert_rings_equal
from test_torch_step_kernel import plain_library  # noqa: F401 (fixture)
import test_torch_ppo as P

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chunk_steps_divide_the_episode_and_hold_whole_update_groups():
    assert chunk_steps(256, 1) == 8 and chunk_steps(256, 4) == 8
    assert chunk_steps(12, 1) == 6 and chunk_steps(12, 2) == 6
    assert chunk_steps(9, 3) == 3 and chunk_steps(64, 2) == 8
    assert chunk_steps(16, 16) == 16 and chunk_steps(11, 1) == 1
    for t, every in ((256, 1), (256, 4), (12, 2), (96, 3), (40, 8)):
        k = chunk_steps(t, every)
        assert t % k == 0 and k % every == 0 and k <= max(8, every)


# --- the DQN chunk body against JAX ------------------------------------------

@pytest.mark.parametrize('mode', [
    dict(), dict(update_every=2), dict(fused_act_update=True)],
    ids=['every-1', 'every-2', 'fused'])
def test_chunk_body_matches_jax_when_episodes_end_inside_a_chunk(
        mode, monkeypatch):
    """Three episodes of SMALL at 3 envs, in chunks of 6 of the 12 steps:
    the ring turns warm inside the first chunk (at its second step), and
    an episode ends with its last env inside a chunk. The chunk body is
    what ``train_episode`` runs on one device."""
    kwargs = dict(SMALL, num_envs=3, **mode)
    jtr, tr = trainers(**kwargs)
    k = tr.chunk_steps
    assert k == 6
    sizes = []
    push = replay.push

    def recorded_push(buf, *args, **kwargs):
        out = push(buf, *args, **kwargs)
        sizes.append(int(buf.size))
        return out

    monkeypatch.setattr(replay, 'push', recorded_push)
    hw = (tr.env_cfg.obs_height, tr.env_cfg.obs_width)
    jts = jtr.init_state()
    ts = train_state_from_flax(numpy_state(jts), hw, 'cpu')
    ends_inside = 0
    for ep in range(3):
        reset, draws = episode_draws(jtr, jts, tr)
        jts, jm = jtr._train_episode(jts)
        sizes.clear()
        ts, m = tr.train_episode(ts, draws, reset)
        where = f'episode {ep}'
        assert_rings_equal(jts.buffer, ts.buffer, where)
        assert m.episode_length == float(jm.episode_length), where
        assert m.updates == int(jm.updates), where
        assert float(m.mean_reward) == float(jm.mean_reward), where
        assert float(ts.epsilon) == float(jts.epsilon), where
        assert ts.global_step == int(jts.global_step), where
        assert int(ts.opt_state.count) == int(jts.opt_state[1][0].count)
        np.testing.assert_allclose(float(m.mean_loss), float(jm.mean_loss),
                                   rtol=1e-4, err_msg=where)
        assert_params_close(jts.params, ts.params, hw, 1e-3, where)
        length = int(m.episode_length)
        ends_inside += length % k != 0 and length < 12
        # every step of every chunk run pushes (masked rows to the spare)
        assert len(sizes) == -(-length // k) * k, where
        if ep == 0:
            warm = next(i for i, n in enumerate(sizes)
                        if n >= tr.config.min_buffer_size)
            assert 0 < warm % k < k - 1, sizes
    assert ends_inside >= 1 and ts.global_step > 0
    assert len(tr.captured_loops()) == 1


def test_chunk_body_runs_uncaptured_as_it_runs_through_the_runner():
    cfg = DQNConfig(**dict(SMALL, num_envs=3))
    runs = []
    for plain in (False, True):
        tr = DQNTrainer(cfg, device='cpu')
        ts = tr.init_state()
        episode = tr.train_episode_plain if plain else tr.train_episode
        for _ in range(2):
            ts, m = episode(ts)
        runs.append((ts, m))
    assert_equal_trees(runs[0][0], runs[1][0], 'state')
    assert_equal_trees(runs[0][1], runs[1][1], 'metrics')


# --- the chunk body against the data-parallel loop at world 1 ----------------

@pytest.fixture
def world_one(tmp_path):
    distributed.initialize(f'file://{tmp_path}/rendezvous', 1, 0,
                           device='cpu')
    try:
        yield make_mesh(1, device='cpu')
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('mode', [
    dict(), dict(update_every=2), dict(fused_act_update=True)],
    ids=['every-1', 'every-2', 'fused'])
def test_chunk_body_equals_the_mesh_loop_at_world_one(world_one, mode):
    """The same draws through the chunk body and through the step loop of
    a world-1 mesh on gloo: every field of the state and the metrics
    EQUAL, over episodes that end inside a chunk."""
    cfg = DQNConfig(**dict(SMALL, num_envs=3, **mode))
    single = DQNTrainer(cfg, device='cpu')
    looped = DQNTrainer(cfg, mesh=world_one)
    ts, ts_loop = single.init_state(), looped.init_state()
    gen = torch.Generator().manual_seed(11)
    ecfg, lengths = single.env_cfg, []
    for ep in range(3):
        reset = reset_draws(ecfg, cfg.num_envs, gen, 'cpu')
        draws = train_draws(ecfg, cfg.num_envs, cfg.max_steps_per_episode,
                            cfg.buffer_size, cfg.batch_size, gen, 'cpu')
        ts, m = single.train_episode(ts, draws, reset)
        ts_loop, m_loop = looped.train_episode(ts_loop, draws, reset)
        assert_equal_trees(ts, ts_loop, f'episode {ep}')
        assert_equal_trees(m, m_loop, f'metrics {ep}')
        lengths.append(int(m.episode_length))
    assert ts.global_step > 0
    assert any(n % single.chunk_steps for n in lengths), lengths


# --- the runner's carry -------------------------------------------------------

def test_a_held_train_state_does_not_change_when_the_next_episode_runs():
    tr = DQNTrainer(DQNConfig(**dict(SMALL, num_envs=3)), device='cpu')
    ts, _ = tr.train_episode(tr.init_state())
    held = cuda_graph.clone_tree(ts)
    ts2, m = tr.train_episode(ts)
    assert m.updates > 0 and int(ts2.buffer.size) > 0
    assert_equal_trees(ts, held, 'held state')
    assert not torch.equal(ts2.params['fc3.weight'], ts.params['fc3.weight'])
    # the same state again gives the same episode
    ts3, _ = tr.train_episode(ts, *_same_draws(tr))
    ts4, _ = tr.train_episode(ts, *_same_draws(tr))
    assert_equal_trees(ts3, ts4, 'replayed from the held state')


def _same_draws(tr):
    gen = torch.Generator().manual_seed(3)
    cfg = tr.config
    reset = reset_draws(tr.env_cfg, cfg.num_envs, gen, 'cpu')
    draws = train_draws(tr.env_cfg, cfg.num_envs, cfg.max_steps_per_episode,
                        cfg.buffer_size, cfg.batch_size, gen, 'cpu')
    return draws, reset


def test_a_held_ppo_state_does_not_change_when_the_next_update_runs():
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    tr = PPOTrainer(PPOConfig(**P.SMALL), device='cpu')
    ts, _ = tr.update(tr.init_state())
    held = cuda_graph.clone_tree(ts)
    ts2, _ = tr.update(ts)
    assert_equal_trees(ts, held, 'held state')
    assert not torch.equal(ts2.obs, ts.obs)


# --- the PPO rollout through the runner --------------------------------------

def test_ppo_collect_through_the_runner_matches_jax():
    """Two updates of ``test_torch_ppo``'s SMALL: the trajectory, the envs,
    the obs and the done flags the rollout leaves EQUAL to JAX's; the
    trajectory lies in the trainer's buffers, written by the runner's
    body."""
    jtr, tr = P.trainers(**P.SMALL)
    jts = jtr.init_state()
    ts = ppo_train_state_from_flax(P.numpy_state(jts), 'cpu')
    for u in range(2):
        draws, rec, _, _ = P.replay_jax_rollout(jtr, jts, tr.env_cfg)
        jts, _ = jtr._update(jts)
        ts = tr.collect(ts, draws)
        bufs, loop = tr.rollout_loop()
        assert loop.device.type == 'cpu' and loop.graph is None
        for name in ('obs', 'action', 'reward', 'valid', 'next_done'):
            np.testing.assert_array_equal(
                getattr(tr.trajectory, name).numpy(), rec[name],
                err_msg=f'{name} update {u}')
        assert_fields_equal(jts.env_states, ts.env_states, f'update {u}')
        np.testing.assert_array_equal(np.asarray(jts.obs), ts.obs.numpy())
        np.testing.assert_array_equal(np.asarray(jts.agent_done),
                                      ts.agent_done.numpy())
        assert int(ts.episodes) == int(jts.episodes)
        ts, _ = tr.learn(ts, draws.perm)
        assert ts.update == int(jts.update) == u + 1
        P.assert_params_close(jts.params, ts.params, 1e-3, f'update {u}')


def test_ppo_collect_equals_its_plain_body():
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    tr = PPOTrainer(PPOConfig(**P.SMALL), device='cpu')
    ts = tr.init_state()
    gen = torch.Generator().manual_seed(4)
    cfg = tr.config
    draws = ppo_draws(tr.env_cfg, cfg.num_envs, cfg.rollout_steps,
                      cfg.update_epochs, gen, 'cpu')
    got = tr.collect(ts, draws)
    traj = cuda_graph.clone_tree(tr.trajectory)
    want = tr.collect_plain(ts, draws)
    assert_equal_trees(got, want, 'state')
    assert_equal_trees(traj, tr.trajectory, 'trajectory')


# --- the bench rollout through the runner ------------------------------------

@pytest.mark.parametrize('graph', [False, True], ids=['grid', 'rays'])
def test_bench_rollout_through_the_runner_equals_its_loop(graph):
    cfg = EnvConfig(height=8, width=8, num_snakes=2, snake_length=3)
    env = VectorSnakeEnv(cfg, 6, device='cpu', seed=1, graph=graph)
    states, _ = env.reset()
    gen = torch.Generator().manual_seed(2)
    loop = bench.Rollout(env, 12)
    for _ in range(2):
        actions, draws = rollout_draws(cfg, 6, 12, gen, 'cpu')
        got_states, got = loop(states, actions, draws)
        want_states, want = bench.rollout_plain(env, states, actions, draws)
        assert float(got) == float(want) and float(got) > 0
        assert_fields_equal(got_states, want_states, 'states')
        states = got_states


def test_rollout_draws_come_from_one_rand_in_contiguous_runs():
    cfg = EnvConfig(height=8, width=8, num_snakes=2, snake_length=3,
                    spawn_mode='procedural')
    gen = torch.Generator().manual_seed(5)
    actions, draws = rollout_draws(cfg, 4, 3, gen, 'cpu')
    assert actions.shape == (3, 4, 2) and actions.dtype == torch.int32
    shapes = [(3, 4, 2), (3, 4, 2, 4), (3, 4, cfg.resolved_num_fruits)]
    for x, shape in zip(draws, shapes):
        assert x.shape == shape and x[1].is_contiguous()
    # one storage: the three fields are runs of the same draw
    base = draws.fruit_u.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in draws)


# --- the replay ring in place -------------------------------------------------

def test_push_writes_ptr_and_size_in_place():
    buf = replay.create(8, (2, 2, 8), device='cpu')
    ptr, size = buf.ptr, buf.size
    obs = torch.ones((3, 2, 2, 8), dtype=torch.uint8)
    replay.push(buf, obs, torch.zeros(3), torch.ones(3), obs,
                torch.zeros(3, dtype=torch.bool),
                mask=torch.tensor([True, False, True]))
    assert buf.ptr is ptr and buf.size is size
    assert int(ptr) == 2 and int(size) == 2


# --- launch counters over a captured-style run -------------------------------

class _FakeGraph:
    """Replays a body the way a CUDA graph does, as far as the counters
    see: the launches run, the Python wrappers do not."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        before = {w: w.launches for w in cuda_graph.launch_counters()}
        self.body()
        for w, n in before.items():
            w.launches = n


def test_a_replay_adds_the_launches_its_graph_holds(plain_library,
                                                    monkeypatch):
    """Six held steps through the step entry's launch path, run as a
    captured loop: the first call runs uncaptured (counted), the capture
    counts nothing, and each of three replays adds the six launches its
    graph holds, so the counter equals the launches that ran; a tracked
    ``Counter`` that the body adds to is kept the same way."""
    monkeypatch.setattr(cuda_graph.CapturedLoop, '_warm_up',
                        lambda self: self.body())
    monkeypatch.setattr(cuda_graph.CapturedLoop, '_record',
                        lambda self: (self.body(), _FakeGraph(self.body),
                                      0.0, 0)[1:])
    cfg = EnvConfig(height=8, width=8, num_snakes=2, snake_length=3)
    b, k = 5, 6
    gen = torch.Generator().manual_seed(9)
    tables = engine.spawn_tables(cfg, 'cpu')
    state, _ = engine.reset(cfg, tables, reset_draws(cfg, b, gen, 'cpu'))
    plan = step_kernel._plan(cfg, b, torch.device('cpu'))
    zero_out = engine.StepOutput(*[torch.zeros(f.shape, dtype=f.dtype)
                                   for f in plan.fields[
                                       len(step_kernel.STATE_FIELDS):]])
    arena = plan.pack(state, zero_out)
    st = step_kernel._carved(step_kernel._CarvedState, plan, arena)
    out = step_kernel._carved(step_kernel._CarvedOutput, plan, arena)
    actions = torch.randint(0, 3, (b, 2), generator=gen, dtype=torch.int32)
    fruit_u = torch.rand((b, 2), generator=gen)
    keep = torch.tensor([False, True, False, False, True])

    steps = cuda_graph.track(cuda_graph.Counter('steps'))

    def body():
        s, o = st, out
        for _ in range(k):
            s, o = step_kernel.step(cfg, s, actions, fruit_u, hold=(keep, o))
            steps.launches += 1
        arena.copy_(s._arena)

    loop = cuda_graph.CapturedLoop(body, 'cuda')
    step_kernel.step.launches = 0
    calls = plain_library.calls
    loop()
    assert step_kernel.step.launches == k
    assert loop.tally.by_name() == {'step': k, 'steps': k}
    for replays in (1, 2, 3):
        loop()
        assert step_kernel.step.launches == k * (1 + replays)
        assert steps.launches == k * (1 + replays)
    assert loop.replays == 3
    # the stand-in ran the uncaptured call, the capture and the replays
    assert plain_library.calls - calls == k * 5
    with loop.tally.recording():
        step_kernel.step(cfg, st, actions, fruit_u, hold=(keep, out))
    assert step_kernel.step.launches == 4 * k
    assert loop.tally.by_name() == {'step': k + 1, 'steps': k}


def test_import_needs_no_nvcc_or_gpu():
    """The captured paths import, and run their bodies on the CPU, with no
    nvcc on the path and no CUDA toolkit: nothing is built or captured."""
    code = (
        'import torch\n'
        'from marlsnake_torch import bench\n'
        'from marlsnake_torch.algo.dqn_trainer import DQNConfig, '
        'DQNTrainer\n'
        'from marlsnake_torch.algo import ppo_trainer\n'
        'from marlsnake_torch.ops import step_kernel\n'
        'from marlsnake_torch.utils import cuda_graph\n'
        'tr = DQNTrainer(DQNConfig(height=8, width=8, num_snakes=2, '
        'num_envs=2, batch_size=8, buffer_size=24, min_buffer_size=8, '
        'max_steps_per_episode=8), device="cpu")\n'
        'tr.train_episode(tr.init_state())\n'
        'assert all(l.graph is None for l in tr.captured_loops())\n'
        'assert step_kernel.load_library.cache_info().currsize == 0\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_HOME='/nonexistent',
               PATH=os.path.dirname(sys.executable), CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run([sys.executable, '-c', code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
