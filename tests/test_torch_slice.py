"""The port as a whole: the acting rollout (auto-reset step, obs encode,
greedy DQN) against the JAX package, the import boundary and default
device of every module, and CPU smokes of its bench (rollout and
training rows)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_torch import bench
from marlsnake_torch.algo import replay
from marlsnake_torch.algo.acting import select_actions
from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
from marlsnake_torch.algo.dqn_trainer import main as dqn_trainer_main
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.env import make_env
from marlsnake_torch.envs.vector import VectorSnakeEnv, build_vector_fns
from marlsnake_torch.models.dqn import DQN, make_dqn
from marlsnake_torch.models.weights import (dqn_from_flax,
                                            train_state_from_flax)
from test_torch_engine import (assert_fields_equal, configs, jax_reset,
                               jax_spawn, jax_step_autoreset,
                               reset_draws_from_keys, step_draws_from_keys)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_greedy_acting_rollout_matches_jax():
    """10x10, 2 snakes, 4 envs, 8 steps: the flax DQN's greedy actions
    drive both envs; every env field is compared each step, and the
    port's greedy choice equals JAX's wherever the top-two Q gap is
    above 1e-4."""
    b, hw = 4, (10, 10)
    jcfg, cfg = configs(height=10, width=10, num_snakes=2, snake_length=3)
    params = FlaxDQN(num_actions=3).init(
        jax.random.key(0), jnp.zeros((1,) + hw + (8,), jnp.float32))
    fnet = FlaxDQN(num_actions=3, assume_binary_obs=True)
    net = DQN(hw, 8, 3, assume_binary_obs=True, device='cpu')
    net.load_state_dict(dqn_from_flax(params, hw))
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=True, device='cpu')

    keys = jax.random.split(jax.random.key(11), b)
    jstate, jobs = jax_reset(jcfg, jax_spawn(jcfg), keys)
    state, obs = reset_fn(reset_draws_from_keys(cfg, keys))
    jstep = jax_step_autoreset(jcfg)
    jdone = np.zeros((b, 2), bool)
    gen = torch.Generator().manual_seed(0)
    checked = 0
    for t in range(8):
        np.testing.assert_array_equal(np.asarray(jobs), obs.numpy())
        qj = np.asarray(fnet.apply(params, np.asarray(jobs).reshape(
            (b * 2,) + hw + (8,)))).reshape(b, 2, 3)
        jact = np.where(jdone, 0, qj.argmax(-1)).astype(np.int32)
        tact = select_actions(net, obs, torch.as_tensor(jdone), 0.0, gen, 3)
        top2 = np.sort(qj, -1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-4
        np.testing.assert_array_equal(tact.numpy()[clear], jact[clear])
        checked += int(clear.sum())

        draws = step_draws_from_keys(cfg, jstate.key)
        jstate, jout = jstep(jstate, jnp.asarray(jact))
        state, out = step_fn(state, torch.as_tensor(jact), draws)
        assert_fields_equal(jstate, state, f'state t={t}')
        assert_fields_equal(jout, out, f'out t={t}')
        jobs, obs = jout.obs, out.obs
        jdone = np.array(jout.done)
    assert checked > 0


def test_port_imports_no_jax():
    code = ('import marlsnake_torch, marlsnake_torch.envs.vector, '
            'marlsnake_torch.envs.env, marlsnake_torch.models.dqn, '
            'marlsnake_torch.models.weights, marlsnake_torch.algo.acting, '
            'marlsnake_torch.ops.step_kernel, marlsnake_torch.bench, '
            'marlsnake_torch.ops.obs_pack, marlsnake_torch.ops.rays, '
            'marlsnake_torch.envs.graph, '
            'marlsnake_torch.algo.replay, marlsnake_torch.algo.optim, '
            'marlsnake_torch.algo.dqn_trainer, '
            'marlsnake_torch.models.ppo, marlsnake_torch.algo.ppo_trainer, '
            'marlsnake_torch.ops.floodfill, marlsnake_torch.algo.evaluator, '
            'marlsnake_torch.rng, '
            'marlsnake_torch.utils.checkpoint, marlsnake_torch.utils.metrics; '
            'import sys; bad = [m for m in sys.modules if m.split(".")[0] '
            'in ("jax", "jaxlib", "flax", "optax", "orbax", "marlsnake_tpu")]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid here')
    from marlsnake_torch.algo.evaluator import evaluate_batch
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    from marlsnake_torch.algo.ppo_trainer import main as ppo_trainer_main
    from marlsnake_torch.models.ppo import make_actor_critic
    cfg = EnvConfig(height=10, width=10, num_snakes=2)
    net = make_dqn(cfg, device='cpu')
    for build in (lambda: PPOTrainer(PPOConfig()),
                  lambda: make_actor_critic(cfg),
                  lambda: evaluate_batch(net, None, cfg, 2, 2),
                  lambda: bench.main(['--mode', 'ppo']),
                  lambda: bench.run_ppo(2, updates=1),
                  lambda: ppo_trainer_main(['--updates', '1', '--no-log']),
                  lambda: VectorSnakeEnv(cfg, 2), lambda: make_env(cfg),
                  lambda: make_dqn(cfg), lambda: bench.run(4, 2, 1),
                  lambda: DQNTrainer(DQNConfig()),
                  lambda: replay.create(16, (4, 4, 8)),
                  lambda: bench.run_train(2, episodes=1),
                  lambda: bench.main(['--mode', 'train']),
                  lambda: dqn_trainer_main(['--episodes', '1', '--no-log']),
                  lambda: train_state_from_flax(None, (8, 8))):
        with pytest.raises(RuntimeError, match='CUDA'):
            build()


def test_single_env_episode_on_cpu():
    env = make_env(height=10, width=10, num_snakes=2, snake_length=3,
                   device='cpu', seed=3)
    state, obs = env.reset()
    assert obs.shape == (2, 10, 10, 8) and obs.dtype == torch.uint8
    gen = torch.Generator().manual_seed(3)
    for _ in range(200):
        state, out = env.step(state, torch.randint(0, 3, (2,),
                                                   generator=gen))
        assert out.reward.shape == (2,) and out.obs.shape == (2, 10, 10, 8)
        if bool(out.done_all):
            break
    assert bool(out.done_all) and bool(out.done.all())
    assert sorted(out.rank.tolist())[0] == 1


def test_bench_cpu_smoke(capsys):
    bench.main(['--device', 'cpu', '--num-envs', '4', '--num-steps', '3',
                '--iters', '1'])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec['device'] == 'cpu' and rec['unit'] == 'env-steps/s'
    # the JAX bench's default configuration
    assert rec['value'] > 0 and rec['spawn_mode'] == 'procedural'
    assert rec['obs_format'] == 'uint8' and not rec['graph']


@pytest.mark.parametrize('flags,want', [
    (['--spawn-mode', 'pool'], dict(spawn_mode='pool')),
    (['--obs-format', 'packed', '--frame-stack', '2'],
     dict(obs_format='packed', frame_stack=2)),
    (['--vision-range', '3'], dict(vision_range=3)),
    (['--graph'], dict(graph=True))],
    ids=['pool', 'packed-stack2', 'vision3', 'graph'])
def test_bench_options_cpu_smoke(capsys, flags, want):
    bench.main(['--device', 'cpu', '--num-envs', '4', '--num-steps', '3',
                '--iters', '1'] + flags)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec['value'] > 0 and rec['device'] == 'cpu'
    assert {k: rec[k] for k in want} == want


def test_graph_rollout_on_the_cpu_through_the_step_wrapper():
    """The graph env's step is the step wrapper, then the rays of the
    state it returned: on CPU tensors no launch, and obs of (B, N, 5, C)."""
    from marlsnake_torch.ops import rays, step_kernel
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3,
                    spawn_mode='procedural', vision_range=3)
    env = VectorSnakeEnv(cfg, 5, device='cpu', seed=4, graph=True)
    plain = VectorSnakeEnv(cfg, 5, device='cpu', seed=4)
    state, obs = env.reset()
    pstate, _ = plain.reset()
    before = step_kernel.step_autoreset.launches
    gen = torch.Generator().manual_seed(4)
    for _ in range(12):
        actions = torch.randint(0, 3, (5, 2), generator=gen)
        state, out = env.step(state, actions)
        pstate, pout = plain.step(pstate, actions)
        assert torch.equal(out.obs, rays.ray_features(
            cfg, pout.obs, pstate.head, pstate.direction, pstate.alive))
        assert torch.equal(out.reward, pout.reward)
    assert out.obs.shape == (5, 2, 5, 8) and out.obs.dtype == torch.float32
    assert step_kernel.step_autoreset.launches == before


def test_packed_training_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The trainer's command line with packed, stacked obs: two episodes,
    and the checkpoint's meta file names the obs format."""
    monkeypatch.chdir(tmp_path)
    dqn_trainer_main(['--device', 'cpu', '--episodes', '2', '--no-log',
                      '--height', '8', '--width', '8', '--num-snakes', '2',
                      '--num-envs', '2', '--obs-format', 'packed',
                      '--frame-stack', '2'])
    assert 'Ep     2 | Mean Reward' in capsys.readouterr().out
    meta = json.loads((tmp_path / 'checkpoints'
                       / 'shared_model_final.meta.json').read_text())
    assert meta == {'obs_pad_channels': 0, 'obs_format': 'packed'}


def test_train_bench_cpu_smoke():
    """The ``--mode train`` row at a toy size on the CPU: it times whole
    episodes and says which device ran them."""
    rec = bench.run_train(2, update_every=2, episodes=1, device='cpu',
                          max_steps_per_episode=8, height=8, width=8, num_snakes=2,
                          batch_size=8, buffer_size=64, min_buffer_size=8)
    assert rec['device'] == 'cpu' and rec['num_envs'] == 2
    assert rec['update_every'] == 2 and rec['update_batch_size'] == 8
    assert rec['episode_ms'] > 0 and rec['env_steps_per_s'] > 0
    assert 1 <= rec['steps_per_episode'] <= 8
    json.dumps(rec)


def test_ppo_bench_cpu_smoke():
    """The ``--mode ppo`` row at a toy size on the CPU: it times the
    rollout and the minibatch epochs apart and names the device."""
    rec = bench.run_ppo(2, updates=1, device='cpu', height=8, width=8,
                        num_snakes=2, snake_length=2, rollout_steps=4)
    assert rec['device'] == 'cpu' and rec['num_envs'] == 2
    assert rec['samples'] == 16 and rec['minibatch'] == 4
    assert rec['rollout_ms'] > 0 and rec['minibatch_ms'] > 0
    assert rec['ms_per_update'] == pytest.approx(rec['rollout_ms']
                                                 + rec['minibatch_ms'])
    assert rec['env_steps_per_s'] > 0
    json.dumps(rec)


def test_ppo_and_evaluator_on_cpu_go_through_the_step_wrappers(monkeypatch):
    """On CPU tensors the PPO rollout steps through the auto-reset
    wrapper once a step and the evaluator through the step wrapper with
    its hold, each running its plain version: no launch."""
    from marlsnake_torch.algo.evaluator import build_evaluate_batch
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    from marlsnake_torch.ops import step_kernel
    calls = {'auto': 0, 'step': 0, 'held': 0}
    auto, step = step_kernel.step_autoreset, step_kernel.step

    def counting_auto(*args):
        calls['auto'] += 1
        return auto(*args)

    def counting_step(cfg, state, actions, fruit_u, hold=None):
        calls['step'] += 1
        calls['held'] += hold is not None
        return step(cfg, state, actions, fruit_u, hold)

    monkeypatch.setattr(step_kernel, 'step_autoreset', counting_auto)
    monkeypatch.setattr(step_kernel, 'step', counting_step)
    before = (auto.launches, step.launches)
    tr = PPOTrainer(PPOConfig(height=8, width=8, num_snakes=2,
                              snake_length=2, num_envs=3, rollout_steps=5,
                              update_epochs=1, num_minibatches=2),
                    device='cpu')
    tr.update(tr.init_state())
    assert calls['auto'] == 5
    cfg = EnvConfig(height=8, width=8, num_snakes=2)
    run = build_evaluate_batch(make_dqn(cfg, device='cpu'), cfg, 3, 6,
                               device='cpu')
    result = run()
    # whole chunks, each step with its hold (of no env at the first)
    k = run.chunk_steps
    assert calls['step'] == -(-result.steps // k) * k == calls['held']
    assert (auto.launches, step.launches) == before
