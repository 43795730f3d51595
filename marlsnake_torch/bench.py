"""Env-steps per second of the auto-reset rollout, the twin of ``bench.py``.

4096 envs of 20x20 with 4 snakes of length 3, procedural spawn (as the
JAX bench; ``--spawn-mode pool`` for the host-made pool), uniform random
actions; each step's obs is consumed by a checksum, so the whole obs
pipeline is in the measurement. ``--obs-format packed``, ``--frame-stack``
and ``--vision-range`` choose the obs, and ``--graph`` the ray-feature
env. Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"median", "spawn_mode", "obs_format", "frame_stack", "vision_range",
"graph", "device"}``; ``value`` is the best of three timed blocks and
``median`` their median. The rollout of ``--num-steps`` steps is one
replay of a captured CUDA graph (``Rollout``; ``utils/cuda_graph.py``),
its random actions and step draws drawn before it from the bench's
generator (``rng.rollout_draws``), so no per-step Python dispatch is in
the measurement, as the JAX bench's jitted scan keeps it out. Run
``python -m marlsnake_torch.bench`` on the GPU; pass ``--device cpu``
(and small sizes) to run the same body uncaptured on the CPU.

``--mode train`` times DQN training instead: milliseconds per episode and
env-steps/s of ``DQNTrainer.train_episode`` at 32 and 256 envs (20x20, 4
snakes of length 3, 256-step episodes, batch 512, ring of 10,000), for
``update_every`` 1 and 4, after one warm-up episode; one JSON line per
row, each with the device. The obs options apply there too; the trainer
spawns from the pool.

``--mode ppo`` times PPO updates: milliseconds per update of
``PPOTrainer`` with the rollout (and its GAE) and the minibatch epochs
apart, and env-steps/s, at the JAX package's default configuration (64
envs of 20x20 with 4 snakes of length 5, 128 rollout steps, 4 epochs of 4
minibatches) and the showcase run's (the same at 256 envs: 131,072 samples
an update, minibatches of 32,768), three timed updates after one
warm-up update.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.ops.step_kernel import StaticEnvs
from marlsnake_torch.rng import StepDraws, ppo_draws, rollout_draws
from marlsnake_torch.utils.cuda_graph import CapturedLoop, copy_into

BASELINE_STEPS_PER_SEC = 783.0  # reference single env on one CPU core


def rollout_plain(env: VectorSnakeEnv, states, actions: torch.Tensor,
                  draws: StepDraws):
    """The rollout's body: a step of every env per row of ``actions``
    (T, E, N) and ``draws`` (step axis first); returns (states, a checksum
    of every reward and obs byte)."""
    rew = torch.zeros((), dtype=torch.float32, device=env.device)
    # uint8 obs sum in uint8 (wrapping); ray features are float32
    check = torch.zeros((), device=env.device,
                        dtype=torch.float32 if env.graph else torch.uint8)
    for t in range(actions.shape[0]):
        states, out = env.step(states, actions[t],
                               StepDraws(*(x[t] for x in draws)))
        rew += out.reward.sum()
        check += out.obs.sum(dtype=check.dtype)
    return states, rew + check.to(torch.float32)


class Rollout:
    """``rollout_plain`` over ``num_steps`` steps of ``env`` as one
    captured CUDA graph (``utils/cuda_graph.py``; on the CPU the body runs
    directly): the caller's state, actions and draws are copied into the
    graph's buffers, and the state comes back as a copy."""

    def __init__(self, env: VectorSnakeEnv, num_steps: int):
        self.env = env
        self.envs = StaticEnvs(env.cfg, env.num_envs, env.device)
        self.actions, self.draws = rollout_draws(
            env.cfg, env.num_envs, num_steps,
            torch.Generator(device=env.device).manual_seed(0), env.device)
        self.checksum = torch.zeros((), dtype=torch.float32,
                                    device=env.device)
        self.loop = CapturedLoop(self._body, env.device)

    def _body(self) -> None:
        states, check = rollout_plain(self.env, self.envs.state,
                                      self.actions, self.draws)
        self.envs.store(states)
        self.checksum.copy_(check)

    def __call__(self, states, actions: torch.Tensor, draws: StepDraws,
                 captured: bool = True):
        """(states, checksum) after the steps of ``actions`` and
        ``draws``; ``captured=False`` runs the body uncaptured."""
        self.envs.load(states)
        self.actions.copy_(actions)
        copy_into(self.draws, draws)
        (self.loop if captured else self.loop.uncaptured)()
        return self.envs.clone()[0], self.checksum.clone()

    def random(self, states, generator: torch.Generator,
               captured: bool = True):
        """The steps with uniform random actions, the actions and draws
        taken from ``generator`` first (``rng.rollout_draws``)."""
        env = self.env
        actions, draws = rollout_draws(env.cfg, env.num_envs,
                                       self.actions.shape[0], generator,
                                       env.device)
        return self(states, actions, draws, captured)


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(num_envs: int = 4096, num_steps: int = 256, iters: int = 4,
        device='cuda', seed: int = 0, spawn_mode: str = 'procedural',
        obs_format: str = 'uint8', frame_stack: int = 1,
        vision_range=None, graph: bool = False,
        captured: bool = True) -> dict:
    """The rollout row; ``captured=False`` times the rollout's body
    uncaptured, the graph's plain version."""
    cfg = EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
                    spawn_mode=spawn_mode, obs_format=obs_format,
                    frame_stack=frame_stack, vision_range=vision_range)
    env = VectorSnakeEnv(cfg, num_envs, device=device, seed=seed,
                         graph=graph)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed + 1)
    states, _ = env.reset()
    loop = Rollout(env, num_steps)
    # warm-up: the build, and the graph's capture
    states, r = loop.random(states, gen, captured)
    float(r)
    dts = []
    for _ in range(3):
        _sync(env.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            states, r = loop.random(states, gen, captured)
        float(r)
        dts.append(time.perf_counter() - t0)
    total = num_envs * num_steps * iters
    best = total / min(dts)
    return {
        'metric': f'env-steps/s at {num_envs} parallel envs '
                  '(20x20, 4 snakes)',
        'value': best,
        'unit': 'env-steps/s',
        'vs_baseline': best / BASELINE_STEPS_PER_SEC,
        'median': total / sorted(dts)[1],
        'spawn_mode': cfg.spawn_mode,
        'obs_format': cfg.obs_format,
        'frame_stack': cfg.frame_stack,
        'vision_range': cfg.vision_range,
        'graph': graph,
        'captured': captured,
        'device': _device_name(env.device),
    }


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')


def run_train(num_envs: int, update_every: int = 1, episodes: int = 3,
              device='cuda', captured: bool = True, **config) -> dict:
    """Mean wall time of ``episodes`` training episodes after one warm-up
    episode (which also fills the ring and captures the chunk's graph).
    Episodes end when their last env does, so ``steps_per_episode`` says
    how long they were, and ``steps_run_per_episode`` how many steps their
    chunks ran. ``captured=False`` times ``train_episode_plain``, the
    chunks uncaptured. ``config`` overrides fields of the ``DQNConfig``
    (a small board for a CPU run)."""
    from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
    cfg = DQNConfig(**{**dict(
        height=20, width=20, num_snakes=4, snake_length=3,
        num_envs=num_envs, max_steps_per_episode=256, batch_size=512,
        min_buffer_size=512 * 3, buffer_size=10_000,
        update_every=update_every), **config})
    trainer = DQNTrainer(cfg, device=device)
    episode = (trainer.train_episode if captured
               else trainer.train_episode_plain)
    ts, m = episode(trainer.init_state())
    _sync(trainer.device)
    steps = updates = steps_run = 0
    k = trainer.chunk_steps
    t0 = time.perf_counter()
    for _ in range(episodes):
        ts, m = episode(ts)
        steps += m.episode_length
        steps_run += -(-int(m.episode_length) // k) * k
        updates += m.updates
    _sync(trainer.device)
    dt = (time.perf_counter() - t0) / episodes
    return {
        'metric': f'DQN training episode ({cfg.height}x{cfg.width}, '
                  f'{cfg.num_snakes} snakes)',
        'num_envs': num_envs, 'update_every': update_every,
        'update_batch_size': trainer.update_batch,
        'episode_ms': dt * 1e3,
        'ms_per_step': dt * 1e3 * episodes / steps,
        'env_steps_per_s': num_envs * steps / episodes / dt,
        'steps_per_episode': steps / episodes,
        'chunk_steps': k, 'steps_run_per_episode': steps_run / episodes,
        'captured': captured,
        'updates_per_episode': updates / episodes,
        'obs_format': cfg.obs_format, 'frame_stack': cfg.frame_stack,
        'vision_range': cfg.vision_range,
        'device': _device_name(trainer.device),
    }


def run_ppo(num_envs: int, updates: int = 3, device='cuda',
            captured: bool = True, **config) -> dict:
    """Mean wall times of ``updates`` PPO updates after one warm-up
    update (which also captures the rollout's graph), each split at a
    synchronisation into the rollout with its GAE (``collect``) and the
    minibatch epochs (``learn``). ``captured=False`` times
    ``collect_plain``, the rollout uncaptured. ``config`` overrides fields
    of the ``PPOConfig``."""
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    cfg = PPOConfig(**{**dict(num_envs=num_envs), **config})
    trainer = PPOTrainer(cfg, device=device)
    collect = trainer.collect if captured else trainer.collect_plain
    ts = trainer.init_state()
    draws = ppo_draws(trainer.env_cfg, cfg.num_envs, cfg.rollout_steps,
                      cfg.update_epochs, trainer.generator, trainer.device)
    ts, m = trainer.learn(collect(ts, draws), draws.perm)
    float(m.loss_value)
    rollout_s = learn_s = 0.0
    for _ in range(updates):
        draws = ppo_draws(trainer.env_cfg, cfg.num_envs, cfg.rollout_steps,
                          cfg.update_epochs, trainer.generator,
                          trainer.device)
        _sync(trainer.device)
        t0 = time.perf_counter()
        ts = collect(ts, draws)
        _sync(trainer.device)
        t1 = time.perf_counter()
        ts, m = trainer.learn(ts, draws.perm)
        float(m.loss_value)
        t2 = time.perf_counter()
        rollout_s += t1 - t0
        learn_s += t2 - t1
    samples = cfg.rollout_steps * num_envs * cfg.num_snakes
    per_update = (rollout_s + learn_s) / updates
    return {
        'metric': f'PPO update ({cfg.height}x{cfg.width}, {cfg.num_snakes} '
                  f'snakes of length {cfg.snake_length})',
        'num_envs': num_envs, 'rollout_steps': cfg.rollout_steps,
        'samples': samples, 'minibatch': samples // cfg.num_minibatches,
        'update_epochs': cfg.update_epochs,
        'ms_per_update': per_update * 1e3,
        'rollout_ms': rollout_s / updates * 1e3,
        'minibatch_ms': learn_s / updates * 1e3,
        'env_steps_per_s': num_envs * cfg.rollout_steps / per_update,
        'captured': captured,
        'obs_format': cfg.obs_format, 'device': _device_name(trainer.device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--num-envs', type=int, default=4096)
    ap.add_argument('--num-steps', type=int, default=256)
    ap.add_argument('--iters', type=int, default=4)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--mode', choices=('rollout', 'train', 'ppo'),
                    default='rollout')
    ap.add_argument('--episodes', type=int, default=3,
                    help='timed episodes per row (train mode)')
    ap.add_argument('--spawn-mode', choices=('procedural', 'pool'),
                    default='procedural', help='rollout mode only')
    ap.add_argument('--obs-format', choices=('uint8', 'packed'),
                    default='uint8')
    ap.add_argument('--frame-stack', type=int, default=1)
    ap.add_argument('--vision-range', type=int, default=None)
    ap.add_argument('--graph', action='store_true',
                    help='ray-feature observations (rollout mode only)')
    a = ap.parse_args(argv)
    obs = dict(obs_format=a.obs_format, frame_stack=a.frame_stack,
               vision_range=a.vision_range)
    if a.mode == 'ppo':
        for num_envs in (64, 256):
            print(json.dumps(run_ppo(num_envs, device=a.device, **obs)),
                  flush=True)
        return
    if a.mode == 'train':
        for num_envs in (32, 256):
            for every in (1, 4):
                print(json.dumps(run_train(num_envs, every, a.episodes,
                                           a.device, **obs)), flush=True)
        return
    print(json.dumps(run(a.num_envs, a.num_steps, a.iters, a.device,
                         a.seed, spawn_mode=a.spawn_mode, graph=a.graph,
                         **obs)))


if __name__ == '__main__':
    main()
