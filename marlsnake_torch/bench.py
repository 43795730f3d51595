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

``measure`` and ``measure_acting`` are ``bench_table.py``'s rows at any
``EnvConfig`` (``marlsnake_torch/bench_table.py`` runs the JAX table's
17): the rollout, or the policy in the loop (a greedy DQN forward for
every agent, then the env step, as one captured graph).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from marlsnake_torch.core import engine
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.models.dqn import DQN, make_dqn
from marlsnake_torch.ops.step_kernel import StaticEnvs
from marlsnake_torch.rng import (StepDraws, ppo_draws, rollout_draws,
                                 step_draws_seq)
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


def _block_rates(call, env_steps: int, device: torch.device, iters: int,
                 blocks: int, warmups: int) -> list:
    """env-steps/s of ``blocks`` timed blocks of ``iters`` calls of
    ``call()`` (``env_steps`` env-steps each; it returns a tensor), each
    block ended by a read-back of its last call's tensor, after
    ``warmups`` calls (the first builds and captures)."""
    for _ in range(warmups):
        float(call())
    rates = []
    for _ in range(blocks):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            r = call()
        float(r)
        rates.append(env_steps * iters / (time.perf_counter() - t0))
    return rates


def _random_rollouts(loop: Rollout, states, gen: torch.Generator,
                     captured: bool = True):
    """``_block_rates``'s call: a random-action rollout from where the
    last one ended; returns its checksum."""
    held = [states]

    def call():
        held[0], check = loop.random(held[0], gen, captured)
        return check

    return call


def _memory(device: torch.device, loop: CapturedLoop) -> dict:
    """What a timed row held on the card: its graph's pool and the peak
    of the allocator since the row began (None on the CPU)."""
    cuda = device.type == 'cuda'
    return {'graph_pool_bytes': loop.pool_bytes,
            'capture_s': loop.capture_seconds,
            'max_memory_allocated': (torch.cuda.max_memory_allocated(device)
                                     if cuda else None)}


def _begin_row(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _rates(per_block: list, num_steps: int) -> dict:
    """bench_table.py's row numbers from the env-steps/s of each block:
    the best, the median, the spread (max - min) / median in percent."""
    per_block = sorted(per_block)
    med = per_block[len(per_block) // 2]
    return {
        'steps_per_sec': round(per_block[-1], 1),
        'median_steps_per_sec': round(med, 1),
        'spread_pct': round(100 * (per_block[-1] - per_block[0]) / med, 1),
        'scan_steps': num_steps,
    }


def measure(cfg: EnvConfig, num_envs: int, num_steps: int = 256,
            iters: int = 2, blocks: int = 4, graph: bool = False,
            device='cuda', seed: int = 0) -> dict:
    """``bench_table.py``'s ``measure`` on the port: the rollout
    (``Rollout``, one captured graph of ``num_steps`` steps; ``graph``
    gives the ray-feature env, ``build_graph_rollout``'s rows) at any
    config, two warm-up calls (the second a replay), then ``blocks``
    timed blocks of ``iters`` rollouts, each block ended by a read-back.
    Returns the best, median and spread of the blocks' env-steps/s and
    ``scan_steps``, with ``memory`` beside them (``_memory``)."""
    env = VectorSnakeEnv(cfg, num_envs, device=device, seed=seed,
                         graph=graph)
    _begin_row(env.device)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed + 1)
    states, _ = env.reset()
    loop = Rollout(env, num_steps)
    per_block = _block_rates(_random_rollouts(loop, states, gen),
                             num_envs * num_steps, env.device, iters,
                             blocks, 2)
    return dict(_rates(per_block, num_steps),
                memory=_memory(env.device, loop.loop))


ACTING_PAD = 8   # the _opt row's zero channels behind the 8 obs planes


def acting_net(cfg: EnvConfig, optimized: bool, device='cuda',
               seed: int = 7) -> DQN:
    """The acting rows' DQN: float32 with the divide-by-255 maximum
    (the reference's inference numerics), or with ``optimized`` bfloat16
    with binary obs assumed and ``ACTING_PAD`` zero input channels
    (``bench_table.py``'s acting winners)."""
    if optimized:
        return make_dqn(cfg, seed, device, assume_binary_obs=True,
                        pad_channels=ACTING_PAD,
                        compute_dtype=torch.bfloat16)
    return make_dqn(cfg, seed, device, assume_binary_obs=False)


def acting_input(cfg: EnvConfig, states, obs: torch.Tensor,
                 optimized: bool) -> torch.Tensor:
    """The net's input for every agent, (E * N, H, W, C): the env's obs,
    or with ``optimized`` the frame re-encoded from ``states.grid``
    (``engine.encode_frame``) with ``ACTING_PAD`` zero channels."""
    if optimized:
        obs = F.pad(engine.encode_frame(cfg, states.grid), (0, ACTING_PAD))
    return obs.reshape((-1,) + obs.shape[2:])


class ActingRollout:
    """``measure_acting``'s rollout: ``num_steps`` steps of greedy DQN
    actions for every agent, then the env step with auto-reset, as one
    captured CUDA graph. The envs stay in the graph's buffers from one
    call to the next (the JAX bench donates them); a call copies its step
    draws in and returns the summed reward."""

    def __init__(self, env: VectorSnakeEnv, net: DQN, num_steps: int,
                 optimized: bool, states, obs: torch.Tensor):
        self.env, self.net, self.optimized = env, net, optimized
        self.envs = StaticEnvs(env.cfg, env.num_envs, env.device)
        self.envs.load(states)
        self.envs.out.obs.copy_(obs)
        self.draws = step_draws_seq(
            env.cfg, env.num_envs, num_steps,
            torch.Generator(device=env.device).manual_seed(0), env.device)
        self.reward = torch.zeros((), dtype=torch.float32,
                                  device=env.device)
        self.loop = CapturedLoop(self._body, env.device)

    @torch.no_grad()
    def _body(self) -> None:
        cfg, e = self.env.cfg, self.env.num_envs
        states, obs = self.envs.state, self.envs.out.obs
        rew = torch.zeros((), dtype=torch.float32, device=self.env.device)
        for t in range(self.draws.fruit_u.shape[0]):
            q = self.net(acting_input(cfg, states, obs, self.optimized))
            actions = q.argmax(-1).to(torch.int32).view(e, cfg.num_snakes)
            states, out = self.env.step(states, actions,
                                        StepDraws(*(x[t] for x in self.draws)))
            obs = out.obs
            rew += out.reward.sum()
        self.envs.store(states, out)
        self.reward.copy_(rew)

    def __call__(self, draws: StepDraws) -> torch.Tensor:
        copy_into(self.draws, draws)
        self.loop()
        return self.reward.clone()


def measure_acting(cfg: EnvConfig, num_envs: int, num_steps: int = 64,
                   iters: int = 3, optimized: bool = False, device='cuda',
                   seed: int = 0, blocks: int = 3) -> dict:
    """``bench_table.py``'s ``measure_acting`` on the port: the policy in
    the loop (``ActingRollout``; ``optimized`` for the ``_opt`` row), one
    warm-up call (the capture), then ``blocks`` timed blocks of ``iters``
    calls, each call ended by a read-back as the JAX bench blocks each.
    Returns ``measure``'s keys; env-steps count envs, not agents."""
    env = VectorSnakeEnv(cfg, num_envs, device=device, seed=seed)
    _begin_row(env.device)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed + 1)
    states, obs = env.reset()
    net = acting_net(cfg, optimized, env.device)
    loop = ActingRollout(env, net, num_steps, optimized, states, obs)

    def call():
        reward = loop(step_draws_seq(cfg, num_envs, num_steps, gen,
                                     env.device))
        return float(reward)

    per_block = _block_rates(call, num_envs * num_steps, env.device, iters,
                             blocks, 1)
    return dict(_rates(per_block, num_steps),
                memory=_memory(env.device, loop.loop))


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
    rates = sorted(_block_rates(_random_rollouts(loop, states, gen, captured),
                                num_envs * num_steps, env.device, iters, 3,
                                1))
    best = rates[-1]
    return {
        'metric': f'env-steps/s at {num_envs} parallel envs '
                  '(20x20, 4 snakes)',
        'value': best,
        'unit': 'env-steps/s',
        'vs_baseline': best / BASELINE_STEPS_PER_SEC,
        'median': rates[1],
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
