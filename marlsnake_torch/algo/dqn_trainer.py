"""Parameter-shared multi-agent DQN trainer on one device.

The port of the JAX package's ``algo/dqn_trainer.py``, with the same
algorithm and hyperparameter defaults as the reference trainer:

* one shared policy and target DQN serve every snake;
* per-agent epsilon-greedy actions, a shared uniform replay ring, and an
  optimizer update per env step (Huber TD loss, gradient clipped to a
  global norm of 10, Adam);
* epsilon decays by 0.9995 per episode down to its floor, the target net
  is synced every 100 episodes, and an agent that dies in the first steps
  of an episode is penalised;
* scalars Train/{Mean_Reward, Epsilon, Episode_Length, Loss}; best,
  periodic (keep the last N) and final checkpoints, and resume.

An episode steps ``num_envs`` envs together: one forward picks the
actions of all (num_envs x num_snakes) agents, the env step is one launch
of the CUDA step kernel's entry without auto-reset (``ops/step_kernel``;
the plain engine on the CPU), and the replay ring and the optimizer state
stay on the device. Where the JAX package runs the episode as one
``lax.scan`` program, this runs it in chunks of ``chunk_steps`` steps
(``chunk_steps``: the largest multiple of ``update_every`` that divides
``max_steps_per_episode`` and is at most 8). A chunk is branch-free, as
the scan's body is: whether an env is live and whether the ring is warm
are device predicates, every update the chunk may make is computed and
kept only where it may be made (``torch.where``), and the step count,
the update count and the loss sum are device counters. On CUDA the chunk
is captured once as a CUDA graph and replayed (``utils/cuda_graph.py``);
on the CPU the same body runs directly. The host reads one flag a chunk
(is an env still live?) and stops after the chunk in which the last env
finished: the steps of that chunk after it are no-ops, as the scan's
are, but each still pays its discarded update. ``train_episode_plain``
runs the same chunks uncaptured.

Random numbers: the trainer owns one ``torch.Generator`` on its device;
``train_episode`` draws an episode's numbers from it up front
(``rng.reset_draws``, ``rng.train_draws``) unless the caller hands them
in.

The episode's buffers are the trainer's own: ``train_episode`` copies
the state it is given into them and hands back copies, so a
``TrainState`` that went into ``train_episode`` stays as it was.

Data parallelism (``mesh``, the JAX trainer's ``axis_name`` branch; see
``parallel/dqn_dp.py``) keeps a Python loop over steps: each rank steps
its own envs into its own ring, and the parameters stay replicated. Each update all-reduces the
gradients and the loss as one flat buffer and divides it by the world
size (JAX's ``pmean``). Every rank makes the same collective calls: the
step's read-back follows one MIN all-reduce of [can update, -live], so
that every rank loops until no env of any rank is live, and updates stop
everywhere once one rank's envs have all finished or its ring is not yet
warm (JAX's ``pmin``). A rank whose envs have all finished launches no
more env steps and pushes nothing; it takes part in the collectives
only. Its episode length stops with its own last env. The metrics are
the mean over ranks of the mean reward, mean loss and episode length and
the max of the update count. A rank draws its resets and its steps from
two generators of its own (``rng.rank_seed``). Its ring is updated in
place.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from marlsnake_torch.algo import optim, replay
from marlsnake_torch.algo.acting import epsilon_greedy
from marlsnake_torch.core import engine
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.models.dqn import make_dqn
from marlsnake_torch.ops.obs_pack import unpack_obs
from marlsnake_torch.rng import (RESET_STREAM, STEP_STREAM, ResetDraws,
                                 StepDraws, TrainDraws, rank_seed,
                                 reset_draws, train_draws)
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.utils import checkpoint as ckpt
from marlsnake_torch.utils.cuda_graph import (CapturedLoop, chunk_steps,
                                              clone_tree, copy_into,
                                              run_chunks)
from marlsnake_torch.utils.metrics import MetricWriter
from marlsnake_torch.utils.profiling import tracer

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class DQNConfig:
    """The reference trainer's ``Config``, with the JAX package's extra
    knobs; field names and defaults are the JAX ``DQNConfig``'s."""
    # environment
    num_snakes: int = 4
    height: int = 20
    width: int = 20
    snake_length: int = 5
    vision_range: Optional[int] = None
    frame_stack: int = 1
    # training
    num_episodes: int = 50_000
    max_steps_per_episode: int = 256
    batch_size: int = 512
    gamma: float = 0.99
    lr: float = 5e-4
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay: float = 0.9995
    buffer_size: int = 10_000
    min_buffer_size: int = 512 * 3
    target_update_freq: int = 100
    # reward shaping
    early_death_threshold: int = 10
    early_death_penalty: float = -1.0
    reward_dict: Any = dataclasses.field(default_factory=lambda: {
        'fruit': 1.0, 'kill': 0.0, 'lose': 0.0, 'win': 0.0, 'time': 0.0})
    # checkpoints and logs
    save_freq: int = 500
    save_best_only: bool = True
    keep_last_n: int = 3
    save_dir: str = 'checkpoints'
    log_dir: str = 'runs_dqn'
    resume_from: Optional[str] = None
    # scaling knobs (no reference analog)
    num_envs: int = 1
    seed: int = 0
    # float32 parameters; torch.bfloat16 runs the convolutions and
    # products in bfloat16 (models/dqn.py)
    compute_dtype: torch.dtype = torch.float32
    # The engine's obs are one-hot {0, 1} planes, so the reference's
    # conditional /255 never divides and skipping its whole-obs max gives
    # the same activations. Set False only for other (0..255) inputs.
    assume_binary_obs: bool = True
    # Zero-pad the obs channels before conv1 (exact: the extra kernel
    # columns see zeros). It widens conv1's kernel to (32, 8 + pad, 3, 3),
    # so such parameters do not fit a consumer that applies the net to raw
    # 8-channel obs; the pad is written beside every checkpoint.
    obs_pad_channels: int = 0
    # 'packed' makes the envs emit one byte a cell a frame (its 8 one-hot
    # channels as bits): the replay ring stores those bytes, and they are
    # unpacked to the same uint8 planes where they enter the net.
    obs_format: str = 'uint8'
    # Re-encode the acting forward's obs from the carried env grid instead
    # of reading the carried obs: the same bytes for full-obs
    # frame_stack=1 uint8 configs, and refused for any other. None and
    # False mean off.
    reencode_acting_obs: Optional[bool] = None
    # Learner pacing. update_every=K runs K env steps between optimizer
    # updates (it must divide max_steps_per_episode); update_batch_size is
    # the minibatch of an update (None = batch_size).
    update_every: int = 1
    update_batch_size: Optional[int] = None
    # Sample the TD minibatch BEFORE the step's push (one step staler, and
    # warm-up crosses min_buffer_size one step later) and run the acting
    # rows and the TD rows through one forward. Requires update_every=1.
    fused_act_update: bool = False

    def env_config(self) -> EnvConfig:
        return EnvConfig.from_reward_dict(
            self.reward_dict, height=self.height, width=self.width,
            num_snakes=self.num_snakes, snake_length=self.snake_length,
            vision_range=self.vision_range, frame_stack=self.frame_stack,
            obs_format=self.obs_format)


@dataclasses.dataclass
class TrainState:
    """What training carries from episode to episode, all on the device
    but the two counters. The JAX ``TrainState``'s ``key`` has no field
    here: the trainer's generator takes its place."""
    params: Params             # the DQN's state_dict layout
    target_params: Params
    opt_state: optim.AdamState  # moments in the order of ``params``
    buffer: replay.ReplayBuffer
    epsilon: torch.Tensor      # () float32
    episode: int
    global_step: int           # optimizer updates performed

    def replace(self, **changes) -> 'TrainState':
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class EpisodeMetrics:
    mean_reward: torch.Tensor  # () float32: mean total shaped reward
    mean_loss: torch.Tensor    # () float32
    episode_length: float      # steps until every env was done
    updates: int


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss, in optax's arithmetic."""
    abs_err = (pred - target).abs()
    quadratic = abs_err.clamp(max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_err - quadratic)


@dataclasses.dataclass
class _EpisodeBuffers:
    """What an episode's chunks carry, at fixed addresses: the envs, the
    episode's counters and accumulators, the learner's state, the ring,
    and the episode's draws (step axis first, read at the device step
    index ``t``)."""
    envs: step_kernel.StaticEnvs
    frozen: torch.Tensor       # (E,) bool: the env has finished
    ep_rew: torch.Tensor       # (E, N) float32
    loss_sum: torch.Tensor     # () float32
    updates: torch.Tensor      # () int32
    steps: torch.Tensor        # () int32: steps with an env live
    t: torch.Tensor            # (1,) int64: the next step's index
    params: Params
    target_params: Params
    opt_state: optim.AdamState
    buffer: replay.ReplayBuffer
    epsilon: torch.Tensor
    draws: TrainDraws
    flags: torch.Tensor        # (3,) int32: [live, steps, updates]


class DQNTrainer:
    """Single-device trainer. ``device`` defaults to the GPU; pass
    ``'cpu'`` to run the plain PyTorch path. With ``mesh``
    (``parallel.mesh.Mesh``) it is one rank of a data-parallel run on the
    mesh's device, ``num_envs`` being this rank's envs."""

    def __init__(self, config: DQNConfig, device='cuda', mesh=None):
        self.config = config
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        if config.max_steps_per_episode % config.update_every != 0:
            raise ValueError(
                f'update_every={config.update_every} must divide '
                f'max_steps_per_episode={config.max_steps_per_episode}')
        if config.fused_act_update and config.update_every != 1:
            raise ValueError(
                'fused_act_update requires update_every=1 (it fuses the '
                'per-step update into the acting forward)')
        self.device = resolve_device(device)
        self.env_cfg = config.env_config()
        self._reset_env, self._step_env = build_vector_fns(
            self.env_cfg, autoreset=False, device=self.device)
        # the net is applied to parameters handed in (TrainState.params);
        # its own, made from config.seed, are what init_state starts from
        self.net = make_dqn(
            self.env_cfg, config.seed, self.device, config.assume_binary_obs,
            config.obs_pad_channels, config.compute_dtype
        ).requires_grad_(False)
        self.generator = torch.Generator(device=self.device)
        if mesh is None:
            self.generator.manual_seed(config.seed + 1)
            self.reset_generator = self.generator
        else:
            self.generator.manual_seed(
                rank_seed(config.seed, mesh.rank, STEP_STREAM))
            self.reset_generator = torch.Generator(device=self.device)
            self.reset_generator.manual_seed(
                rank_seed(config.seed, mesh.rank, RESET_STREAM))
        self.update_batch = config.update_batch_size or config.batch_size
        self.chunk_steps = chunk_steps(config.max_steps_per_episode,
                                       config.update_every)
        # (buffers, CapturedLoop) by the shapes of the episode's draws
        self._chunks: Dict[tuple, Tuple[_EpisodeBuffers, CapturedLoop]] = {}
        self.best_mean_reward = float('-inf')
        self.writer = None

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        cfg = self.config
        params = {k: v.detach().clone()
                  for k, v in self.net.state_dict().items()}
        return TrainState(
            params=params, target_params=params,
            opt_state=optim.adam_init(list(params.values())),
            buffer=replay.create(cfg.buffer_size, self.env_cfg.obs_shape[1:],
                                 device=self.device),
            epsilon=torch.tensor(cfg.epsilon_start, dtype=torch.float32,
                                 device=self.device),
            episode=0, global_step=0)

    # ------------------------------------------------------------------
    def _prep(self, flat_obs: torch.Tensor) -> torch.Tensor:
        """Net-ingress obs transform: unpack packed bytes to the uint8
        planes (``obs_format='packed'``), then zero-pad the obs channels
        (``obs_pad_channels``; exact, the widened conv1 sees zeros)."""
        if self.config.obs_format == 'packed':
            flat_obs = unpack_obs(flat_obs)
        pad = self.config.obs_pad_channels
        return F.pad(flat_obs, (0, pad)) if pad else flat_obs

    def _q(self, params: Params, flat_obs: torch.Tensor) -> torch.Tensor:
        """Q-values (rows, A) of per-agent obs under ``params``."""
        return torch.func.functional_call(self.net, params,
                                          (self._prep(flat_obs),))

    def _acting_exact(self) -> bool:
        """True when the obs is a function of the current grid alone, so
        that re-encoding it gives the carried obs byte for byte."""
        cfg = self.config
        return (cfg.frame_stack == 1 and not cfg.vision_range
                and cfg.obs_format == 'uint8')

    def _acting_obs(self, env_states, obs):
        if not self.config.reencode_acting_obs:
            return obs
        if not self._acting_exact():
            raise ValueError(
                'reencode_acting_obs requires full-obs frame_stack=1 '
                'uint8 configs (obs must be a pure function of the grid)')
        return engine.encode_frame(self.env_cfg, env_states.grid)

    def _select_actions(self, params: Params, obs, dones, eps,
                        draws: TrainDraws) -> torch.Tensor:
        """Batched epsilon-greedy for (E, N) agents in one forward."""
        e, n = obs.shape[:2]
        q = self._q(params, obs.reshape((e * n,) + obs.shape[2:]))
        return epsilon_greedy(q, dones, eps, draws.rand, draws.explore_u)

    def _td_loss(self, q: torch.Tensor, target_params: Params, batch
                 ) -> torch.Tensor:
        """Mean Huber loss of Q(s, .) rows ``q`` against the one-step
        target ``r + (1 - done) * gamma * max_a Q_target(s', a)``."""
        _, action, rew, next_obs, done = batch
        q_sa = q.gather(1, action.long()[:, None])[:, 0]
        with torch.no_grad():
            next_q = self._q(target_params, next_obs).max(-1).values
            target = rew + (1.0 - done.to(torch.float32)) \
                * self.config.gamma * next_q
        return huber_loss(q_sa, target).mean()

    def loss_and_grads(self, params: Params, target_params: Params, batch,
                       acting_obs: Optional[torch.Tensor] = None):
        """(loss, gradients in the order of ``params``, acting Q-values).
        With ``acting_obs`` (rows of per-agent obs) those rows go through
        the same forward as the batch's, ahead of them, and their
        Q-values come back detached; else the third result is None."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        obs = batch[0]
        with torch.enable_grad():
            if acting_obs is None:
                q_act, q = None, self._q(leaves, obs)
            else:
                rows = acting_obs.shape[0]
                q_all = self._q(leaves, torch.cat([acting_obs, obs], 0))
                q_act, q = q_all[:rows].detach(), q_all[rows:]
            loss = self._td_loss(q, target_params, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        # in the parameters' layout (the convolutions' weight gradients
        # come channels-last), as the optimizer's kernel takes them
        return loss.detach(), [g.contiguous() for g in grads], q_act

    def apply_gradients(self, params: Params, opt_state: optim.AdamState,
                        grads, can_update: Optional[torch.Tensor] = None,
                        in_place: bool = False
                        ) -> Tuple[Params, optim.AdamState]:
        """Clip to a global norm of 10, then one Adam step at ``lr``, kept
        where ``can_update`` (a device bool) is set: the branch-free
        counterpart of JAX's ``lax.cond``, the Adam count held too. With
        ``in_place`` the step is written into ``params`` and
        ``opt_state``."""
        new, opt_state = optim.clip_adam(
            list(params.values()), grads, opt_state, self.config.lr, 10.0,
            can_update=can_update, in_place=in_place)
        return dict(zip(params, new)), opt_state

    def _grads(self, params: Params, target_params: Params, batch,
               acting_obs: Optional[torch.Tensor] = None):
        """``loss_and_grads``, with a mesh averaged over its ranks."""
        loss, grads, q_act = self.loss_and_grads(params, target_params,
                                                 batch, acting_obs)
        if self.mesh is not None:
            *grads, loss = self.mesh.mean(grads + [loss])
        return loss, grads, q_act

    def _td_update(self, params: Params, target_params: Params,
                   opt_state: optim.AdamState, batch,
                   acting_obs: Optional[torch.Tensor] = None):
        """One optimizer step on ``batch`` = (obs, action, reward,
        next_obs, done). Returns (params, opt_state, loss, acting Q)."""
        loss, grads, q_act = self._grads(params, target_params, batch,
                                         acting_obs)
        params, opt_state = self.apply_gradients(params, opt_state, grads)
        return params, opt_state, loss, q_act

    # ------------------------------------------------------------------
    def _read_flags(self, buffer: replay.ReplayBuffer,
                    frozen: torch.Tensor) -> Tuple[bool, bool, bool]:
        """The data-parallel step's one read-back: (can_update, live,
        any_live). ``live``: an env of this rank has not finished;
        ``can_update``: the ring is warm and an env is live, on every rank;
        ``any_live``: an env is live on some rank. The two global flags
        come from one MIN all-reduce of [can_update, -live]."""
        live = (~frozen).any().to(torch.int32)
        warm = (buffer.size >= self.config.min_buffer_size).to(torch.int32)
        flags = torch.stack([live * warm, -live])
        self.mesh.all_reduce(flags, 'min')
        can_update, neg_any_live, live = torch.cat(
            [flags, live[None]]).tolist()
        return bool(can_update), bool(live), neg_any_live < 0

    def _mean_metrics(self, mean_reward, mean_loss, steps: int,
                      updates: int):
        """The episode's metrics over the ranks: the mean of the mean
        reward, the mean loss and the episode length (float32, as JAX's
        ``pmean``), the max of the update count."""
        mesh = self.mesh
        means = torch.stack([mean_reward, mean_loss, torch.tensor(
            float(steps), device=self.device)])
        mesh.all_reduce(means).div_(mesh.world)
        most = mesh.all_reduce(torch.tensor(
            [updates], dtype=torch.int64, device=self.device), 'max')
        return means[0], means[1], float(means[2]), int(most)

    def _draws(self, draws: Optional[TrainDraws],
               reset: Optional[ResetDraws]
               ) -> Tuple[TrainDraws, ResetDraws]:
        cfg, dev = self.config, self.device
        if reset is None:
            reset = reset_draws(self.env_cfg, cfg.num_envs,
                                self.reset_generator, dev)
        if draws is None:
            draws = train_draws(self.env_cfg, cfg.num_envs,
                                cfg.max_steps_per_episode, cfg.buffer_size,
                                self.update_batch, self.generator, dev)
        return draws, reset

    def train_episode(self, ts: TrainState,
                      draws: Optional[TrainDraws] = None,
                      reset: Optional[ResetDraws] = None
                      ) -> Tuple[TrainState, EpisodeMetrics]:
        """One episode of ``num_envs`` envs: reset, then up to
        ``max_steps_per_episode`` steps of act, env step, early-death
        shaping, masked push, freeze of finished envs, and the optimizer
        update the pacing mode asks for; then epsilon decay, target sync
        and the metrics. ``draws`` and ``reset`` default to numbers from
        the trainer's generators. On one device the steps run in chunks,
        on CUDA as replays of one captured graph; with a mesh, as a loop
        over steps."""
        if self.mesh is not None:
            with tracer.span('dqn.episode'):
                return self._train_episode_loop(ts, draws, reset)
        return self._train_episode_chunks(ts, draws, reset, captured=True)

    def train_episode_plain(self, ts: TrainState,
                            draws: Optional[TrainDraws] = None,
                            reset: Optional[ResetDraws] = None
                            ) -> Tuple[TrainState, EpisodeMetrics]:
        """``train_episode`` on one device with its chunks run uncaptured
        (the graph's plain version; the same buffers and the same body)."""
        return self._train_episode_chunks(ts, draws, reset, captured=False)

    def _chunk_loop(self, draws: TrainDraws
                   ) -> Tuple[_EpisodeBuffers, CapturedLoop]:
        """The chunk's buffers and its ``CapturedLoop`` for draws of the
        shapes of ``draws``, made on first use (draws that hand over
        ``sample_idx`` take another loop than draws that sample from
        ``sample_u``)."""
        key = tuple(None if x is None else tuple(x.shape) for x in draws)
        if key not in self._chunks:
            bufs = self._episode_buffers(draws)
            self._chunks[key] = (bufs, CapturedLoop(
                lambda: self._chunk(bufs), self.device))
        return self._chunks[key]

    def captured_loops(self) -> list:
        """The ``CapturedLoop`` of each chunk made so far."""
        return [loop for _, loop in self._chunks.values()]

    def _episode_buffers(self, draws: TrainDraws) -> _EpisodeBuffers:
        cfg, dev = self.config, self.device
        e, n = cfg.num_envs, cfg.num_snakes

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        params = {k: torch.zeros_like(v)
                  for k, v in self.net.state_dict().items()}
        return _EpisodeBuffers(
            envs=step_kernel.StaticEnvs(self.env_cfg, e, dev),
            frozen=zeros((e,), torch.bool),
            ep_rew=zeros((e, n), torch.float32),
            loss_sum=zeros((), torch.float32),
            updates=zeros((), torch.int32), steps=zeros((), torch.int32),
            t=zeros((1,), torch.int64), params=params,
            target_params={k: torch.zeros_like(v)
                           for k, v in params.items()},
            opt_state=optim.adam_init(list(params.values())),
            buffer=replay.create(cfg.buffer_size,
                                 self.env_cfg.obs_shape[1:], device=dev),
            epsilon=zeros((), torch.float32),
            draws=TrainDraws(*(None if x is None else torch.zeros_like(x)
                               for x in draws)),
            flags=zeros((3,), torch.int32))

    def _chunk(self, b: _EpisodeBuffers) -> None:
        """``chunk_steps`` steps of the episode over the buffers ``b``,
        with no read-back and no branch on a device value: the body of
        JAX's ``_episode_impl`` scan, a chunk of it at a time.

        The tracer's marks: ``dqn.chunk.start`` and ``dqn.chunk.end`` (after
        the stores), and on each step the ends of ``dqn.act`` (the draws'
        row, the acting obs, the Q forward, epsilon-greedy), ``dqn.env``
        (the step with its hold, the shaping, the push, the accumulators),
        ``dqn.td_grad`` (the sample, the online and target forwards, the
        loss, the backward; with ``fused_act_update`` the acting rows'
        forward too) and ``dqn.optim`` (clip and Adam, kept where the
        step can update, written into the chunk's parameters and moments;
        the loss and update counters), the last two on the steps that
        update."""
        cfg = self.config
        e, n = cfg.num_envs, cfg.num_snakes
        buffer, eps, target = b.buffer, b.epsilon, b.target_params
        state, out = b.envs.state, b.envs.out
        params, opt_state = b.params, b.opt_state
        frozen, ep_rew, steps, t = b.frozen, b.ep_rew, b.steps, b.t
        loss_sum, updates = b.loss_sum, b.updates

        def flat(x):
            return x.reshape((e * n,) + x.shape[2:])

        def learn(can_update, d, acting=None):
            nonlocal loss_sum, updates
            batch = replay.sample(buffer, self.update_batch, d.sample_u,
                                  idx=d.sample_idx)
            loss, grads, q_act = self._grads(params, target, batch, acting)
            tracer.mark('dqn.td_grad')
            self.apply_gradients(params, opt_state, grads, can_update,
                                 in_place=True)
            loss_sum = loss_sum + torch.where(can_update, loss, 0.0)
            updates = updates + can_update.to(torch.int32)
            tracer.mark('dqn.optim')
            return q_act

        tracer.mark('dqn.chunk.start')
        for k in range(self.chunk_steps):
            d = TrainDraws(*(None if x is None else x.index_select(0, t)[0]
                             for x in b.draws))
            obs, dones = out.obs, out.done
            acting = self._acting_obs(state, obs)
            if cfg.fused_act_update:
                # the minibatch comes from the ring as it is before this
                # step's push; acting and TD rows share one forward, whose
                # acting rows are taken whether or not the update is kept
                can_update = ((buffer.size >= cfg.min_buffer_size)
                              & ~frozen.all())
                q_act = learn(can_update, d, flat(acting))
                actions = epsilon_greedy(q_act, dones, eps, d.rand,
                                         d.explore_u)
            else:
                actions = self._select_actions(params, acting, dones, eps, d)
            tracer.mark('dqn.act')
            # finished envs stand still (the reference loops while not
            # all done): the step leaves them as they came in; at the
            # episode's first step no env is frozen
            new_state, new_out = self._step_env(
                state, actions, StepDraws(d.fruit_u, None, None),
                hold=(frozen, out))
            # early-death shaping while the step count is under the
            # threshold (the count stops with the last live env)
            shaped = new_out.reward + torch.where(
                new_out.done & (steps < cfg.early_death_threshold),
                cfg.early_death_penalty, 0.0)
            push_mask = ~dones & ~frozen[:, None]  # alive at step
            replay.push(buffer, flat(obs), flat(actions), flat(shaped),
                        flat(new_out.obs), flat(new_out.done),
                        mask=flat(push_mask))
            ep_rew = ep_rew + torch.where(push_mask, shaped, 0.0)
            steps = steps + (~frozen.all()).to(torch.int32)
            frozen = frozen | new_out.done.all(-1)
            state, out = new_state, new_out
            t = t + 1
            tracer.mark('dqn.env')
            if (not cfg.fused_act_update
                    and (k + 1) % cfg.update_every == 0):
                learn((buffer.size >= cfg.min_buffer_size) & ~frozen.all(),
                      d)

        b.envs.store(state, out)
        for dst, src in ((b.frozen, frozen), (b.ep_rew, ep_rew),
                         (b.steps, steps), (b.t, t), (b.loss_sum, loss_sum),
                         (b.updates, updates)):
            dst.copy_(src)
        b.flags.copy_(torch.stack([(~frozen.all()).to(torch.int32), steps,
                                   updates]))
        tracer.mark('dqn.chunk.end')

    @torch.no_grad()
    def _train_episode_chunks(self, ts: TrainState,
                              draws: Optional[TrainDraws],
                              reset: Optional[ResetDraws], captured: bool
                              ) -> Tuple[TrainState, EpisodeMetrics]:
        """The episode in chunks. The tracer's span ``dqn.episode`` holds
        ``dqn.prologue`` (draws, reset, copy-in), the chunks (``run_chunks``
        as ``dqn``) and ``dqn.epilogue`` (the metrics, the clones,
        ``_end_episode``), the first and last bounded by marks; the count
        ``dqn.tail_steps`` adds the steps the chunks ran after the
        episode's last live step."""
        cfg = self.config
        with tracer.span('dqn.episode'):
            with tracer.span('dqn.prologue', device=True):
                draws, reset = self._draws(draws, reset)
                b, loop = self._chunk_loop(draws)
                env_states, obs = self._reset_env(reset)
                b.envs.load(env_states)
                b.envs.out.obs.copy_(obs)
                for x in (b.frozen, b.ep_rew, b.loss_sum, b.updates, b.steps,
                          b.t):
                    x.zero_()
                copy_into(b.params, ts.params)
                copy_into(b.target_params, ts.target_params)
                copy_into(b.opt_state, ts.opt_state)
                copy_into(b.buffer, ts.buffer)
                b.epsilon.copy_(ts.epsilon)
                copy_into(b.draws, draws)
            _, steps, updates = run_chunks(loop, b.flags,
                                           cfg.max_steps_per_episode,
                                           self.chunk_steps, captured,
                                           name='dqn')
            # the chunk that ran the last live step is the last one run
            tracer.count('dqn.tail_steps',
                         -(-steps // self.chunk_steps) * self.chunk_steps
                         - steps)
            with tracer.span('dqn.epilogue', device=True):
                mean_loss = (b.loss_sum / updates if updates
                             else b.loss_sum.clone())
                metrics = EpisodeMetrics(
                    mean_reward=optim.mean_of(b.ep_rew), mean_loss=mean_loss,
                    episode_length=float(steps), updates=updates)
                ts = self._end_episode(ts, clone_tree(b.params),
                                       clone_tree(b.opt_state),
                                       clone_tree(b.buffer), metrics)
        return ts, metrics

    def _end_episode(self, ts: TrainState, params: Params,
                     opt_state: optim.AdamState,
                     buffer: replay.ReplayBuffer,
                     metrics: EpisodeMetrics) -> TrainState:
        """The state after an episode: its learner state and ring, epsilon
        decayed, the target synced when it is due, the counters on."""
        cfg = self.config
        episode = ts.episode + 1
        epsilon = torch.clamp(ts.epsilon * cfg.epsilon_decay,
                              min=cfg.epsilon_end)
        sync = episode % cfg.target_update_freq == 0
        return ts.replace(
            params=params, target_params=params if sync else ts.target_params,
            opt_state=opt_state, buffer=buffer, epsilon=epsilon,
            episode=episode, global_step=ts.global_step + metrics.updates)

    @torch.no_grad()
    def _train_episode_loop(self, ts: TrainState,
                            draws: Optional[TrainDraws],
                            reset: Optional[ResetDraws]
                            ) -> Tuple[TrainState, EpisodeMetrics]:
        """The data-parallel episode: a Python loop over steps, with the
        flags read back (after their all-reduce) every step."""
        cfg = self.config
        e, n = cfg.num_envs, cfg.num_snakes
        dev = self.device
        num_steps = cfg.max_steps_per_episode
        draws, reset = self._draws(draws, reset)
        env_states, obs = self._reset_env(reset)
        out = None
        dones = torch.zeros((e, n), dtype=torch.bool, device=dev)
        frozen = torch.zeros((e,), dtype=torch.bool, device=dev)
        ep_rew = torch.zeros((e, n), dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        params, opt_state, buffer = ts.params, ts.opt_state, ts.buffer
        updates = steps = 0
        # the flags as the first step finds them: its fused update goes by
        # the ring the last episode left
        can_update, live, _ = self._read_flags(buffer, frozen)

        def flat(x):
            return x.reshape((e * n,) + x.shape[2:])

        for t in range(num_steps):
            d = draws.at(t)
            if live:
                if cfg.fused_act_update:
                    # the minibatch comes from the ring as it is before
                    # this step's push; acting and TD rows share one
                    # forward
                    acting = flat(self._acting_obs(env_states, obs))
                    if can_update:
                        batch = replay.sample(buffer, self.update_batch,
                                              d.sample_u, idx=d.sample_idx)
                        params, opt_state, loss, q_act = self._td_update(
                            params, ts.target_params, opt_state, batch,
                            acting)
                        loss_sum = loss_sum + loss
                        updates += 1
                    else:
                        q_act = self._q(params, acting)
                    actions = epsilon_greedy(q_act, dones, ts.epsilon,
                                             d.rand, d.explore_u)
                else:
                    actions = self._select_actions(
                        params, self._acting_obs(env_states, obs), dones,
                        ts.epsilon, d)
                # finished envs stand still (the reference loops while
                # not all done): the step leaves them as they came in;
                # no env is frozen before the first step
                new_states, new_out = self._step_env(
                    env_states, actions, StepDraws(d.fruit_u, None, None),
                    hold=(frozen, out) if t > 0 else None)

                # early-death shaping; t is the step count, since this
                # rank's steps end with its last live env
                shaped = new_out.reward
                if t < cfg.early_death_threshold:
                    shaped = shaped + torch.where(
                        new_out.done, cfg.early_death_penalty, 0.0)
                push_mask = ~dones & ~frozen[:, None]  # alive at step
                replay.push(buffer, flat(obs), flat(actions), flat(shaped),
                            flat(new_out.obs), flat(new_out.done),
                            mask=flat(push_mask))
                ep_rew = ep_rew + torch.where(push_mask, shaped, 0.0)

                env_states, out = new_states, new_out
                obs, dones = out.obs, out.done
                frozen = frozen | dones.all(-1)
                steps = t + 1

            can_update, live, any_live = self._read_flags(buffer, frozen)
            if (not cfg.fused_act_update and can_update
                    and (t + 1) % cfg.update_every == 0):
                batch = replay.sample(buffer, self.update_batch, d.sample_u,
                                      idx=d.sample_idx)
                params, opt_state, loss, _ = self._td_update(
                    params, ts.target_params, opt_state, batch)
                loss_sum = loss_sum + loss
                updates += 1
            if not any_live:
                break

        mean_reward, mean_loss, episode_length, updates = \
            self._mean_metrics(optim.mean_of(ep_rew), loss_sum / updates
                               if updates else loss_sum, steps, updates)
        metrics = EpisodeMetrics(
            mean_reward=mean_reward, mean_loss=mean_loss,
            episode_length=episode_length, updates=updates)
        return self._end_episode(ts, params, opt_state, buffer,
                                 metrics), metrics

    # ------------------------------------------------------------------
    def train(self, num_episodes: Optional[int] = None,
              log: bool = True) -> TrainState:
        cfg = self.config
        num_episodes = num_episodes or cfg.num_episodes
        ts = self.init_state()
        start_ep = 1
        if cfg.resume_from:
            ts, extra = self.load_checkpoint(cfg.resume_from, ts)
            start_ep = ts.episode + 1
            self.best_mean_reward = extra.get('best_mean_reward',
                                              float('-inf'))
        if log:
            from datetime import datetime
            run_dir = os.path.join(
                cfg.log_dir, datetime.now().strftime('%Y%m%d-%H%M%S'))
            self.writer = MetricWriter(run_dir)
        os.makedirs(cfg.save_dir, exist_ok=True)
        history = []

        t0 = time.time()
        for ep in range(start_ep, num_episodes + 1):
            ts, m = self.train_episode(ts)
            if ep % 10 == 0 or ep == num_episodes:
                mr, ml = float(m.mean_reward), float(m.mean_loss)
                eps = float(ts.epsilon)
                if self.writer:
                    self.writer.add_scalar('Train/Mean_Reward', mr, ep)
                    self.writer.add_scalar('Train/Epsilon', eps, ep)
                    self.writer.add_scalar('Train/Episode_Length',
                                           m.episode_length, ep)
                    if ml > 0:
                        self.writer.add_scalar('Train/Loss', ml, ep)
                print(f'Ep {ep:5d} | Mean Reward: {mr:6.2f} | '
                      f'Loss: {ml:.4f} | eps: {eps:.3f} | '
                      f'Steps: {m.episode_length:.0f} | '
                      f'{(time.time() - t0):.1f}s')
            if cfg.save_best_only and ep >= 50:
                mr = float(m.mean_reward)
                if mr > self.best_mean_reward:
                    self.best_mean_reward = mr
                    self.save_checkpoint(ts, 'best')
            if cfg.save_freq and ep % cfg.save_freq == 0:
                self.save_checkpoint(ts, ep)
                history.append(ep)
                if len(history) > cfg.keep_last_n:
                    self.delete_checkpoint(history.pop(0))
        self.save_checkpoint(ts, 'final')
        if self.writer:
            self.writer.close()
        return ts

    # --- checkpoints ---------------------------------------------------
    def _ckpt_path(self, tag) -> str:
        return os.path.abspath(
            os.path.join(self.config.save_dir, f'shared_model_{tag}.pt'))

    @staticmethod
    def _meta_path(path: str) -> str:
        return path[:-len('.pt')] + '.meta.json'

    def _payload(self, ts: TrainState, full: bool) -> dict:
        # the optimizer state rides along, so a resumed run goes on with
        # warm Adam moments; full=True adds the replay ring and the
        # generator's state, so that a resumed run repeats the
        # uninterrupted one
        opt = ts.opt_state
        payload = {
            'params': ts.params, 'target_params': ts.target_params,
            'opt_state': {'count': opt.count, 'mu': opt.mu, 'nu': opt.nu},
            'global_step': ts.global_step, 'epsilon': ts.epsilon,
            'episode': ts.episode,
            'best_mean_reward': float(self.best_mean_reward),
        }
        if full:
            payload['buffer'] = dict(ts.buffer.fields())
            payload['generator'] = self.generator.get_state()
            if self.reset_generator is not self.generator:
                payload['reset_generator'] = self.reset_generator.get_state()
        return payload

    def save_checkpoint(self, ts: TrainState, tag, full: bool = False):
        path = self._ckpt_path(tag)
        ckpt.save(path, self._payload(ts, full))
        # beside it: what a consumer needs to apply these parameters to
        # raw engine obs (see DQNConfig.obs_pad_channels)
        with open(self._meta_path(path), 'w') as f:
            json.dump({'obs_pad_channels': self.config.obs_pad_channels,
                       'obs_format': self.config.obs_format}, f)

    def load_checkpoint(self, tag, ts: TrainState, full: bool = False):
        """``ts`` with what the checkpoint ``tag`` holds, and
        ``{'best_mean_reward': ...}``. With ``full=True`` the replay ring
        is read into ``ts``'s and the trainer's generator is set too."""
        got = ckpt.restore(self._ckpt_path(tag), self._payload(ts, full))
        opt = got['opt_state']
        ts = ts.replace(
            params=got['params'], target_params=got['target_params'],
            opt_state=optim.AdamState(opt['count'], opt['mu'], opt['nu']),
            global_step=got['global_step'], epsilon=got['epsilon'],
            episode=got['episode'])
        if full:
            ts = ts.replace(buffer=dataclasses.replace(ts.buffer,
                                                       **got['buffer']))
            self.generator.set_state(got['generator'].cpu())
            if 'reset_generator' in got:
                self.reset_generator.set_state(got['reset_generator'].cpu())
        return ts, {'best_mean_reward': got['best_mean_reward']}

    def delete_checkpoint(self, tag):
        path = self._ckpt_path(tag)
        for p in (path, self._meta_path(path)):
            if os.path.exists(p):
                os.remove(p)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('--episodes', type=int, default=200)
    p.add_argument('--num-envs', type=int, default=1)
    p.add_argument('--height', type=int, default=20)
    p.add_argument('--width', type=int, default=20)
    p.add_argument('--num-snakes', type=int, default=4)
    p.add_argument('--vision-range', type=int, default=None)
    p.add_argument('--frame-stack', type=int, default=1)
    p.add_argument('--obs-format', choices=('uint8', 'packed'),
                   default='uint8')
    p.add_argument('--resume', type=str, default=None)
    p.add_argument('--no-log', action='store_true')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    cfg = DQNConfig(num_episodes=args.episodes, num_envs=args.num_envs,
                    height=args.height, width=args.width,
                    num_snakes=args.num_snakes, resume_from=args.resume,
                    vision_range=args.vision_range,
                    frame_stack=args.frame_stack,
                    obs_format=args.obs_format)
    DQNTrainer(cfg, device=args.device).train(log=not args.no_log)


if __name__ == '__main__':
    main()
