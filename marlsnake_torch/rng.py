"""The random numbers a reset or a step consumes, drawn up front.

The engine and the CUDA step kernel take every random number as an input
tensor instead of deriving it inside: a reset needs its spawn draws (one
uniform to pick its spawn-pool row, or with ``spawn_mode='procedural'``
four uniforms a snake: position in its band of rows, column, head side,
orientation; always four, whatever the board consumes) and ``nf``
uniforms for its fruits; a step needs ``N`` uniforms for fruit respawn
plus one reset's worth, used by the envs whose episode ends. Draws come
from an explicit ``torch.Generator``, so a run is reproducible from its
seed. They are not the JAX package's numbers (a
threefry key schedule); tests hand both packages the same draws.

A DQN training episode takes ``TrainDraws``: for each of its env steps
the acting draws, the env's fruit draws and the replay sampling draw, all
drawn before the episode starts and read by step index, so that an
episode that stops early leaves the generator where a full one does.

A PPO update takes ``PPODraws``, drawn up front the same way: the step
draws of every rollout step (one ``torch.rand``, ``step_draws_seq``),
the Gumbel noise of the action sample (``argmax(logits + gumbel)`` is a
sample of ``softmax(logits)``, the very computation of JAX's
``random.categorical``) and one permutation of the rollout's samples for
each epoch of minibatches. The bench's random-action rollout takes
``rollout_draws``.

The evolution trainers (``algo/neat_hybrid.py``) take ``EpisodeDraws``
for each fitness, validation or hold-out episode (a reset and the fruit
draws of every step), and the head ES ``ESDraws`` for a generation (its
perturbations and fitness episodes). A generator of its own, for a
validation set, a hold-out set or one episode of a single env, is seeded
with ``derive_seed``.

A batched battle (``algo/battle_batch.py``) takes ``BattleDraws``: its
envs' resets and fruit draws, and for each opponent seat what its policy
draws a step, the greedy fruit-seeker's tie-break uniforms or a random
seat's actions.

A data-parallel rank seeds its generators with ``rank_seed``, so that
its draws are its own.

An outer iteration of the DAgger distillation
(``tools/distill_acting.py``) takes ``DistillDraws``: the step draws of
its rollout and the indices of its minibatches into the rollout's
buffer of visited obs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from marlsnake_torch.core.types import EnvConfig


class ResetDraws(NamedTuple):
    # (B,) float32: spawn-pool row; (B, N, 4) for the procedural spawn
    spawn_u: torch.Tensor
    fruit_u: torch.Tensor  # (B, nf) float32: fruit cells


class StepDraws(NamedTuple):
    fruit_u: torch.Tensor        # (B, N) float32: fruit respawn
    # (B,) float32: auto-reset pool row; (B, N, 4) procedural
    reset_spawn_u: torch.Tensor
    reset_fruit_u: torch.Tensor  # (B, nf) float32: auto-reset fruits

    def at(self, t: int) -> 'StepDraws':
        """Step ``t``'s draws of a sequence, step axis first."""
        return StepDraws(*(x[t] for x in self))


def _rand(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def spawn_draw_shape(cfg: EnvConfig, num_envs: int) -> tuple:
    """Shape of a reset's spawn draws for ``num_envs`` envs."""
    if cfg.spawn_mode == 'procedural':
        return (num_envs, cfg.num_snakes, 4)
    return (num_envs,)


def reset_draws(cfg: EnvConfig, num_envs: int, generator: torch.Generator,
                device) -> ResetDraws:
    nf = cfg.resolved_num_fruits
    return ResetDraws(_rand(spawn_draw_shape(cfg, num_envs), generator,
                            device),
                      _rand((num_envs, nf), generator, device))


def step_draws(cfg: EnvConfig, num_envs: int, generator: torch.Generator,
               device) -> StepDraws:
    n, nf = cfg.num_snakes, cfg.resolved_num_fruits
    return StepDraws(_rand((num_envs, n), generator, device),
                     _rand(spawn_draw_shape(cfg, num_envs), generator,
                           device),
                     _rand((num_envs, nf), generator, device))


def step_draws_seq(cfg: EnvConfig, num_envs: int, steps: int,
                   generator: torch.Generator, device) -> StepDraws:
    """The step draws of ``steps`` steps, step axis first, from ONE
    ``torch.rand``: each field is a contiguous run of it, so one step's
    draws (``x[t]``) are contiguous, as the step kernel takes them."""
    n, nf = cfg.num_snakes, cfg.resolved_num_fruits
    shapes = [(steps, num_envs, n),
              (steps,) + spawn_draw_shape(cfg, num_envs),
              (steps, num_envs, nf)]
    sizes = [math.prod(shape) for shape in shapes]
    flat = _rand((sum(sizes),), generator, device)
    return StepDraws(*(run.view(shape) for run, shape in zip(
        flat.split(sizes), shapes)))


def rollout_draws(cfg: EnvConfig, num_envs: int, steps: int,
                  generator: torch.Generator, device
                  ) -> Tuple[torch.Tensor, StepDraws]:
    """Uniform random actions (T, E, N) int32 and the step draws
    (``step_draws_seq``) of a random-action rollout of ``steps`` steps."""
    actions = torch.randint(0, cfg.num_actions,
                            (steps, num_envs, cfg.num_snakes),
                            generator=generator, device=device,
                            dtype=torch.int32)
    return actions, step_draws_seq(cfg, num_envs, steps, generator, device)


class TrainDraws(NamedTuple):
    """The draws of ``T`` training steps of ``E`` envs, step axis first;
    ``draws.at(t)`` is one step's."""
    rand: torch.Tensor       # (T, E, N) int32 in [0, num_actions)
    explore_u: torch.Tensor  # (T, E, N) float32: explores where < epsilon
    fruit_u: torch.Tensor    # (T, E, N) float32: fruit respawn
    # (T, capacity) float32 sort keys of the sample without replacement,
    # or (T, batch) uniforms scaled to an index when the batch exceeds
    # the ring (``replay.sample``)
    sample_u: torch.Tensor
    # (T, batch) slot indices that ARE the sample, in place of one drawn
    # from ``sample_u``: how a test hands over the indices the JAX ring
    # draws with ``randint`` when it samples with replacement
    sample_idx: Optional[torch.Tensor] = None

    def at(self, t: int) -> 'TrainDraws':
        return TrainDraws(*(None if x is None else x[t] for x in self))


def train_draws(cfg: EnvConfig, num_envs: int, num_steps: int,
                capacity: int, batch_size: int, generator: torch.Generator,
                device) -> TrainDraws:
    shape = (num_steps, num_envs, cfg.num_snakes)
    rand = torch.randint(0, cfg.num_actions, shape, generator=generator,
                         device=device, dtype=torch.int32)
    width = capacity if batch_size <= capacity else batch_size
    return TrainDraws(rand, _rand(shape, generator, device),
                      _rand(shape, generator, device),
                      _rand((num_steps, width), generator, device))


class PPODraws(NamedTuple):
    """The draws of one PPO update of ``T`` rollout steps of ``E`` envs."""
    # the step draws of every rollout step, step axis first
    step: StepDraws
    gumbel: torch.Tensor  # (T, E, N, A) float32: the action sample's noise
    perm: torch.Tensor    # (update_epochs, T * E * N) int64: minibatch order

    def step_at(self, t: int) -> StepDraws:
        return self.step.at(t)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` of uniforms kept above the
    smallest normal float32 (as JAX's ``random.gumbel`` keeps them)."""
    u = _rand(shape, generator, device).clamp_min_(
        torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def ppo_draws(cfg: EnvConfig, num_envs: int, rollout_steps: int,
              update_epochs: int, generator: torch.Generator,
              device) -> PPODraws:
    t, n = rollout_steps, cfg.num_snakes
    step = step_draws_seq(cfg, num_envs, t, generator, device)
    noise = _gumbel((t, num_envs, n, cfg.num_actions), generator, device)
    samples = t * num_envs * n
    perm = torch.stack([torch.randperm(samples, generator=generator,
                                       device=device)
                        for _ in range(update_epochs)])
    return PPODraws(step, noise, perm)


def derive_seed(*parts: int) -> int:
    """A 63-bit seed for a generator of its own, derived from integers
    (numpy's ``SeedSequence``): the port's counterpart of ``fold_in``,
    e.g. ``derive_seed(seed, episode)``."""
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return int(state[0]) | (int(state[1]) & 0x7FFFFFFF) << 32


RESET_STREAM, STEP_STREAM = 0, 1


def rank_seed(seed: int, rank: int, stream: int = STEP_STREAM) -> int:
    """The seed of data-parallel rank ``rank``'s generator of ``stream``:
    the counterpart of the JAX trainers' per-device streams,
    ``fold_in(key, axis_index)``. A DQN rank draws its resets
    (``RESET_STREAM``) and its steps (``STEP_STREAM``) from two
    generators, as JAX folds its reset and step keys apart."""
    return derive_seed(seed + 1, stream, rank)


class EpisodeDraws(NamedTuple):
    """The draws of ``E`` distinct episodes of up to ``T`` steps without
    reset, every env stepped every step: one reset each and the fruit
    draws of every step. A fitness episode of the evolution trainers has
    ``E = 1``, its one env's draws shared by every member of the
    population (common random numbers)."""
    reset: ResetDraws
    fruit_u: torch.Tensor  # (T, E, N) float32: fruit respawn

    def take(self, rows: torch.Tensor) -> 'EpisodeDraws':
        """The draws of the envs ``rows`` (indices into E, repeats
        allowed), as new contiguous tensors, as the step kernel takes
        them."""
        rows = rows.to(self.fruit_u.device)
        return EpisodeDraws(
            ResetDraws(self.reset.spawn_u[rows], self.reset.fruit_u[rows]),
            self.fruit_u[:, rows].contiguous())


def episode_draws(cfg: EnvConfig, num_envs: int, steps: int,
                  generator: torch.Generator, device) -> EpisodeDraws:
    return EpisodeDraws(reset_draws(cfg, num_envs, generator, device),
                        _rand((steps, num_envs, cfg.num_snakes), generator,
                              device))


class ESDraws(NamedTuple):
    """One generation of the head ES: the antithetic perturbations and
    the fitness episodes (each with E = 1, shared by every member)."""
    eps_k: torch.Tensor  # (half, inputs, A) float32 standard normals
    eps_b: torch.Tensor  # (half, A) float32 standard normals
    episodes: tuple      # of EpisodeDraws


def es_draws(cfg: EnvConfig, half: int, inputs: int, episodes: int,
             steps: int, generator: torch.Generator, device) -> ESDraws:
    a = cfg.num_actions
    eps_k = torch.randn((half, inputs, a), generator=generator,
                        device=device, dtype=torch.float32)
    eps_b = torch.randn((half, a), generator=generator, device=device,
                        dtype=torch.float32)
    return ESDraws(eps_k, eps_b, tuple(
        episode_draws(cfg, 1, steps, generator, device)
        for _ in range(episodes)))


class BattleDraws(NamedTuple):
    """The draws of one batched battle of ``E`` envs and up to ``T``
    steps: one reset each, the fruit draws of every step, and ``seat[i]``,
    what the opponent in seat ``i + 1`` draws a step: the greedy
    fruit-seeker's tie-break uniforms (T, E, 3) float32, a random seat's
    actions (T, E) int32 in [0, 3), or None for a policy that draws
    nothing."""
    reset: ResetDraws
    fruit_u: torch.Tensor  # (T, E, N) float32: fruit respawn
    seat: tuple


def battle_draws(cfg: EnvConfig, seat_kinds, num_envs: int, steps: int,
                 generator: torch.Generator, device) -> BattleDraws:
    """``seat_kinds``: what each opponent draws a step (the ``draws``
    attribute of its policy in ``algo/battle_batch.py``): 'tiebreak',
    'action' or None."""
    reset = reset_draws(cfg, num_envs, generator, device)
    fruit = _rand((steps, num_envs, cfg.num_snakes), generator, device)
    seats = []
    for kind in seat_kinds:
        if kind == 'tiebreak':
            seats.append(_rand((steps, num_envs, 3), generator, device))
        elif kind == 'action':
            seats.append(torch.randint(0, 3, (steps, num_envs),
                                       generator=generator, device=device,
                                       dtype=torch.int32))
        elif kind is None:
            seats.append(None)
        else:
            raise ValueError(f"unknown seat draw {kind!r}; choose from "
                             f"'tiebreak', 'action' or None")
    return BattleDraws(reset, fruit, tuple(seats))


class DistillDraws(NamedTuple):
    """The draws of one outer iteration of the distillation: its
    rollout's ``T`` steps of ``E`` envs (``step_draws_seq``) and the
    buffer rows of each SGD step's minibatch."""
    step: StepDraws
    idx: torch.Tensor  # (sgd_steps, batch) int64 in [0, T * E * N)

    def step_at(self, t: int) -> StepDraws:
        return self.step.at(t)


def distill_draws(cfg: EnvConfig, num_envs: int, rollout_steps: int,
                  sgd_steps: int, batch: int, generator: torch.Generator,
                  device) -> DistillDraws:
    """The rollout's step draws, then the minibatch indices, uniform over
    the ``rollout_steps * num_envs * num_snakes`` rows of the buffer, as
    JAX's ``random.randint(k, (batch,), 0, rows)`` draws them."""
    step = step_draws_seq(cfg, num_envs, rollout_steps, generator, device)
    rows = rollout_steps * num_envs * cfg.num_snakes
    idx = torch.randint(0, rows, (sgd_steps, batch), generator=generator,
                        device=device, dtype=torch.int64)
    return DistillDraws(step, idx)
