"""The random numbers a reset or a step consumes, drawn up front.

The engine and the CUDA step kernel take every random number as an input
tensor instead of deriving it inside: a reset needs one uniform to pick
its spawn-pool row and ``nf`` uniforms for its fruits; a step needs ``N``
uniforms for fruit respawn plus one reset's worth, used by the envs whose
episode ends. Draws come from an explicit ``torch.Generator``, so a run
is reproducible from its seed. They are not the JAX package's numbers (a
threefry key schedule); tests hand both packages the same draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from marlsnake_torch.core.types import EnvConfig


class ResetDraws(NamedTuple):
    spawn_u: torch.Tensor  # (B,) float32: spawn-pool row
    fruit_u: torch.Tensor  # (B, nf) float32: fruit cells


class StepDraws(NamedTuple):
    fruit_u: torch.Tensor        # (B, N) float32: fruit respawn
    reset_spawn_u: torch.Tensor  # (B,) float32: auto-reset pool row
    reset_fruit_u: torch.Tensor  # (B, nf) float32: auto-reset fruits


def _rand(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def reset_draws(cfg: EnvConfig, num_envs: int, generator: torch.Generator,
                device) -> ResetDraws:
    nf = cfg.resolved_num_fruits
    return ResetDraws(_rand((num_envs,), generator, device),
                      _rand((num_envs, nf), generator, device))


def step_draws(cfg: EnvConfig, num_envs: int, generator: torch.Generator,
               device) -> StepDraws:
    n, nf = cfg.num_snakes, cfg.resolved_num_fruits
    return StepDraws(_rand((num_envs, n), generator, device),
                     _rand((num_envs,), generator, device),
                     _rand((num_envs, nf), generator, device))
