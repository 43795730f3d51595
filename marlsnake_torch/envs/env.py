"""A single environment: the batched engine at a batch of one.

``SnakeEnv.step`` is the plain step without auto-reset, as in the JAX
package: after the episode ends, the caller resets. The state keeps its
batch axis of one; the obs and the step output are those of the one env.
On CUDA a step is one launch of the step kernel's entry without
auto-reset at B=1 (``step_kernel.step``); on the CPU it is the plain
``engine.step``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from marlsnake_torch.core import engine
from marlsnake_torch.core.spawn import spawn_candidates
from marlsnake_torch.core.state import EnvState
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.rng import ResetDraws, reset_draws


class SnakeEnv:
    """Usage::

        env = make_env(EnvConfig(height=20, width=20, num_snakes=4))
        state, obs = env.reset(seed=0)       # obs cfg.obs_shape, uint8
        state, out = env.step(state, torch.zeros(4, dtype=torch.int32))

    The draws come from the env's generator unless given: ``reset(draws=
    ResetDraws)`` of one env, ``step(..., fruit_u=(1, N) float32)``.
    """

    def __init__(self, cfg: EnvConfig, device='cuda', seed: int = 0):
        if cfg.map_layout is not None:
            from marlsnake_torch.core.maps import parse_layout
            interior = int((~parse_layout(cfg.map_layout)).sum())
        else:
            interior = (cfg.height - 2) * (cfg.width - 2)
        if cfg.num_snakes * cfg.snake_length > interior:
            raise ValueError(
                f'{cfg.num_snakes} snakes of length {cfg.snake_length} '
                f'cannot fit on a {cfg.height}x{cfg.width} board '
                f'({interior} interior cells)')
        if cfg.spawn_mode != 'procedural' and spawn_candidates(
                cfg.height, cfg.width, cfg.snake_length,
                cfg.map_layout).shape[0] == 0:
            raise ValueError('no valid spawn positions for this config')
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.spawn = engine.spawn_tables(cfg, self.device)

    def reset(self, seed: Optional[int] = None,
              draws: Optional[ResetDraws] = None
              ) -> Tuple[EnvState, torch.Tensor]:
        """Reset; reseeds the generator when ``seed`` is given."""
        if seed is not None:
            self.generator.manual_seed(seed)
        if draws is None:
            draws = reset_draws(self.cfg, 1, self.generator, self.device)
        state, obs = self.reset_fn(draws)
        return state, obs[0]

    def step(self, state: EnvState, actions,
             fruit_u: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, engine.StepOutput]:
        actions = torch.as_tensor(actions, device=self.device).view(1, -1)
        if fruit_u is None:
            fruit_u = torch.rand((1, self.cfg.num_snakes),
                                 generator=self.generator,
                                 device=self.device)
        state, out = self.step_fn(state, actions, fruit_u)
        return state, engine.StepOutput(
            **{name: t[0] for name, t in out.fields()})

    # Batched variants (state, obs and output keep the env axis), for
    # composing into larger loops.
    def reset_fn(self, draws: ResetDraws) -> Tuple[EnvState, torch.Tensor]:
        return engine.reset(self.cfg, self.spawn, draws)

    def step_fn(self, state: EnvState, actions: torch.Tensor,
                fruit_u: torch.Tensor) -> Tuple[EnvState, engine.StepOutput]:
        return step_kernel.step(self.cfg, state, actions, fruit_u)

    @property
    def num_snakes(self) -> int:
        return self.cfg.num_snakes

    @property
    def obs_shape(self):
        return self.cfg.obs_shape

    @property
    def num_actions(self) -> int:
        return self.cfg.num_actions

    @property
    def obs_dtype(self):
        return np.uint8


def make_env(cfg: Optional[EnvConfig] = None, device='cuda', seed: int = 0,
             **kwargs) -> SnakeEnv:
    """Build an env from a config or reference-style kwargs (``height,
    width, num_snakes, snake_length, vision_range, frame_stack, observer,
    reward_dict, num_fruits, max_episode_steps``, and ``map``: a bundled
    map's name or a layout file's path)."""
    if cfg is None:
        reward_dict = kwargs.pop('reward_dict', None)
        if 'map' in kwargs:
            from marlsnake_torch.core.maps import load_layout
            kwargs['map_layout'] = load_layout(kwargs.pop('map'))
        cfg = EnvConfig.from_reward_dict(reward_dict, **kwargs)
    return SnakeEnv(cfg, device=device, seed=seed)
