"""Vectorized environments: one batch of envs as tensors on one device.

With ``autoreset=True`` (the default), an env whose episode ends is reset
inside the same step: the returned state and obs are the fresh episode's,
while reward, done and the stats describe the finished step. On CUDA a
step is one launch of the hand-written kernel (``ops/step_kernel.py``),
with or without auto-reset; on the CPU it is the plain version,
``engine.step_autoreset`` or ``engine.step``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from marlsnake_torch.core import engine
from marlsnake_torch.core.state import EnvState
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.ops import rays, step_kernel
from marlsnake_torch.rng import (ResetDraws, StepDraws, reset_draws,
                                 step_draws)


def build_vector_fns(cfg: EnvConfig, autoreset: bool = True,
                     device='cuda'):
    """Return (reset_fn, step_fn) over batched states on ``device``.

    ``reset_fn(draws: ResetDraws) -> (states, obs)``;
    ``step_fn(states, actions (B, N), draws: StepDraws) -> (states, out)``.
    Without auto-reset the step uses only ``draws.fruit_u``, and takes
    ``hold=(keep (B,) bool, out)`` to leave the envs where ``keep`` is set
    as ``states`` and ``out`` have them (``step_kernel.step``). The
    procedural spawn makes no host pool and no tables.
    """
    tables = engine.spawn_tables(cfg, resolve_device(device))

    def reset_fn(draws: ResetDraws):
        return engine.reset(cfg, tables, draws)

    if autoreset:
        def step_fn(states, actions, draws: StepDraws):
            return step_kernel.step_autoreset(cfg, tables, states, actions,
                                              draws)
    else:
        def step_fn(states, actions, draws: StepDraws, hold=None):
            return step_kernel.step(cfg, states, actions, draws.fruit_u,
                                    hold)

    return reset_fn, step_fn


def state_rays(cfg: EnvConfig, states: EnvState, obs: torch.Tensor
               ) -> torch.Tensor:
    """Ray features (B, N, 5, C) float32 of ``states``, whose obs is
    ``obs``: from the carried grid(s) where those determine the obs, else
    from the obs (``ops/rays.py``)."""
    if rays.use_grid_rays(cfg):
        return rays.ray_features_from_grid(
            cfg, states.grid, states.head, states.direction, states.alive,
            states.hist_grid)
    return rays.ray_features(cfg, obs, states.head, states.direction,
                             states.alive)


def build_graph_vector_fns(cfg: EnvConfig, autoreset: bool = True,
                           device='cuda'):
    """``build_vector_fns`` with ray-feature observations (B, N, 5, C)
    float32 in place of the grid obs: the step (on CUDA the kernel
    launch), then the ray transform on the state it returned."""
    if cfg.obs_format != 'uint8' and not rays.use_grid_rays(cfg):
        raise ValueError(
            "obs_format='packed' needs the grid-rays fast path; the "
            'fallback ray transform reads uint8 channel planes '
            '(ops/rays.ray_features)')
    reset_fn, step_fn = build_vector_fns(cfg, autoreset, device)

    def reset_g(draws: ResetDraws):
        states, obs = reset_fn(draws)
        return states, state_rays(cfg, states, obs)

    def step_g(states, actions, draws: StepDraws, **hold):
        states, out = step_fn(states, actions, draws, **hold)
        return states, out.replace(obs=state_rays(cfg, states, out.obs))

    return reset_g, step_g


class VectorSnakeEnv:
    """A batch of ``num_envs`` envs on one device, with its own seeded
    ``torch.Generator`` for the spawn and fruit draws. ``graph=True``
    gives ray-feature observations."""

    def __init__(self, cfg: EnvConfig, num_envs: int,
                 autoreset: bool = True, device='cuda', seed: int = 0,
                 graph: bool = False):
        self.cfg = cfg
        self.num_envs = num_envs
        self.autoreset = autoreset
        self.graph = graph
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        build = build_graph_vector_fns if graph else build_vector_fns
        self._reset, self._step = build(cfg, autoreset, self.device)

    def reset(self, seed: Optional[int] = None
              ) -> Tuple[EnvState, torch.Tensor]:
        """Reset every env; reseeds the generator when ``seed`` is given."""
        if seed is not None:
            self.generator.manual_seed(seed)
        return self._reset(reset_draws(self.cfg, self.num_envs,
                                       self.generator, self.device))

    def step(self, states: EnvState, actions,
             draws: Optional[StepDraws] = None
             ) -> Tuple[EnvState, engine.StepOutput]:
        """Step every env with ``actions`` (B, N); the draws come from the
        env's generator unless given."""
        if draws is None:
            draws = step_draws(self.cfg, self.num_envs, self.generator,
                               self.device)
        actions = torch.as_tensor(actions, device=self.device)
        return self._step(states, actions, draws)

    @property
    def obs_shape(self):
        if self.graph:
            return (self.num_envs, self.cfg.num_snakes, 5,
                    self.cfg.obs_channels)
        return (self.num_envs,) + self.cfg.obs_shape

    @property
    def num_actions(self) -> int:
        return self.cfg.num_actions
