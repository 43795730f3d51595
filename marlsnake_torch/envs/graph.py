"""GraphSnakeEnv: SnakeEnv with ray-feature observations.

The same dynamics as ``SnakeEnv``; each obs becomes 5 distance-weighted
rays a snake (``ops/rays.py``), ``(num_snakes, 5, 8 * frame_stack)``
float32, with zeros in the rows of dead snakes.
"""

from __future__ import annotations

import numpy as np

from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.env import SnakeEnv
from marlsnake_torch.envs.vector import state_rays


class GraphSnakeEnv(SnakeEnv):
    """Usage is ``SnakeEnv``'s; only ``observer='snake'`` is supported."""

    def __init__(self, cfg: EnvConfig, device='cuda', seed: int = 0):
        if cfg.observer != 'snake':
            raise ValueError(
                "GraphSnakeEnv supports only observer='snake' "
                '(same restriction as graph_snake_env.py:47-49)')
        super().__init__(cfg, device=device, seed=seed)

    def reset(self, seed=None, draws=None):
        state, obs = super().reset(seed, draws)
        return state, state_rays(self.cfg, state, obs[None])[0]

    def step(self, state, actions, fruit_u=None):
        state, out = super().step(state, actions, fruit_u)
        return state, out.replace(
            obs=state_rays(self.cfg, state, out.obs[None])[0])

    @property
    def obs_shape(self):
        return (self.cfg.num_snakes, 5, self.cfg.obs_channels)

    @property
    def obs_dtype(self):
        return np.float32
