"""Data-parallel DQN over the ranks of a mesh.

The ApeX-style layout of the JAX package's ``parallel/dqn_dp.py``: each
rank owns ``num_envs / world`` envs and a replay ring of its own; the
learner's parameters and optimizer state are replicated, and gradients
are averaged with one all-reduce per update (``DQNTrainer`` with a
``mesh``). Observations never leave their rank's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from marlsnake_torch.algo.dqn_trainer import (DQNConfig, DQNTrainer,
                                              EpisodeMetrics, TrainState)
from marlsnake_torch.parallel.mesh import Mesh, replicate_tree
from marlsnake_torch.rng import ResetDraws, TrainDraws


class DistributedDQN:
    """``config.num_envs`` is the GLOBAL env count; the mesh's world size
    must divide it. Every rank constructs one and calls the same methods
    in the same order."""

    def __init__(self, config: DQNConfig, mesh: Mesh):
        if config.num_envs % mesh.world != 0:
            raise ValueError(
                f'num_envs={config.num_envs} not divisible by '
                f'data-axis size {mesh.world}')
        self.config = config
        self.mesh = mesh
        local = dataclasses.replace(config,
                                    num_envs=config.num_envs // mesh.world)
        self.trainer = DQNTrainer(local, mesh=mesh)

    def init_state(self) -> TrainState:
        """This rank's state: a ring of ``buffer_size`` rows of its own
        (empty), and the parameters every rank built from the seed,
        broadcast from rank 0 with the optimizer state and epsilon."""
        ts = self.trainer.init_state()
        params = replicate_tree(ts.params, self.mesh)
        return ts.replace(
            params=params,
            target_params=params if ts.target_params is ts.params
            else replicate_tree(ts.target_params, self.mesh),
            opt_state=replicate_tree(ts.opt_state, self.mesh),
            epsilon=replicate_tree(ts.epsilon, self.mesh))

    def train_episode(self, ts: TrainState,
                      draws: Optional[TrainDraws] = None,
                      reset: Optional[ResetDraws] = None
                      ) -> Tuple[TrainState, EpisodeMetrics]:
        """One episode on every rank; ``draws`` and ``reset`` are this
        rank's, by default drawn from its own generators."""
        return self.trainer.train_episode(ts, draws, reset)
