"""Data-parallel PPO over the ranks of a mesh.

The layout of the JAX package's ``parallel/ppo_dp.py``: env states,
rollouts and GAE are split over the ranks; the actor-critic's parameters
and optimizer state are replicated, and each minibatch's gradients are
averaged (``PPOTrainer`` with a ``mesh``), which is one large-batch PPO
update over the global rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from marlsnake_torch.algo.ppo_trainer import (PPOConfig, PPOMetrics,
                                              PPOTrainer, PPOTrainState)
from marlsnake_torch.parallel.mesh import Mesh, replicate_tree, shard_rows
from marlsnake_torch.rng import PPODraws, ResetDraws, reset_draws

# what every rank holds alike; the env states, obs, agent_done and
# ep_return_acc are split by rows
_REPLICATED_FIELDS = ('params', 'opt_state', 'episodes',
                      'finished_return_sum', 'finished_count')


class DistributedPPO:
    """``config.num_envs`` is the GLOBAL env count; the mesh's world size
    must divide it. Every rank constructs one and calls the same methods
    in the same order."""

    def __init__(self, config: PPOConfig, mesh: Mesh):
        if config.num_envs % mesh.world != 0:
            raise ValueError(f'num_envs={config.num_envs} not divisible '
                             f'by data-axis size {mesh.world}')
        self.config = config
        self.mesh = mesh
        local = dataclasses.replace(config,
                                    num_envs=config.num_envs // mesh.world)
        self.trainer = PPOTrainer(local, mesh=mesh)

    def init_state(self) -> PPOTrainState:
        """This rank's rows of the global reset (``num_envs`` envs drawn
        from the seed, as ``PPOTrainer(config).init_state()`` draws them),
        and the replicated fields broadcast from rank 0."""
        tr = self.trainer
        gen = torch.Generator(device=tr.device)
        gen.manual_seed(self.config.seed + 1)
        reset = reset_draws(tr.env_cfg, self.config.num_envs, gen, tr.device)
        ts = tr.init_state(ResetDraws(*(shard_rows(x, self.mesh)
                                        for x in reset)))
        return ts.replace(**{f: replicate_tree(getattr(ts, f), self.mesh)
                             for f in _REPLICATED_FIELDS})

    def train_update(self, ts: PPOTrainState,
                     draws: Optional[PPODraws] = None
                     ) -> Tuple[PPOTrainState, PPOMetrics]:
        """One update on every rank; ``draws`` are this rank's, by default
        drawn from its own generator."""
        return self.trainer.update(ts, draws)
