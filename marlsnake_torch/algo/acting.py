"""Batched epsilon-greedy acting for (E envs, N snakes) agents.

One DQN forward over all E*N agent observations, greedy argmax (first
maximum on ties), then per agent a uniform action with probability
``eps``. Agents that are done act 0, as in the reference trainer.
"""

from __future__ import annotations

import torch

from marlsnake_torch.models.dqn import DQN


@torch.no_grad()
def select_actions(net: DQN, obs: torch.Tensor, dones: torch.Tensor,
                   eps: float, generator: torch.Generator,
                   num_actions: int) -> torch.Tensor:
    """obs (E, N, H, W, C), dones (E, N) bool -> actions (E, N) int32."""
    e, n = obs.shape[:2]
    q = net(obs.reshape((e * n,) + tuple(obs.shape[2:])))
    greedy = q.argmax(-1).to(torch.int32).view(e, n)
    rand = torch.randint(0, num_actions, (e, n), generator=generator,
                         device=obs.device, dtype=torch.int32)
    explore = torch.rand((e, n), generator=generator,
                         device=obs.device) < eps
    acts = torch.where(explore, rand, greedy)
    return torch.where(dones, 0, acts).to(torch.int32)
