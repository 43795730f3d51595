"""Batched epsilon-greedy acting for (E envs, N snakes) agents.

One DQN forward over all E*N agent observations, greedy argmax (first
maximum on ties), then per agent a uniform action with probability
``eps``. Agents that are done act 0, as in the reference trainer.
"""

from __future__ import annotations

import torch

from marlsnake_torch.models.dqn import DQN


def epsilon_greedy(q: torch.Tensor, dones: torch.Tensor, eps,
                   rand: torch.Tensor, explore_u: torch.Tensor
                   ) -> torch.Tensor:
    """Q-values (E*N, A) -> actions (E, N) int32 with the draws given:
    ``rand`` (E, N) int32 where ``explore_u`` (E, N) < ``eps`` (a number
    or a 0-d tensor), else the greedy action; 0 where ``dones``."""
    greedy = q.argmax(-1).to(torch.int32).view(dones.shape)
    acts = torch.where(explore_u < eps, rand, greedy)
    return torch.where(dones, 0, acts).to(torch.int32)


@torch.no_grad()
def select_actions(net: DQN, obs: torch.Tensor, dones: torch.Tensor,
                   eps: float, generator: torch.Generator,
                   num_actions: int) -> torch.Tensor:
    """obs (E, N, H, W, C), dones (E, N) bool -> actions (E, N) int32,
    with the draws taken from ``generator``."""
    e, n = obs.shape[:2]
    q = net(obs.reshape((e * n,) + tuple(obs.shape[2:])))
    rand = torch.randint(0, num_actions, (e, n), generator=generator,
                         device=obs.device, dtype=torch.int32)
    explore_u = torch.rand((e, n), generator=generator, device=obs.device)
    return epsilon_greedy(q, dones, eps, rand, explore_u)
