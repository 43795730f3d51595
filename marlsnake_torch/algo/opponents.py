"""Opponent zoo for evaluation battles.

The port of the JAX package's ``algo/opponents.py``, counterparts of the
reference's external agents (train_dqn.py:678-856): ``RandomAgent``
(ExternalAgentBase), ``GreedyAgent`` (masked Manhattan fruit-seeker),
``PPOAgent`` (actor-critic policy), ``DQNAgent`` (unmasked greedy DQN)
and ``NEATAgent`` (frozen-DQN features -> evolved NEAT net).

Each agent decides from one snake's obs, a numpy (H, W, C) uint8 frame.
The random and greedy agents draw from a ``random.Random`` handed in
(the JAX agents call the module-level ``random``): they make the same
``choice`` calls on the same lists, so one ``random.Random(s)`` shared by
the agents consumes what ``random.seed(s)`` does on the JAX side. The
nets run on their own device, the NEAT head on the host.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from marlsnake_torch.algo.evaluator import DEADLY_CHANNELS
from marlsnake_torch.algo.neat import FeedForwardNetwork
from marlsnake_torch.algo.neat_hybrid import as_dqn
from marlsnake_torch.core import types as T
from marlsnake_torch.device import resolve_device


class AgentBase:
    def __init__(self, agent_id: int):
        self.agent_id = agent_id
        self.name = f'Agent_{agent_id}'

    def reset(self):
        pass

    def get_action(self, obs: np.ndarray) -> int:
        raise NotImplementedError


class RandomAgent(AgentBase):
    """Uniform random over {0, 1, 2} (train_dqn.py:678-694)."""

    def __init__(self, agent_id: int, rng: random.Random):
        super().__init__(agent_id)
        self.rng = rng

    def get_action(self, obs):
        return self.rng.choice([0, 1, 2])


class GreedyAgent(AgentBase):
    """Masked Manhattan fruit-seeker (train_dqn.py:774-856); exact score
    ties are broken by ``rng.choice``."""

    def __init__(self, agent_id: int, rng: random.Random):
        super().__init__(agent_id)
        self.name = f'Greedy_FruitSeeker_{agent_id}'
        self.rng = rng
        self.current_direction: Optional[tuple] = None

    def reset(self):
        self.current_direction = None

    @staticmethod
    def _infer_direction(obs, hy, hx):
        """Direction of travel = away from the adjacent own-body cell
        (probed UP/DOWN/LEFT/RIGHT, first hit wins); UP if none."""
        h, w = obs.shape[:2]
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            by, bx = hy + dy, hx + dx
            if (0 <= by < h and 0 <= bx < w
                    and (obs[by, bx, T.CH_MY_BODY] == 1
                         or obs[by, bx, T.CH_MY_TAIL] == 1)):
                return (-dy, -dx)
        return (-1, 0)

    def get_action(self, obs):
        obs = np.asarray(obs)
        h, w = obs.shape[:2]
        head = np.argwhere(obs[:, :, T.CH_MY_HEAD] == 1)
        if len(head) == 0:
            return 0
        hy, hx = head[0]

        if self.current_direction is None:
            self.current_direction = self._infer_direction(obs, hy, hx)
        dy, dx = self.current_direction

        # row a of `moves` = {0: forward, 1: left, 2: right}
        moves = np.array([(dy, dx), (-dx, dy), (dx, -dy)])
        ny, nx = hy + moves[:, 0], hx + moves[:, 1]
        inb = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        deadly = obs[np.clip(ny, 0, h - 1), np.clip(nx, 0, w - 1)
                     ][:, list(DEADLY_CHANNELS)].any(axis=-1)
        legal = inb & ~deadly

        fruits = np.argwhere(obs[:, :, T.CH_FRUIT] == 1)
        if len(fruits) > 0:
            ty, tx = fruits[np.abs(fruits - (hy, hx)).sum(axis=1).argmin()]
            scores = -(np.abs(ny - ty) + np.abs(nx - tx)).astype(float)
        else:
            scores = np.zeros(3)
        scores = np.where(legal, scores, -np.inf)

        if not legal.any():
            chosen = 0
        else:
            chosen = self.rng.choice(
                np.flatnonzero(scores == scores.max()).tolist())
        self.current_direction = tuple(moves[chosen])
        return chosen


def _frame(net: torch.nn.Module, obs) -> torch.Tensor:
    """One agent's obs as a batch of one on the net's device."""
    dev = next(net.parameters()).device
    return torch.as_tensor(np.asarray(obs), device=dev)[None]


class PPOAgent(AgentBase):
    """Greedy actor policy of an ``ActorCritic`` (``models/ppo.py``)
    holding a PPO checkpoint's weights."""

    def __init__(self, agent_id: int, net: torch.nn.Module):
        super().__init__(agent_id)
        self.name = f'PPO_Agent_{agent_id}'
        self.net = net

    @torch.no_grad()
    def get_action(self, obs):
        return int(self.net(_frame(self.net, obs))[0][0].argmax())


class DQNAgent(AgentBase):
    """Greedy (unmasked) policy of a ``DQN`` (``models/dqn.py``)."""

    def __init__(self, agent_id: int, net: torch.nn.Module):
        super().__init__(agent_id)
        self.name = f'DQN_Agent_{agent_id}'
        self.net = net

    @torch.no_grad()
    def get_action(self, obs):
        return int(self.net(_frame(self.net, obs))[0].argmax())


class NEATAgent(AgentBase):
    """Frozen-DQN features -> NEAT decision head (HybridNEATEnemy,
    train_dqn.py:725-772). ``dqn`` is the port's ``DQN``, its state_dict
    or flax DQN parameters (a hybrid checkpoint's ``dqn_params``), built
    for ``cfg``'s obs on ``device``; the features run there, the NEAT net
    on the host."""

    def __init__(self, agent_id: int, dqn, genome, neat_config,
                 cfg: T.EnvConfig, device='cuda'):
        super().__init__(agent_id)
        self.name = f'Hybrid_NEAT_{agent_id}'
        self.net = as_dqn(dqn, cfg, resolve_device(device))
        self.neat_net = FeedForwardNetwork.create(genome, neat_config)

    @torch.no_grad()
    def get_action(self, obs):
        feats = self.net.features(_frame(self.net, obs)).cpu().numpy()[0]
        return int(np.argmax(self.neat_net.activate(feats)))
