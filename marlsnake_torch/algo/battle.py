"""Battle arena: masked-DQN vs an opponent lineup, one env at a time.

The port of the JAX package's ``algo/battle.py``, the counterpart of the
reference ``BattleArena`` (train_dqn.py:858-960): agent 0 plays with the
full safety-masked evaluator policy (``DQNEvaluator``'s), agents 1..N-1
are external agents from the opponent zoo (``algo/opponents.py``), which
act on numpy obs. The env is a ``GymAdapter``-style env (``reset() ->
obs``, ``step(list) -> (obs, rews, dones, info)``): on CUDA a step is one
launch of the step kernel's entry without auto-reset at B=1. Prints the
same per-algorithm mean reward / mean lifetime table.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from marlsnake_torch.algo.evaluator import DQNEvaluator
from marlsnake_torch.algo.opponents import AgentBase


class BattleArena:
    """``net`` is a ``DQN``, playing under ``params`` (a state_dict of its
    layout) when given, else its own weights."""

    def __init__(self, env, net, params,
                 external_agents: Sequence[AgentBase],
                 display_names: Optional[List[str]] = None,
                 flood_limit: int = 60):
        self.env = env
        n = env.num_snakes
        if len(external_agents) != n - 1:
            raise ValueError(f'need {n - 1} external agents for 1-vs-{n - 1}')
        self.external_agents = list(external_agents)
        self.display_names = display_names or (
            ['DQN (Main)'] + [a.name for a in self.external_agents])
        self.net = net
        self.params = params
        self._evaluator = DQNEvaluator(env, net, params, flood_limit)

    def run_battle(self, num_episodes: int = 10, render: bool = False,
                   max_steps: int = 512, verbose: bool = True):
        n = self.env.num_snakes
        dev = self._evaluator.device
        total_rewards = np.zeros(n)
        total_lifetimes = np.zeros(n)

        for ep in range(num_episodes):
            obs = self.env.reset()
            for a in self.external_agents:
                a.reset()
            dones = [False] * n
            dirs = torch.zeros((n, 2), dtype=torch.int32, device=dev)
            ep_rewards = np.zeros(n)
            ep_lifetimes = np.zeros(n)
            steps = 0
            while not all(dones) and steps < max_steps:
                if render:
                    self.env.render()
                actions = [0] * n
                if not dones[0]:
                    ep_lifetimes[0] += 1
                    active = torch.tensor([True] + [False] * (n - 1),
                                          device=dev)
                    acts, dirs = self._evaluator._policy(
                        torch.as_tensor(obs, device=dev), dirs, active)
                    actions[0] = int(acts[0])
                for i in range(1, n):
                    if not dones[i]:
                        ep_lifetimes[i] += 1
                        actions[i] = int(
                            self.external_agents[i - 1].get_action(obs[i]))
                obs, rewards, dones, _ = self.env.step(actions)
                ep_rewards += np.asarray(rewards)
                steps += 1
            total_rewards += ep_rewards
            total_lifetimes += ep_lifetimes
            if verbose:
                print(f'Episode {ep + 1:2d} Done. Steps: {steps}')

        if verbose:
            print('\n' + '=' * 65)
            print(f'{"ALGORITHM":<20} | {"MEAN REWARD":<18} | '
                  f'{"MEAN LIFETIME":<15}')
            print('-' * 65)
            for i in range(n):
                print(f'{self.display_names[i]:<20} | '
                      f'{total_rewards[i] / num_episodes:>18.2f} | '
                      f'{total_lifetimes[i] / num_episodes:>15.1f}')
            print('=' * 65 + '\n')
        return (total_rewards / num_episodes,
                total_lifetimes / num_episodes)
