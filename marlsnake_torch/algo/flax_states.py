"""JAX training states as the port's trainers' states: DQN's and PPO's
(``train_state_from_flax``, ``ppo_train_state_from_flax``), and one state
a rank of the JAX data-parallel trainers' (``dp_train_states_from_flax``,
``dp_ppo_train_states_from_flax``). The tests start both packages from
them."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from marlsnake_torch.algo import optim, replay
from marlsnake_torch.algo.dqn_trainer import TrainState
from marlsnake_torch.algo.ppo_trainer import PPOTrainState
from marlsnake_torch.core.state import EnvState
from marlsnake_torch.device import resolve_device
from marlsnake_torch.models.weights import (actor_critic_from_flax,
                                            dqn_from_flax)


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def train_state_from_flax(ts, grid_hw, device='cuda'):
    """A JAX ``dqn_trainer.TrainState`` whose leaves are numpy arrays (an
    object or a mapping with ``params``, ``target_params``, ``opt_state``,
    ``buffer``, ``epsilon``, ``episode`` and ``global_step``; its ``key``
    is not read) -> the port's ``TrainState`` on ``device``.

    ``opt_state`` is optax's for ``chain(clip_by_global_norm, adam)``:
    ``(ClipByGlobalNormState, (ScaleByAdamState(count, mu, nu),
    ScaleState))``; the moments take the parameters' axis permutations.
    The ring's ``capacity`` rows are copied into the port's ring, which
    has one spare row more.
    """
    dev = resolve_device(device)

    def params(tree):
        return {k: v.to(dev) for k, v in dqn_from_flax(tree, grid_hw).items()}

    opt_state = _adam_from_flax(_get(ts, 'opt_state'), params)
    jbuf = _get(ts, 'buffer')
    cap = np.asarray(_get(jbuf, 'obs')).shape[0]
    buf = replay.create(cap, tuple(_get(jbuf, 'obs_shape')), device=dev)
    for name, t in buf.fields():
        src = torch.as_tensor(np.array(_get(jbuf, name)), device=dev)
        if t.dim() == 0:
            setattr(buf, name, src.to(t.dtype))
        else:
            t[:cap] = src
    return TrainState(
        params=params(_get(ts, 'params')),
        target_params=params(_get(ts, 'target_params')),
        opt_state=opt_state, buffer=buf,
        epsilon=torch.as_tensor(np.array(_get(ts, 'epsilon'), np.float32),
                                device=dev),
        episode=int(_get(ts, 'episode')),
        global_step=int(_get(ts, 'global_step')))


def _adam_from_flax(opt_state, to_params):
    """optax ``chain(clip_by_global_norm, adam)`` state -> ``AdamState``:
    ``(ClipByGlobalNormState, (ScaleByAdamState(count, mu, nu), ...))``;
    the moments take the parameters' layouts through ``to_params``."""
    adam = opt_state[1][0]
    params = to_params(_get(adam, 'mu'))
    dev = next(iter(params.values())).device
    return optim.AdamState(
        torch.as_tensor(np.array(_get(adam, 'count'), np.int32), device=dev),
        list(params.values()), list(to_params(_get(adam, 'nu')).values()))


def ppo_train_state_from_flax(ts, device='cuda'):
    """A JAX ``ppo_trainer.PPOTrainState`` whose leaves are numpy arrays
    (an object or a mapping; its ``key`` is not read: the trainer's
    generator takes its place) -> the port's ``PPOTrainState`` on
    ``device``: parameters and Adam moments, every field of the env
    states the port has, obs, ``agent_done``, the counters and the
    episode-return accumulators."""
    dev = resolve_device(device)

    def params(tree):
        return {k: v.to(dev) for k, v in actor_critic_from_flax(tree).items()}

    def t(name, obj=ts):
        return torch.as_tensor(np.array(_get(obj, name)), device=dev)

    env = _get(ts, 'env_states')
    return PPOTrainState(
        params=params(_get(ts, 'params')),
        opt_state=_adam_from_flax(_get(ts, 'opt_state'), params),
        env_states=EnvState(**{f.name: t(f.name, env)
                               for f in dataclasses.fields(EnvState)}),
        obs=t('obs'), agent_done=t('agent_done'),
        update=int(_get(ts, 'update')), episodes=t('episodes'),
        ep_return_acc=t('ep_return_acc'),
        finished_return_sum=t('finished_return_sum'),
        finished_count=t('finished_count'))


def dp_train_states_from_flax(ts, grid_hw, world: int, device='cuda'):
    """A JAX ``parallel.dqn_dp.DistributedDQN`` state with numpy leaves
    (its ring holds ``world * capacity`` rows, ``ptr`` and ``size`` have
    shape ``(world,)``; dqn_dp.py:93-103) -> the port's ``TrainState`` of
    each rank: rank r's ring rows, ``ptr`` and ``size``, and the
    replicated fields, through ``train_state_from_flax``."""
    jbuf = _get(ts, 'buffer')
    cap = np.asarray(_get(jbuf, 'obs')).shape[0] // world
    states = []
    for r in range(world):
        buf = {name: np.asarray(_get(jbuf, name))[r * cap:(r + 1) * cap]
               for name in ('obs', 'action', 'reward', 'next_obs', 'done')}
        buf.update(ptr=np.asarray(_get(jbuf, 'ptr'))[r],
                   size=np.asarray(_get(jbuf, 'size'))[r],
                   obs_shape=_get(jbuf, 'obs_shape'))
        local = {name: _get(ts, name) for name in (
            'params', 'target_params', 'opt_state', 'epsilon', 'episode',
            'global_step')}
        states.append(train_state_from_flax(dict(local, buffer=buf),
                                            grid_hw, device))
    return states


def dp_ppo_train_states_from_flax(ts, world: int, device='cuda'):
    """A JAX ``parallel.ppo_dp.DistributedPPO`` state with numpy leaves ->
    the port's ``PPOTrainState`` of each rank: rank r's rows of the env
    states, ``obs``, ``agent_done`` and ``ep_return_acc``, and the
    replicated fields (ppo_dp.py:21-22), through
    ``ppo_train_state_from_flax``."""
    env = _get(ts, 'env_states')
    e = np.asarray(_get(ts, 'obs')).shape[0] // world
    states = []
    for r in range(world):
        def rows(x):
            return np.asarray(x)[r * e:(r + 1) * e]

        local = {name: _get(ts, name) for name in (
            'params', 'opt_state', 'update', 'episodes',
            'finished_return_sum', 'finished_count')}
        local['env_states'] = {f.name: rows(_get(env, f.name))
                               for f in dataclasses.fields(EnvState)}
        for name in ('obs', 'agent_done', 'ep_return_acc'):
            local[name] = rows(_get(ts, name))
        states.append(ppo_train_state_from_flax(local, device))
    return states
