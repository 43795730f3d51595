"""DQN and ActorCritic weights from flax parameters and from reference
checkpoints.

The port's DQN flattens its conv activations in NCHW order, as the
reference's torch model does, so a reference ``state_dict`` loads as it
is. Flax's DQN flattens NHWC: its fc1 kernel's input axis is permuted
here, and conv kernels (kH, kW, I, O) and dense kernels (in, out) are
transposed to torch's (O, I, kH, kW) and (out, in). ``dqn_to_flax`` is the
inverse, and ``train_state_from_flax`` carries a whole JAX training state
(parameters, Adam moments in the same layouts, replay ring, counters)
into the port's ``TrainState``. The ActorCritic flattens NHWC in both
packages, so its kernels are transposed only
(``actor_critic_from_flax``, ``actor_critic_to_flax``), and
``ppo_train_state_from_flax`` carries a JAX ``PPOTrainState`` across; so
does the ``DistilledDQN`` (``distilled_dqn_from_flax``, and back with
``distilled_dqn_to_flax``). The states of the
JAX data-parallel trainers split into one port state a rank
(``dp_train_states_from_flax``, ``dp_ppo_train_states_from_flax``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

_CONV_OUT = 64  # conv3 output channels


def _fc1_flax_rows(grid_hw) -> np.ndarray:
    """Row of the flax fc1 kernel for each torch (c, y, x) input index."""
    h, w = grid_hw
    idx = np.arange(_CONV_OUT * h * w)
    c, y, x = idx // (h * w), (idx % (h * w)) // w, idx % w
    return y * (w * _CONV_OUT) + x * _CONV_OUT + c


def dqn_from_flax(params: Mapping, grid_hw) -> Dict[str, torch.Tensor]:
    """Flax DQN params (nested dicts of arrays, with or without the
    top-level ``'params'``) -> the port's ``DQN`` state_dict."""
    p = params['params'] if 'params' in params else params

    def t(a):
        return torch.as_tensor(np.array(a))

    out = {}
    for name in ('conv1', 'conv2', 'conv3'):
        out[f'{name}.weight'] = t(np.transpose(np.asarray(p[name]['kernel']),
                                               (3, 2, 0, 1)))
        out[f'{name}.bias'] = t(p[name]['bias'])
    fc1 = np.asarray(p['fc1']['kernel'])[_fc1_flax_rows(grid_hw)]
    out['fc1.weight'] = t(fc1.T)
    out['fc1.bias'] = t(p['fc1']['bias'])
    for name in ('fc2', 'fc3'):
        out[f'{name}.weight'] = t(np.asarray(p[name]['kernel']).T)
        out[f'{name}.bias'] = t(p[name]['bias'])
    return out


def dqn_to_flax(state_dict: Mapping, grid_hw) -> Dict[str, dict]:
    """The inverse of ``dqn_from_flax``: a ``DQN`` state_dict (or any dict
    of that layout, such as gradients or Adam moments) as flax's
    ``{'params': {layer: {'kernel', 'bias'}}}`` of numpy arrays."""
    def a(t):
        return np.asarray(torch.as_tensor(t).detach().cpu())

    out = {}
    for name in ('conv1', 'conv2', 'conv3'):
        out[name] = {'kernel': np.transpose(a(state_dict[f'{name}.weight']),
                                            (2, 3, 1, 0)),
                     'bias': a(state_dict[f'{name}.bias'])}
    fc1 = np.empty_like(a(state_dict['fc1.weight']).T)
    fc1[_fc1_flax_rows(grid_hw)] = a(state_dict['fc1.weight']).T
    out['fc1'] = {'kernel': fc1, 'bias': a(state_dict['fc1.bias'])}
    for name in ('fc2', 'fc3'):
        out[name] = {'kernel': a(state_dict[f'{name}.weight']).T,
                     'bias': a(state_dict[f'{name}.bias'])}
    return {'params': out}


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
    from marlsnake_torch.algo import replay
    from marlsnake_torch.algo.dqn_trainer import TrainState
    from marlsnake_torch.device import resolve_device
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


_AC_CONVS = ('conv1', 'conv2')
_AC_DENSES = ('actor_fc1', 'actor_fc2', 'critic_fc1', 'critic_fc2')


def actor_critic_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ActorCritic params (with or without the top-level
    ``'params'``) -> the port's ``ActorCritic`` state_dict. Both flatten
    the pooled features in NHWC order, so every kernel is a transpose."""
    p = params['params'] if 'params' in params else params

    def t(a):
        return torch.as_tensor(np.array(a))

    out = {}
    for name in _AC_CONVS:
        out[f'{name}.weight'] = t(np.transpose(np.asarray(p[name]['kernel']),
                                               (3, 2, 0, 1)))
        out[f'{name}.bias'] = t(p[name]['bias'])
    for name in _AC_DENSES:
        out[f'{name}.weight'] = t(np.asarray(p[name]['kernel']).T)
        out[f'{name}.bias'] = t(p[name]['bias'])
    return out


def actor_critic_to_flax(state_dict: Mapping) -> Dict[str, dict]:
    """The inverse of ``actor_critic_from_flax``, for a state_dict or any
    dict of its layout (gradients, Adam moments)."""
    def a(t):
        return np.asarray(torch.as_tensor(t).detach().cpu())

    out = {}
    for name in _AC_CONVS:
        out[name] = {'kernel': np.transpose(a(state_dict[f'{name}.weight']),
                                            (2, 3, 1, 0)),
                     'bias': a(state_dict[f'{name}.bias'])}
    for name in _AC_DENSES:
        out[name] = {'kernel': a(state_dict[f'{name}.weight']).T,
                     'bias': a(state_dict[f'{name}.bias'])}
    return {'params': out}


def _adam_from_flax(opt_state, to_params):
    """optax ``chain(clip_by_global_norm, adam)`` state -> ``AdamState``:
    ``(ClipByGlobalNormState, (ScaleByAdamState(count, mu, nu), ...))``;
    the moments take the parameters' layouts through ``to_params``."""
    from marlsnake_torch.algo import optim
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
    from marlsnake_torch.algo.ppo_trainer import PPOTrainState
    from marlsnake_torch.core.state import EnvState
    from marlsnake_torch.device import resolve_device
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
    from marlsnake_torch.core.state import EnvState
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


_AC_REFERENCE_NAMES = {'CNN_feature.0': 'conv1', 'CNN_feature.3': 'conv2',
                       'actor.0': 'actor_fc1', 'actor.2': 'actor_fc2',
                       'critic.0': 'critic_fc1', 'critic.2': 'critic_fc2'}


def actor_critic_from_reference(state_dict: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The reference's PPO checkpoint (``CNN_feature.0/.3`` convolutions,
    ``actor.0/.2`` and ``critic.0/.2`` linears; keys possibly prefixed
    ``module.``) -> the port's ``ActorCritic`` state_dict. Both use
    torch's layouts, so the tensors are renamed, not transposed. The heads
    map exactly; the reference's pooling between its convolutions left the
    repository with its source module, so the trunk computes the same
    function only as far as the port's pooling is the reference's."""
    sd = {k.replace('module.', ''): v for k, v in state_dict.items()}
    return {f'{ours}.{leaf}': torch.as_tensor(sd[f'{theirs}.{leaf}'])
            .detach().clone()
            for theirs, ours in _AC_REFERENCE_NAMES.items()
            for leaf in ('weight', 'bias')}


def actor_critic_to_reference(state_dict: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """The inverse of ``actor_critic_from_reference``: the port's
    ``ActorCritic`` state_dict in the reference's PPO layout, on the
    CPU."""
    return {f'{theirs}.{leaf}': state_dict[f'{ours}.{leaf}']
            .detach().cpu().clone()
            for theirs, ours in _AC_REFERENCE_NAMES.items()
            for leaf in ('weight', 'bias')}


def distilled_dqn_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``DistilledDQN`` params (``Conv_i``, ``Dense_j``, with or
    without the top-level ``'params'``) -> the port's ``DistilledDQN``
    state_dict: the convolutions ``convs.i``, the hidden dense layers
    ``fcs.j`` and the last dense layer ``head``. Both flatten NHWC, so
    every kernel is a transpose."""
    p = params['params'] if 'params' in params else params
    convs = sorted((k for k in p if k.startswith('Conv_')),
                   key=lambda k: int(k.split('_')[1]))
    denses = sorted((k for k in p if k.startswith('Dense_')),
                    key=lambda k: int(k.split('_')[1]))

    def t(a):
        return torch.as_tensor(np.array(a))

    out = {}
    for i, name in enumerate(convs):
        out[f'convs.{i}.weight'] = t(np.transpose(
            np.asarray(p[name]['kernel']), (3, 2, 0, 1)))
        out[f'convs.{i}.bias'] = t(p[name]['bias'])
    for j, name in enumerate(denses):
        ours = 'head' if j == len(denses) - 1 else f'fcs.{j}'
        out[f'{ours}.weight'] = t(np.asarray(p[name]['kernel']).T)
        out[f'{ours}.bias'] = t(p[name]['bias'])
    return out


def distilled_dqn_to_flax(state_dict: Mapping) -> Dict[str, dict]:
    """The inverse of ``distilled_dqn_from_flax``: a ``DistilledDQN``
    state_dict (or any dict of its layout, such as Adam moments) as
    flax's ``{'params': {'Conv_i' / 'Dense_j': {'kernel', 'bias'}}}`` of
    numpy arrays, the head the last ``Dense``."""
    def a(t):
        return np.asarray(torch.as_tensor(t).detach().cpu())

    def layers(prefix):
        return sorted({int(k.split('.')[1]) for k in state_dict
                       if k.startswith(prefix)})

    out = {}
    for i in layers('convs.'):
        out[f'Conv_{i}'] = {
            'kernel': np.transpose(a(state_dict[f'convs.{i}.weight']),
                                   (2, 3, 1, 0)),
            'bias': a(state_dict[f'convs.{i}.bias'])}
    denses = [f'fcs.{j}' for j in layers('fcs.')] + ['head']
    for j, name in enumerate(denses):
        out[f'Dense_{j}'] = {'kernel': a(state_dict[f'{name}.weight']).T,
                             'bias': a(state_dict[f'{name}.bias'])}
    return {'params': out}


def dqn_from_reference(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state_dict (``shared_model_*.pth``, keys
    possibly prefixed ``module.`` by DataParallel) -> the port's."""
    return {k.replace('module.', ''): torch.as_tensor(v).detach().clone()
            for k, v in state_dict.items()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference DQN checkpoint file into the port's state_dict."""
    return dqn_from_reference(torch.load(path, map_location='cpu',
                                         weights_only=True))
