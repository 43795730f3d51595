"""DQN and ActorCritic weights: flax's initialisation, and weights from
flax parameters and from reference checkpoints.

``flax_init_`` gives a net the initialisation flax gives the JAX
package's nets. The port's DQN flattens its conv activations in NCHW
order, as the reference's torch model does, so a reference ``state_dict``
loads as it is. Flax's DQN flattens NHWC: its fc1 kernel's input axis is
permuted here, and conv kernels (kH, kW, I, O) and dense kernels (in,
out) are transposed to torch's (O, I, kH, kW) and (out, in).
``dqn_to_flax`` is the inverse. The ActorCritic flattens NHWC in both
packages, so its kernels are transposed only (``actor_critic_from_flax``,
``actor_critic_to_flax``); so does the ``DistilledDQN``
(``distilled_dqn_from_flax``, and back with ``distilled_dqn_to_flax``).
Whole JAX training states go across in ``algo/flax_states.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def flax_init_(net: nn.Module) -> nn.Module:
    """Give every convolution and linear layer of ``net`` flax's default
    initialisation, as the JAX package's nets start: weights from
    ``variance_scaling(1.0, 'fan_in', 'truncated_normal')`` (lecun normal:
    a normal truncated to two standard deviations, scaled to variance
    ``1 / fan_in``, ``fan_in = in_ch * kh * kw`` for a convolution and
    ``in_features`` for a linear layer), and zero biases. Draws from
    torch's default generator; returns ``net``."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std)
                nn.init.zeros_(m.bias)
    return net


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
