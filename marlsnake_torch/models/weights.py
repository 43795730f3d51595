"""DQN weights from flax parameters and from reference checkpoints.

The port's DQN flattens its conv activations in NCHW order, as the
reference's torch model does, so a reference ``state_dict`` loads as it
is. Flax's DQN flattens NHWC: its fc1 kernel's input axis is permuted
here, and conv kernels (kH, kW, I, O) and dense kernels (in, out) are
transposed to torch's (O, I, kH, kW) and (out, in).
"""

from __future__ import annotations

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


def dqn_from_reference(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state_dict (``shared_model_*.pth``, keys
    possibly prefixed ``module.`` by DataParallel) -> the port's."""
    return {k.replace('module.', ''): torch.as_tensor(v).detach().clone()
            for k, v in state_dict.items()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference DQN checkpoint file into the port's state_dict."""
    return dqn_from_reference(torch.load(path, map_location='cpu',
                                         weights_only=True))
