"""The plain reference of the two nets, their parameter layouts, and
clipped Adam, in plain torch. Imports nothing of the program.

Parameters are a dict of float32 tensors named as a ``torch.nn.Module``'s
state dict names them. Observations are (B, H, W, 8) uint8 one-hot
planes; the nets read them as float32, channels first.

* DQN: Conv 8->32->64->64 (3x3, stride 1, pad 1), ReLU after each;
  flatten (channels, rows, columns); FC 64*H*W -> 256 -> 128 -> A, ReLU
  between.
* ActorCritic: Conv 8->32 and 32->32 (3x3, pad 1), each followed by ReLU
  and a 2x2 max pool of stride 2; an average pool whose window and stride
  are ``(max(h // 2, 1), max(w // 2, 1))`` of what is left, cropped to
  at most 2x2; flatten (rows, columns, channels); actor 256 -> A and
  critic 256 -> 1 heads, ReLU between.
* Adam as optax computes it after a clip to a global norm: the gradients
  are kept where their global norm is under the limit and scaled by
  ``limit / norm`` elsewhere; both moments are bias-corrected by
  ``1 - decay ** count`` and the step is ``-lr * m_hat / (sqrt(v_hat) +
  eps)``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def dqn_layout(h: int, w: int, channels: int, actions: int
               ) -> List[Tuple[str, tuple]]:
    """(name, shape) of every DQN parameter, in the module's order."""
    convs = [('conv1', 32, channels), ('conv2', 64, 32), ('conv3', 64, 64)]
    fcs = [('fc1', 256, 64 * h * w), ('fc2', 128, 256), ('fc3', actions, 128)]
    out = []
    for name, o, i in convs:
        out += [(f'{name}.weight', (o, i, 3, 3)), (f'{name}.bias', (o,))]
    for name, o, i in fcs:
        out += [(f'{name}.weight', (o, i)), (f'{name}.bias', (o,))]
    return out


def _pooled(n: int) -> int:
    n = n // 2 // 2
    return min(n // max(n // 2, 1), 2)


def actor_critic_layout(h: int, w: int, channels: int, actions: int
                        ) -> List[Tuple[str, tuple]]:
    feats = 32 * _pooled(h) * _pooled(w)
    shapes = [('conv1', (32, channels, 3, 3)), ('conv2', (32, 32, 3, 3)),
              ('actor_fc1', (256, feats)), ('actor_fc2', (actions, 256)),
              ('critic_fc1', (256, feats)), ('critic_fc2', (1, 256))]
    out = []
    for name, shape in shapes:
        out += [(f'{name}.weight', shape), (f'{name}.bias', (shape[0],))]
    return out


def init_params(layout, generator: torch.Generator, device) -> Params:
    """Weights from ONE normal draw on the device, each scaled to a
    standard deviation of ``1 / sqrt(fan_in)`` and clamped at two of
    them; zero biases."""
    weights = [(n, s) for n, s in layout if n.endswith('weight')]
    sizes = [torch.Size(s).numel() for _, s in weights]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=torch.float32)
    out = {}
    for (name, shape), part in zip(weights, flat.split(sizes)):
        fan_in = torch.Size(shape[1:]).numel()
        std = fan_in ** -0.5
        out[name] = (part * std).clamp_(-2 * std, 2 * std).view(shape)
    return {n: out[n] if n in out else torch.zeros(s, device=device)
            for n, s in layout}


def _conv(p: Params, name: str, x):
    return F.relu(F.conv2d(x, p[f'{name}.weight'], p[f'{name}.bias'],
                           padding=1))


def _fc(p: Params, name: str, x):
    return F.linear(x, p[f'{name}.weight'], p[f'{name}.bias'])


def dqn(p: Params, obs: torch.Tensor) -> torch.Tensor:
    """Q-values (B, A) of obs (B, H, W, 8)."""
    x = obs.to(torch.float32).permute(0, 3, 1, 2)
    for name in ('conv1', 'conv2', 'conv3'):
        x = _conv(p, name, x)
    x = F.relu(_fc(p, 'fc1', x.flatten(1)))
    x = F.relu(_fc(p, 'fc2', x))
    return _fc(p, 'fc3', x)


def actor_critic(p: Params, obs: torch.Tensor):
    """(logits (B, A), value (B,)) of obs (B, H, W, 8)."""
    x = obs.to(torch.float32).permute(0, 3, 1, 2)
    for name in ('conv1', 'conv2'):
        x = F.max_pool2d(_conv(p, name, x), 2, 2)
    h, w = x.shape[2:]
    win = (max(h // 2, 1), max(w // 2, 1))
    x = F.avg_pool2d(x, win, win)[:, :, :2, :2]
    f = x.permute(0, 2, 3, 1).flatten(1)
    logits = _fc(p, 'actor_fc2', F.relu(_fc(p, 'actor_fc1', f)))
    value = _fc(p, 'critic_fc2', F.relu(_fc(p, 'critic_fc1', f)))
    return logits, value[:, 0]


class Adam:
    """Clipped Adam over a ``Params`` dict; the moments are kept by name."""

    def __init__(self, params: Params, lr: float, eps: float,
                 max_norm: float, b1: float = 0.9, b2: float = 0.999):
        self.lr, self.eps, self.max_norm = lr, eps, max_norm
        self.b1, self.b2 = b1, b2
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Params, grads: Params) -> Params:
        norm = torch.stack([(g * g).sum() for g in grads.values()]).sum() \
            .sqrt()
        if float(norm) >= self.max_norm:
            grads = {k: g / norm * self.max_norm for k, g in grads.items()}
        self.count += 1
        b1, b2 = self.b1, self.b2
        # the bias corrections in float32, as optax computes them
        count = torch.tensor(self.count, dtype=torch.int32)
        c1, c2 = float(1 - b1 ** count), float(1 - b2 ** count)
        out = {}
        for k, g in grads.items():
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * (g * g) + b2 * self.nu[k]
            m_hat = self.mu[k] / c1
            v_hat = self.nu[k] / c2
            out[k] = params[k] - self.lr * m_hat / (v_hat.sqrt() + self.eps)
        return out


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 in cuBLAS and cuDNN on (the control's precision) or off."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def grads_of(loss_fn, params: Params):
    """(loss, gradients by name) of ``loss_fn(params)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
