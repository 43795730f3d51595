"""PPO actor-critic network, the port of the JAX package's ``ActorCritic``.

Two 3x3 SAME convolutions of 32 channels, each followed by ReLU and a 2x2
max pool of stride 2 (no padding: the size is floored), then an average
pool whose window and stride are ``(max(h // 2, 1), max(w // 2, 1))`` of
what is left, cropped to at most 2x2, so 128 features on most boards (32
on a board whose second pool leaves 1x1). Not ``adaptive_avg_pool2d``: the
window is the JAX package's arithmetic, which floors. An actor head
Dense(256) -> Dense(A) and a critic head Dense(256) -> Dense(1), ReLU
between.

The public call takes NHWC observations, the engine's layout; the
features are flattened in NHWC order, as flax flattens them, so that
flax's dense kernels map by a plain transpose (``models/weights.py``).
Without ``assume_binary_obs`` the input is divided by 255 where its
maximum over the batch exceeds 1. The parameters are float32; with
``compute_dtype=torch.bfloat16`` the input, and each layer's weights as
it uses them, are cast to bfloat16, and logits and value come out as
float32, as the flax net's ``compute_dtype``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from marlsnake_torch.core.types import FEATURE_CHANNEL, EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.models.dqn import flax_init_, prepare_obs

CONV_CHANNELS = 32
HIDDEN = 256


def _pooled(n: int) -> int:
    """Rows (or columns) left of ``n`` after both max pools and the
    average pool and its crop."""
    n = n // 2 // 2
    window = max(n // 2, 1)
    return min(n // window, 2)


def feature_size(obs_hw) -> int:
    h, w = obs_hw
    if h < 4 or w < 4:
        raise ValueError(f'ActorCritic needs an obs of at least 4x4 (the '
                         f'two 2x2 pools leave no cell of {h}x{w})')
    return CONV_CHANNELS * _pooled(h) * _pooled(w)


class ActorCritic(nn.Module):
    def __init__(self, obs_hw, in_channels: int = 8, num_actions: int = 3,
                 assume_binary_obs: bool = False, device='cuda',
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.assume_binary_obs = assume_binary_obs
        self.compute_dtype = compute_dtype
        feats = feature_size(obs_hw)
        self.conv1 = nn.Conv2d(in_channels, CONV_CHANNELS, 3, padding=1,
                               device=dev)
        self.conv2 = nn.Conv2d(CONV_CHANNELS, CONV_CHANNELS, 3, padding=1,
                               device=dev)
        self.actor_fc1 = nn.Linear(feats, HIDDEN, device=dev)
        self.actor_fc2 = nn.Linear(HIDDEN, num_actions, device=dev)
        self.critic_fc1 = nn.Linear(feats, HIDDEN, device=dev)
        self.critic_fc2 = nn.Linear(HIDDEN, 1, device=dev)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x, layer.weight.to(dt), layer.bias.to(dt))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled features (B, 128 or fewer) in the compute dtype."""
        dt = self.compute_dtype
        x = prepare_obs(x, dt, self.assume_binary_obs).permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2):
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                                padding=1))
            x = F.max_pool2d(x, 2, 2)
        h, w = x.shape[2:]
        window = (max(h // 2, 1), max(w // 2, 1))
        x = F.avg_pool2d(x, window, window)[:, :, :2, :2]
        return x.permute(0, 2, 3, 1).flatten(1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, A), value (B,)), both float32, of NHWC
        observations (B, H, W, C)."""
        f = self.features(x)
        logits = self._linear(self.actor_fc2,
                              F.relu(self._linear(self.actor_fc1, f)))
        value = self._linear(self.critic_fc2,
                             F.relu(self._linear(self.critic_fc1, f)))
        return logits.to(torch.float32), value[:, 0].to(torch.float32)


def make_actor_critic(cfg: EnvConfig, seed: int = 0, device='cuda',
                      assume_binary_obs: bool = True,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> ActorCritic:
    """An ActorCritic for ``cfg``'s observations as uint8 planes, 8
    channels a stacked frame (packed obs are unpacked before the net),
    initialised as flax initialises the JAX ActorCritic
    (``models.dqn.flax_init_``), from ``seed`` on the CPU and then moved,
    so that the weights do not depend on the device."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = flax_init_(ActorCritic(
            (cfg.obs_height, cfg.obs_width),
            FEATURE_CHANNEL * cfg.frame_stack, cfg.num_actions,
            assume_binary_obs, device='cpu', compute_dtype=compute_dtype))
    return net.to(dev)
