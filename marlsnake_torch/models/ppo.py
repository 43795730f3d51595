"""PPO actor-critic network, the port of the JAX package's ``ActorCritic``.

Two 3x3 SAME convolutions of 32 channels, each followed by ReLU and a 2x2
max pool of stride 2 (no padding: the size is floored), then an average
pool whose window and stride are ``(max(h // 2, 1), max(w // 2, 1))`` of
what is left, cropped to at most 2x2, so 128 features on most boards (32
on a board whose second pool leaves 1x1). Not ``adaptive_avg_pool2d``: the
window is the JAX package's arithmetic, which floors. An actor head
Dense(256) -> Dense(A) and a critic head Dense(256) -> Dense(1), ReLU
between. On the card, in float32, the trunk (both convolutions and
pools) is one hand-written kernel each way (``ops/ppo_trunk.py``,
``csrc/ppo_trunk.cu``).

The public call takes NHWC observations, the engine's layout, as uint8
planes; a net built for packed obs unpacks them in its ``ingress``. The
features are flattened in NHWC order, as flax flattens them, so that
flax's dense kernels map by a plain transpose (``models/weights.py``).
Without ``assume_binary_obs`` the input is divided by 255 where its
maximum over the batch exceeds 1. The parameters are float32; with
``compute_dtype=torch.bfloat16`` the input, and each layer's weights as
it uses them, are cast to bfloat16, and logits and value come out as
float32, as the flax net's ``compute_dtype``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from marlsnake_torch.core.types import FEATURE_CHANNEL, EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.models.weights import flax_init_
from marlsnake_torch.ops import ppo_trunk
from marlsnake_torch.ops.obs_pack import unpack_obs

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


def _as_emitted(obs: torch.Tensor) -> torch.Tensor:
    return obs


class ActorCritic(nn.Module):
    def __init__(self, obs_hw, in_channels: int = 8, num_actions: int = 3,
                 assume_binary_obs: bool = False, device='cuda',
                 compute_dtype: torch.dtype = torch.float32,
                 packed: bool = False):
        super().__init__()
        dev = resolve_device(device)
        ppo_trunk.check_served(in_channels, dev, compute_dtype)
        self.assume_binary_obs = assume_binary_obs
        self.compute_dtype = compute_dtype
        # the obs as the envs emit them -> the planes ``forward`` takes
        self.ingress = unpack_obs if packed else _as_emitted
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
        """Pooled features (B, 128 or fewer) in the compute dtype: the
        hand-written kernel for float32 on the card, else the plain
        PyTorch trunk (``ops/ppo_trunk.trunk``)."""
        return ppo_trunk.trunk(x, self.conv1.weight, self.conv1.bias,
                               self.conv2.weight, self.conv2.bias,
                               self.compute_dtype, self.assume_binary_obs)

    def forward(self, x: torch.Tensor, phases: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, A), value (B,)), both float32, of NHWC
        observations (B, H, W, C); ``phases`` is taken and ignored: the
        net places no tracer marks."""
        f = self.features(x)
        logits = self._linear(self.actor_fc2,
                              F.relu(self._linear(self.actor_fc1, f)))
        value = self._linear(self.critic_fc2,
                             F.relu(self._linear(self.critic_fc1, f)))
        return logits.to(torch.float32), value[:, 0].to(torch.float32)

    def initial_state(self) -> Dict[str, torch.Tensor]:
        """A copy of the net's own ``state_dict``: the weights
        ``make_actor_critic`` drew from its seed."""
        return {k: v.detach().clone() for k, v in self.state_dict().items()}


def make_actor_critic(cfg: EnvConfig, seed: int = 0, device='cuda',
                      assume_binary_obs: bool = True,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> ActorCritic:
    """An ActorCritic for ``cfg``'s observations as uint8 planes, 8
    channels a stacked frame (packed obs are unpacked by its ``ingress``),
    initialised as flax initialises the JAX ActorCritic
    (``models.weights.flax_init_``), from ``seed`` on the CPU and then moved,
    so that the weights do not depend on the device."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = flax_init_(ActorCritic(
            (cfg.obs_height, cfg.obs_width),
            FEATURE_CHANNEL * cfg.frame_stack, cfg.num_actions,
            assume_binary_obs, device='cpu', compute_dtype=compute_dtype,
            packed=cfg.obs_format == 'packed'))
    return net.to(dev)
