"""DQN network with the reference shared model's topology.

Conv(C -> 32 -> 64 -> 64, 3x3, stride 1, pad 1) -> FC(64*H*W -> 256 -> 128
-> num_actions), ReLU throughout; ``features`` returns the 128-d
penultimate embedding. The public call takes NHWC observations, the
engine's layout, and permutes to NCHW for the convolutions; the flatten
before fc1 is in NCHW order, so the parameters are laid out as the
reference's torch checkpoints (``models/weights.py`` converts flax
parameters). Without ``assume_binary_obs`` the input is divided by 255
when its maximum over the batch exceeds 1, as in the reference.

The parameters are float32. With ``compute_dtype=torch.bfloat16`` the
input, and each layer's weights as it uses them, are cast to bfloat16,
the convolutions and products run in bfloat16, and the Q-values come out
as float32: the flax DQN's ``compute_dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from marlsnake_torch.core.types import FEATURE_CHANNEL, EnvConfig
from marlsnake_torch.device import resolve_device


def prepare_obs(x: torch.Tensor, compute_dtype: torch.dtype,
                assume_binary_obs: bool) -> torch.Tensor:
    """NHWC observations as a batch in ``compute_dtype``, divided by 255
    where the batch's maximum exceeds 1 unless ``assume_binary_obs``."""
    if x.dim() == 3:
        x = x[None]
    if assume_binary_obs:
        return x.to(compute_dtype)
    x = x.to(torch.float32)
    return torch.where(x.max() > 1.0, x / 255.0, x).to(compute_dtype)


class DQN(nn.Module):
    def __init__(self, grid_hw, in_channels: int = 8, num_actions: int = 3,
                 assume_binary_obs: bool = False, device='cuda',
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = grid_hw
        dev = resolve_device(device)
        self.assume_binary_obs = assume_binary_obs
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(in_channels, 32, 3, padding=1, device=dev)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, device=dev)
        self.conv3 = nn.Conv2d(64, 64, 3, padding=1, device=dev)
        self.fc1 = nn.Linear(64 * h * w, 256, device=dev)
        self.fc2 = nn.Linear(256, 128, device=dev)
        self.fc3 = nn.Linear(128, num_actions, device=dev)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = prepare_obs(x, dt, self.assume_binary_obs).permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                                padding=1))
        x = x.flatten(1)
        for fc in (self.fc1, self.fc2):
            x = F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Q-values (B, num_actions), float32, of NHWC observations
        (B, H, W, C)."""
        dt = self.compute_dtype
        return F.linear(self._trunk(x), self.fc3.weight.to(dt),
                        self.fc3.bias.to(dt)).to(torch.float32)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """128-d penultimate embedding, float32."""
        return self._trunk(x).to(torch.float32)


class DistilledDQN(nn.Module):
    """The small acting trunk distilled from the reference-topology DQN,
    the JAX package's ``DistilledDQN``: 3x3 SAME convolutions of
    ``conv_channels`` (16, 32), dense ``fc_features`` (64), then the
    Q-values, ReLU throughout, computed in ``compute_dtype`` (bfloat16 by
    default; float32 parameters, float32 Q-values out). An opt-in acting
    trade: checkpoints and training stay on ``DQN``. The flatten before
    the first dense layer is in NHWC order, as flax's, so flax's kernels
    map by a transpose (``models/weights.distilled_dqn_from_flax``)."""

    def __init__(self, grid_hw, in_channels: int = 8, num_actions: int = 3,
                 conv_channels=(16, 32), fc_features=(64,),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 assume_binary_obs: bool = True, device='cuda'):
        super().__init__()
        h, w = grid_hw
        dev = resolve_device(device)
        self.assume_binary_obs = assume_binary_obs
        self.compute_dtype = compute_dtype
        chans = (in_channels,) + tuple(conv_channels)
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, 3, padding=1, device=dev)
            for i, o in zip(chans[:-1], chans[1:]))
        feats = (chans[-1] * h * w,) + tuple(fc_features)
        self.fcs = nn.ModuleList(nn.Linear(i, o, device=dev)
                                 for i, o in zip(feats[:-1], feats[1:]))
        self.head = nn.Linear(feats[-1], num_actions, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Q-values (B, num_actions), float32, of NHWC observations."""
        dt = self.compute_dtype
        x = prepare_obs(x, dt, self.assume_binary_obs).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                                padding=1))
        x = x.permute(0, 2, 3, 1).flatten(1)
        for fc in self.fcs:
            x = F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
        return F.linear(x, self.head.weight.to(dt),
                        self.head.bias.to(dt)).to(torch.float32)


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


def make_dqn(cfg: EnvConfig, seed: int = 0, device='cuda',
             assume_binary_obs: bool = True, pad_channels: int = 0,
             compute_dtype: torch.dtype = torch.float32) -> DQN:
    """A DQN for ``cfg``'s observations as uint8 planes, 8 channels a
    stacked frame (packed obs are unpacked before the net,
    ``ops.obs_pack.unpack_obs``), with ``pad_channels`` zero channels
    behind them; initialised as flax initialises the JAX DQN
    (``flax_init_``), from ``seed`` on the CPU and then moved, so that
    the weights do not depend on the device."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = flax_init_(DQN((cfg.obs_height, cfg.obs_width),
                             FEATURE_CHANNEL * cfg.frame_stack
                             + pad_channels, cfg.num_actions,
                             assume_binary_obs, device='cpu',
                             compute_dtype=compute_dtype))
    return net.to(dev)
