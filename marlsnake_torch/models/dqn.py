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

import torch
import torch.nn.functional as F
from torch import nn

from marlsnake_torch.core.types import FEATURE_CHANNEL, EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.models.weights import flax_init_
from marlsnake_torch.ops.obs_pack import prepare_obs


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
