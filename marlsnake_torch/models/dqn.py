"""DQN network with the reference shared model's topology.

Conv(C -> 32 -> 64 -> 64, 3x3, stride 1, pad 1) -> FC(64*H*W -> 256 -> 128
-> num_actions), ReLU throughout; ``features`` returns the 128-d
penultimate embedding. The public call takes NHWC observations, the
engine's layout, and permutes to NCHW for the convolutions; the flatten
before fc1 is in NCHW order, so the parameters are laid out as the
reference's torch checkpoints (``models/weights.py`` converts flax
parameters). Without ``assume_binary_obs`` the input is divided by 255
when its maximum over the batch exceeds 1, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device


class DQN(nn.Module):
    def __init__(self, grid_hw, in_channels: int = 8, num_actions: int = 3,
                 assume_binary_obs: bool = False, device='cuda'):
        super().__init__()
        h, w = grid_hw
        dev = resolve_device(device)
        self.assume_binary_obs = assume_binary_obs
        self.conv1 = nn.Conv2d(in_channels, 32, 3, padding=1, device=dev)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, device=dev)
        self.conv3 = nn.Conv2d(64, 64, 3, padding=1, device=dev)
        self.fc1 = nn.Linear(64 * h * w, 256, device=dev)
        self.fc2 = nn.Linear(256, 128, device=dev)
        self.fc3 = nn.Linear(128, num_actions, device=dev)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[None]
        x = x.to(torch.float32)
        if not self.assume_binary_obs:
            x = torch.where(x.max() > 1.0, x / 255.0, x)
        x = x.permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
        x = x.flatten(1)
        x = F.relu(F.linear(x, self.fc1.weight, self.fc1.bias))
        return F.relu(F.linear(x, self.fc2.weight, self.fc2.bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Q-values (B, num_actions) of NHWC observations (B, H, W, C)."""
        return F.linear(self._trunk(x), self.fc3.weight, self.fc3.bias)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """128-d penultimate embedding."""
        return self._trunk(x)


def make_dqn(cfg: EnvConfig, seed: int = 0, device='cuda',
             assume_binary_obs: bool = True) -> DQN:
    """A DQN for ``cfg``'s observations, initialised from ``seed`` (on the
    CPU, then moved, so the weights do not depend on the device)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = DQN((cfg.obs_height, cfg.obs_width), cfg.obs_channels,
                  cfg.num_actions, assume_binary_obs, device='cpu')
    return net.to(dev)
