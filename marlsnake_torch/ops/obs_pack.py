"""Observations on their way into a net: bit-packed bytes
(``EnvConfig.obs_format == 'packed'``) unpacked (``unpack_obs``), then
cast and scaled (``prepare_obs``).

The eight one-hot channels of a frame (wall, fruit, other head/body/tail,
my head/body/tail) are {0, 1} planes; packed, they are the bits of one
byte a cell (bit c = channel c), so the obs is (..., H, W, frame_stack)
uint8 instead of (..., H, W, 8 * frame_stack). ``unpack_obs`` gives the
uint8 planes back bit for bit, in the channel order of
``engine.stack_to_obs``: frame-major, oldest first.
"""

from __future__ import annotations

import torch

from marlsnake_torch.core import types as T


def pack_frame(frame: torch.Tensor) -> torch.Tensor:
    """(..., 8) one-hot {0, 1} uint8 -> (..., 1) packed byte."""
    c = torch.arange(T.FEATURE_CHANNEL, dtype=torch.int32,
                     device=frame.device)
    byte = (frame.to(torch.int32) << c).sum(-1).to(torch.uint8)
    return byte[..., None]


def unpack_obs(packed: torch.Tensor) -> torch.Tensor:
    """(..., fs) packed bytes -> (..., fs * 8) one-hot uint8 planes: bit c
    of byte f becomes channel f * 8 + c."""
    c = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> c) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


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
