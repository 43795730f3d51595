"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and none is
    available. The entry points default to ``'cuda'``: running on the CPU
    is something a caller asks for (``device='cpu'``), never a fallback."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            'plain PyTorch path on the CPU')
    return dev
