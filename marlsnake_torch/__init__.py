"""marlsnake_torch — the PyTorch / CUDA port of marlsnake_tpu.

The batched multi-agent snake engine, its DQN acting and DQN training, for
one NVIDIA GPU. The env step, with and without auto-reset, runs as one
hand-written CUDA kernel (``ops/step_kernel.py``); everything else is
plain PyTorch. Imports torch and numpy only.
"""

__version__ = '0.1.0'

from marlsnake_torch.core.types import EnvConfig  # noqa: F401
