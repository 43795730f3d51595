"""marlsnake_torch — the PyTorch / CUDA port of marlsnake_tpu.

The batched multi-agent snake engine with every observation and spawn
option, the Snake/Coop/Graph envs and the reference wrappers, DQN and PPO
training, NEAT and head-ES evolution, the safety-masked evaluator, the
battle arena (host and device-batched, with the opponent zoo) and the
command line (``python -m marlsnake_torch.cli``), for one NVIDIA GPU, and
data-parallel DQN and PPO over ``torch.distributed`` (``parallel/``). The
env step, with and without auto-reset, runs as one hand-written CUDA
kernel (``ops/step_kernel.py``); everything else is plain PyTorch.
Imports torch and numpy only.
"""

__version__ = '0.1.0'

from marlsnake_torch.core.types import EnvConfig  # noqa: F401
