"""Device timestamps: ``stamp(slots, i)`` writes a clock reading (int64
nanoseconds) into ``slots[i]``, in stream order.

On a CUDA tensor it launches the one-thread kernel of ``csrc/stamp.cu``,
which writes the device's ``%globaltimer``, on PyTorch's current stream:
it runs once the work enqueued before it has finished, and nothing waits
for it. Inside a CUDA graph's capture the launch becomes a node of the
graph. On a CPU tensor it writes the host's ``time.perf_counter_ns()``,
so the code around it runs the same on both. ``stamp.launches`` counts
the kernel's launches, as the other wrappers count theirs; a host stamp
launches nothing.

The library is built on first use with ``nvcc`` (``ops/cuda_build.py``)
into ``build/marlsnake_torch/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import os
import time

import torch

from marlsnake_torch.ops import cuda_build

SOURCE = os.path.join(cuda_build.CSRC_DIR, 'stamp.cu')


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(cuda_build.build(SOURCE)[0][0])
    lib.marlsnake_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.marlsnake_stamp.restype = ctypes.c_int
    lib.marlsnake_stamp_error_string.argtypes = [ctypes.c_int]
    lib.marlsnake_stamp_error_string.restype = ctypes.c_char_p
    return lib


def stamp(slots: torch.Tensor, index: int) -> None:
    """The clock into ``slots[index]`` (``slots``: contiguous int64)."""
    if slots.device.type == 'cpu':
        slots[index] = time.perf_counter_ns()
    else:
        lib = load_library()
        dev = slots.device.index
        with torch.cuda.device(dev):
            rc = lib.marlsnake_stamp(
                slots.data_ptr() + index * slots.element_size(),
                torch._C._cuda_getCurrentRawStream(dev))
        if rc != 0:
            raise RuntimeError(
                'stamp kernel launch failed: '
                f'{lib.marlsnake_stamp_error_string(rc).decode()}')
        stamp.launches += 1


stamp.launches = 0
