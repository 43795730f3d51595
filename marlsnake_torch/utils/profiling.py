"""Profiling helpers: device traces and synchronised timers.

The port of the JAX package's ``utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace of the host and, where there is one, the CUDA
device, and writes it as a Chrome trace (viewable in Perfetto or
``chrome://tracing``); ``timeit`` times a function on the host clock,
waiting for the devices its output lives on as JAX waits with
``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a trace of the block; on leaving it, write it to
    ``log_dir/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def _devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists,
    dicts and dataclasses)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _devices(getattr(out, f.name), found)
    return found


def block_until_ready(out):
    """Wait until the devices that ``out``'s tensors live on have finished
    their queued work; returns ``out``."""
    for dev in _devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2,
           **kwargs) -> float:
    """Mean wall-clock seconds per call, synchronized on the output."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def env_steps_per_sec(step_fn: Callable, states, actions,
                      num_envs: int, iters: int = 20) -> float:
    dt = timeit(step_fn, states, actions, iters=iters)
    return num_envs / dt
