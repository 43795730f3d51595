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


def card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for a
    CUDA ``device``, ``'cpu'`` for the CPU: what a timing must be read
    beside, since a card held below its full power limit runs slower. The
    card is named to nvidia-smi by its UUID, since nvidia-smi numbers
    cards by bus and ignores ``CUDA_VISIBLE_DEVICES``."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return 'cpu'
    import subprocess
    uuid = torch.cuda.get_device_properties(dev).uuid
    return subprocess.run(
        ['nvidia-smi', f'--id=GPU-{uuid}', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()


def device_profile(fn: Callable, iters: int = 1) -> dict:
    """Run ``fn()`` ``iters`` times under torch.profiler (CPU and CUDA),
    after one call to warm up. Returns {'kernels': {name: [device us,
    count]}, 'busy_us', 'span_us', 'idle_share', 'wall_us', 'dtoh',
    'graph_launches', 'kernel_launches'} from the device-side events:
    busy is their summed duration, span the time from the first start to
    the last end (one stream, so they do not overlap), dtoh the number of
    device-to-host copies, each of which the host waits for; the last two
    count the host's cudaGraphLaunch and cudaLaunchKernel calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, busy, first, last = {}, 0.0, None, None
    runtime = {'cudaGraphLaunch': 0, 'cudaLaunchKernel': 0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            for name in runtime:
                runtime[name] += name in e.name
            continue
        start, end = e.time_range.start, e.time_range.end
        kernels.setdefault(e.name, [0.0, 0])
        kernels[e.name][0] += end - start
        kernels[e.name][1] += 1
        busy += end - start
        first = start if first is None else min(first, start)
        last = end if last is None else max(last, end)
    span = (last - first) if kernels else 0.0
    return {'kernels': kernels, 'busy_us': busy, 'span_us': span,
            'idle_share': 1.0 - busy / span if span > 0 else None,
            'wall_us': wall_us,
            'dtoh': sum(v[1] for k, v in kernels.items()
                        if 'Memcpy DtoH' in k),
            'graph_launches': runtime['cudaGraphLaunch'],
            'kernel_launches': runtime['cudaLaunchKernel']}


def per_step(window: dict, steps: int) -> dict:
    """A ``device_profile`` window of ``steps`` steps of a loop, a step:
    device busy time, the idle share of the span, device events,
    device-to-host copies (read-backs the host waits for), and beside
    them the host's wall time."""
    return {'busy_us_per_step': window['busy_us'] / steps,
            'idle_share': window['idle_share'],
            'device_events_per_step': sum(
                v[1] for v in window['kernels'].values()) / steps,
            'dtoh_per_step': window['dtoh'] / steps,
            'wall_ms_per_step': window['wall_us'] / steps / 1e3}
