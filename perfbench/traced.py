"""The program's own phases, for the readers of the ``program_span`` and
``program_counter`` metrics of the learner cells.

The program keeps a tracer (``marlsnake_torch.utils.profiling.tracer``):
device stamps between the phases of the DQN chunk graph and of the PPO
update, host spans, counts, all read back once at its ``flush``. The
cells' drivers do not switch it on for the run's window, so the first
reader that asks runs a traced pass of its own, after the profiled
calls and before the check: the tracer on, one call that captures the
traced graph (its records dropped), then the driver's ``CALLS`` calls
(episodes, updates), a sync and one flush. It keeps the flush, with the
pass's work and seconds, as ``ctx.program_trace``. Where the program has
no tracer (a tree before it), that is None and every reader returns
None.

A phase is the time between two consecutive stamps on the device's
timeline, named by the stamp that ends it (``durations``).
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

# calls a traced pass, by driver: what the phases' spread needs (PERF.md)
CALLS = {'dqn_train': 6, 'ppo_train': 2}


def window(ctx) -> Optional[dict]:
    """The traced pass's flush (``clock``, ``spans``, ``stamps``,
    ``counts``) and ``window`` (``units``, ``calls``, ``seconds``), made
    once a run; None without the program's tracer."""
    if not hasattr(ctx, 'program_trace'):
        ctx.program_trace = _run(ctx)
    return ctx.program_trace


def _run(ctx) -> Optional[dict]:
    try:
        from marlsnake_torch.utils.profiling import tracer
    except ImportError:
        return None
    driver = ctx.driver
    calls = CALLS[ctx.cell.workload['driver']]
    cuda = driver.device.type == 'cuda'
    tracer.enable(driver.device)
    try:
        driver.call()
        tracer.flush()
        units, t0 = 0, time.perf_counter()
        for _ in range(calls):
            units += driver.call()[0]
        if cuda:
            torch.cuda.synchronize(driver.device)
        seconds = time.perf_counter() - t0
        got = tracer.flush()
    finally:
        tracer.disable()
    got['window'] = {'units': units, 'calls': calls, 'seconds': seconds}
    return got


def durations(got: Optional[dict], name: str,
              after: Optional[str] = None) -> List[int]:
    """Nanoseconds of each phase ``name`` (from the stamp before it to its
    own), where ``after`` is given only those that follow a stamp of that
    name."""
    if not got:
        return []
    s = got['stamps']
    return [b['t_ns'] - a['t_ns'] for a, b in zip(s, s[1:])
            if b['name'] == name and (after is None or a['name'] == after)]


def count(got: Optional[dict], name: str) -> int:
    """Stamps named ``name``."""
    return sum(s['name'] == name for s in got['stamps']) if got else 0


def dqn_per_step_us(ctx, phase: str) -> Optional[float]:
    """Microseconds of ``phase`` an episode step run: its phases' sum over
    the steps the chunks ran (each places one ``dqn.act``)."""
    got = window(ctx)
    steps = count(got, 'dqn.act')
    return 1e-3 * sum(durations(got, phase)) / steps if steps else None


def ppo_per_update_ms(ctx, phase: str) -> Optional[float]:
    """Milliseconds of ``phase`` an update: its phases' sum over the
    updates (each places one ``ppo.collect.end``)."""
    got = window(ctx)
    updates = count(got, 'ppo.collect.end')
    return 1e-6 * sum(durations(got, phase)) / updates if updates else None
