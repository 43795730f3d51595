"""The traced pass of the agent's cell, for the readers of its
``program_span`` and ``program_counter`` metrics.

What ``traced._run`` does for the learner cells, with the driver's own
number of calls (``Driver.traced_calls``): the program's tracer on, one
call that captures the traced rollout graph (its records dropped), then
those calls, a sync and one flush, kept with the pass's work and seconds
as ``ctx.program_trace``; None where the program has no tracer. The
agent's forward in the rollout graph places the marks ``agent.embed``,
``agent.attn``, ``agent.dense`` and ``agent.moe`` and counts on the
device the router's choices (``agent.routed``, ``agent.held``,
``agent.held_load``), which the flush reads back.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from perfbench import traced


def window(ctx) -> Optional[dict]:
    """The traced pass's flush, made once a run."""
    if not hasattr(ctx, 'program_trace'):
        ctx.program_trace = _run(ctx)
    return ctx.program_trace


def _run(ctx) -> Optional[dict]:
    try:
        from marlsnake_torch.utils.profiling import tracer
    except ImportError:
        return None
    driver = ctx.driver
    calls = driver.traced_calls
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


def per_update_ms(ctx, phase: str) -> Optional[float]:
    """Milliseconds of ``phase`` an update: its phases' sum over the
    updates (each places one ``ppo.collect.end``)."""
    got = window(ctx)
    updates = traced.count(got, 'ppo.collect.end')
    return (1e-6 * sum(traced.durations(got, phase)) / updates
            if updates else None)


def counter(ctx, name: str):
    """The pass's device count ``name``, None where there is none."""
    got = window(ctx)
    return got['counts'].get(name) if got else None
