"""The benchmark's runner: one cell, one seed, one run.

``run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`` finds
everything by name: the cell in ``BENCHMARK.json`` and in
``perfbench/workloads/<cell>.json``, its configuration's file, its
driver in ``perfbench/drivers/<driver>.py``, each metric's reader in
``perfbench/metrics/<metric>.py`` and its configuration's counts in
``perfbench/counts/<module>.py``. Nothing here branches on a cell.

A run: set-up (the driver builds the program's objects from the seed and
runs every shape once), then the window: the driver's call, again and
again, for ``--seconds`` seconds, with at most two calls in flight on
the device; then, with ``--trace 1``, a few calls more under
torch.profiler; then the peak of device memory is read, the program's
state is freed, and the driver compares what the window's path produced
with the plain reference (``perfbench/reference``). The last line of
standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the last key of
that object.

A driver is a class ``Driver(config, params, seed, device)`` with
``work`` (the unit a metric reader counts), ``profile_calls``,
``setup()``, ``call() -> (units, latency in seconds or None)``,
``release()`` (frees the program's state), ``compared() -> {number:
value}`` (beside the limits of the cell's workload file) and
``controls()`` (``readings.py``); it may keep
``spans`` ({name: [seconds]}), timed while the harness sets ``tracing``.
A metric's reader is ``read(ctx: Context)``, which returns None where
the run gives it nothing to read.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'perfbench')
NAME_CHARS = 160   # a device operation's name in the breakdown, cut
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'marlsnake_tpu')


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'perfbench_{kind}_{name.replace(".", "_").replace("-", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as fp:
        return json.load(fp)


def over_limit(value, limit) -> bool:
    """True where a number compared is past its limit, or is no finite
    number at all (a NaN compares false with any limit)."""
    return not (math.isfinite(value) and value <= limit)


def printable(value):
    """A number compared as the result's line carries it: a number that
    is not finite as its name, which strict JSON can hold."""
    return value if math.isfinite(value) else str(value)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole (the part before the first dot)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """What ``BENCHMARK.json`` and the cell's own files say of one cell."""
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    workload: dict       # perfbench/workloads/<cell>.json
    config: dict         # the configuration's file
    bench: dict          # BENCHMARK.json

    @staticmethod
    def find(name: str, root: str = ROOT) -> 'Cell':
        bench = load_json(os.path.join(root, 'BENCHMARK.json'))
        entry = next((w for w in bench['workloads'] if w['name'] == name),
                     None)
        if entry is None:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json')
        cfg_entry = next(c for c in bench['configs']
                         if c['name'] == entry['config'])
        workload = load_json(os.path.join(HERE, 'workloads', f'{name}.json'))
        for key in ('config', 'traffic', 'chips'):
            if workload[key] != entry[key]:
                raise ValueError(f'{name}: {key} differs between '
                                 'BENCHMARK.json and its workload file')
        return Cell(name, entry, workload,
                    load_json(os.path.join(root, cfg_entry['file'])), bench)

    def checks(self, numbers: dict) -> dict:
        """Each number compared beside its limit."""
        limits = self.workload['limits']
        return {k: {'value': v, 'limit': limits[k]}
                for k, v in numbers.items()}

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in a run."""
        group = self.bench['per_layer' if trace else 'end_to_end']
        return [m for m in group
                if self.name in m.get('workloads', [self.name])]


class Window:
    """What the window recorded."""

    def __init__(self):
        self.units = 0          # work, in the driver's unit
        self.calls = 0
        self.seconds = 0.0
        self.latencies = []     # seconds a call, where the driver times it


def run_window(driver, seconds: float, device: torch.device) -> Window:
    """The driver's calls for ``seconds`` seconds of the host clock, the
    work of every call counted, and the time until the last call's work
    is done: a call's work is on the device when it returns, and the next
    call waits for the one before the last to finish, so that the device
    is never starved and no backlog piles up."""
    w = Window()
    cuda = device.type == 'cuda'
    inflight = collections.deque()
    t0 = time.perf_counter()
    while True:
        units, latency = driver.call()
        w.units += units
        w.calls += 1
        if latency is not None:
            w.latencies.append(latency)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > 2:
                inflight.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(device)
    w.seconds = time.perf_counter() - t0
    return w


def profile_calls(driver, calls: int, device: torch.device) -> dict:
    """``calls`` more calls under torch.profiler; what the trace shows
    (``summarize``) and the work those calls did."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = device.type == 'cuda'
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    if cuda:
        torch.cuda.synchronize(device)
    units = 0
    with profile(activities=activities) as prof:
        for _ in range(calls):
            with record_function('perfbench.call'):
                units += driver.call()[0]
        if cuda:
            torch.cuda.synchronize(device)
    out = summarize(prof.events())
    out['units'] = units
    out['calls'] = calls
    return out


def summarize(events) -> dict:
    """From a profiler's events: device busy seconds (the union of the
    device's intervals) and the span from the first device start to the
    last end; seconds by device operation; the idle gaps between device
    intervals, the 200 longest labelled by the innermost host event open
    at the gap's start; device-to-host copies; the host's kernel and graph
    launches."""
    dev, host = [], []
    launches = {'cudaLaunchKernel': 0, 'cudaGraphLaunch': 0}
    by_op = collections.defaultdict(float)
    counts = collections.defaultdict(int)
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if getattr(e, 'is_user_annotation', False) or \
                e.name.startswith('perfbench.'):
            continue   # the harness's own ranges, on both timelines
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((start, end))
            by_op[e.name] += (end - start) * 1e-6
            counts[e.name] += 1
        else:
            host.append((start, end, e.name))
            for name in launches:
                launches[name] += name in e.name
    out = {'busy_s': 0.0, 'span_s': 0.0, 'ops': dict(by_op),
           'op_counts': dict(counts), 'gaps': [],
           'dtoh': sum(n for k, n in counts.items() if 'Memcpy DtoH' in k),
           'kernel_launches': launches['cudaLaunchKernel'],
           'graph_launches': launches['cudaGraphLaunch']}
    if not dev:
        return out
    dev.sort()
    merged = [list(dev[0])]
    for s, e in dev[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out['busy_s'] = sum(e - s for s, e in merged) * 1e-6
    out['span_s'] = (merged[-1][1] - merged[0][0]) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:200]
    if host and gaps:
        hs = np.array([h[0] for h in host], dtype=np.float64)
        he = np.array([h[1] for h in host], dtype=np.float64)
        labels = collections.defaultdict(float)
        for length, at in gaps:
            open_ = np.nonzero((hs <= at) & (he > at))[0]
            name = (host[open_[np.argmax(hs[open_])]][2] if open_.size
                    else 'host: no traced op')
            labels[name] += length * 1e-6
        out['gaps'] = sorted(labels.items(), key=lambda kv: -kv[1])
    return out


class Context:
    """What a metric's reader may read."""

    def __init__(self, cell: Cell, driver, setup_s: float, window: Window,
                 profile: Optional[dict], counts, peaks: dict, kind: str):
        self.cell, self.driver = cell, driver
        self.setup_s, self.window, self.profile = setup_s, window, profile
        self.counts = counts
        self.peak = peaks.get(kind, {})
        self.spans = getattr(driver, 'spans', {})


def read_metrics(cell: Cell, ctx: Context, trace: bool) -> dict:
    out = {}
    for m in cell.metrics(trace):
        value = load_module('metrics', m['name']).read(ctx)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def set_precision(config: dict) -> None:
    """The configuration's precision: TF32 in matmuls and cuDNN only
    where it states 'tf32'."""
    tf32 = config['precision'] == 'tf32'
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def breakdown(profile: dict) -> dict:
    ops = sorted(profile['ops'].items(), key=lambda kv: -kv[1])[:10]
    return {'device_ops': [[k[:NAME_CHARS], v] for k, v in ops],
            'idle_gaps': [[k, v] for k, v in profile['gaps'][:10]]}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of ``cell``: set-up, window, profiled calls where
    ``trace``, the peak of device memory, the check; the result's line as
    a dict. ``device`` is the card (the CPU in the harness's own tests)."""
    device = torch.device(device)
    cuda = device.type == 'cuda'
    set_precision(cell.config)
    driver = load_module('drivers', cell.workload['driver']).Driver(
        cell.config, cell.workload['params'], seed, device)
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    driver.tracing = trace
    window = run_window(driver, seconds, device)
    prof = None
    if trace:
        driver.tracing = False
        prof = profile_calls(driver, driver.profile_calls, device)
    kind = torch.cuda.get_device_name(device) if cuda else 'cpu'
    dev_info = {'platform': 'gpu' if cuda else 'cpu', 'kind': kind,
                'count': cell.entry['chips'],
                'memory_peak_bytes': int(torch.cuda.max_memory_allocated(
                    device)) if cuda else 0}
    if prof is not None:
        dev_info['busy_s'] = prof['busy_s']
        dev_info['window_s'] = prof['span_s']
    counts = load_module('counts', cell.config['counts'])
    peaks = load_json(os.path.join(HERE, 'peaks.json'))
    ctx = Context(cell, driver, setup_s, window, prof, counts, peaks, kind)
    metrics = read_metrics(cell, ctx, trace)
    driver.release()
    checks = cell.checks(driver.compared())
    failed = sum(over_limit(c['value'], c['limit']) for c in checks.values())
    result = {'correct': failed == 0, 'attempted': window.calls,
              'failed': failed, 'metrics': metrics, 'device': dev_info}
    if prof is not None:
        result['breakdown'] = breakdown(prof)
    result['checks'] = {k: {'value': printable(c['value']),
                            'limit': c['limit']} for k, c in checks.items()}
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog='perfbench/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = Cell.find(a.workload)
    chips = cell.entry['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), device,
                      t_start)
    found = forbidden_modules()
    if found:
        print(f'forbidden modules loaded: {found}', file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    print(json.dumps(result))
    return 0
