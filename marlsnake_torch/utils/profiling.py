"""Profiling helpers: device traces, synchronised timers, and the program's
tracer.

The port of the JAX package's ``utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace of the host and, where there is one, the CUDA
device, and writes it as a Chrome trace (viewable in Perfetto or
``chrome://tracing``); ``timeit`` times a function on the host clock,
waiting for the devices its output lives on as JAX waits with
``block_until_ready``.

``tracer`` (a ``Tracer``) records the program's own phases, inside the
captured loops too, with no synchronisation: host spans (``span``), device
stamps (``mark``) and counts (``count``), all kept in memory until
``flush``. Off, which it is unless ``enable``d, a mark costs one attribute
test and adds no node to a captured graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, List, Optional

import torch

from marlsnake_torch.ops.stamp import stamp

PHASE_PREFIX = 'marlsnake:'
RING_SLOTS = 1 << 16     # stamps a segment of the tracer's device ring
LOOP_SLOTS = 1024        # stamps one replay of a traced graph may place
STAMP_KERNEL = 'stamp_kernel'   # the stamps' kernel, as the profiler names it


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a trace of the block; on leaving it, write it to
    ``log_dir/trace.json``. Yields the profiler. Where ``tracer`` is on,
    it is flushed there: its records go to ``log_dir/marlsnake_trace.json``
    and the phases that the profiler saw the stamps of become one more
    track of the trace (``add_phase_track``)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, 'trace.json')
    prof.export_chrome_trace(path)
    if tracer.on:
        got = tracer.flush()
        add_phase_track(path, got)
        with open(os.path.join(log_dir, 'marlsnake_trace.json'), 'w') as fp:
            json.dump(got, fp)


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


# --- the program's tracer ----------------------------------------------------

def _profiling() -> bool:
    """True while a torch.profiler is recording."""
    return torch.autograd.profiler._is_profiler_enabled


@dataclasses.dataclass
class Span:
    """One span: its name, the id shared by the top-level span it lies in
    and everything inside that (an episode, an update), the index of the
    enclosing span among those flushed with it, and host times
    (``time.perf_counter_ns``)."""
    name: str
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int = 0


class _Ring:
    """The tracer's device ring, in segments of ``RING_SLOTS`` int64
    stamps: a mark placed outside a captured body stamps its next slot,
    and the slots of a traced graph are copied in after each replay.
    ``names`` holds (name, span id) of each slot, None for a slot left
    out so that a copy does not straddle two segments."""

    def __init__(self, device: torch.device):
        self.device = device
        self.segments: List[torch.Tensor] = []
        self.names: list = []
        self.pos = 0

    def reserve(self, n: int):
        """(segment, offset) of ``n`` consecutive free slots."""
        if n > RING_SLOTS:
            raise ValueError(f'{n} stamps do not fit a ring segment')
        seg, off = divmod(self.pos, RING_SLOTS)
        if off + n > RING_SLOTS:
            self.names.extend([None] * (RING_SLOTS - off))
            self.pos += RING_SLOTS - off
            seg, off = seg + 1, 0
        if seg == len(self.segments):
            self.segments.append(torch.zeros(RING_SLOTS, dtype=torch.int64,
                                             device=self.device))
        self.pos += n
        return self.segments[seg], off

    def read(self) -> list:
        """[(name, span id, clock ns)] of every slot written, in order:
        the ring's one read-back; then the ring is empty."""
        if not self.pos:
            return []
        times = torch.cat(self.segments)[:self.pos].tolist()
        got = [(n[0], n[1], t) for n, t in zip(self.names, times)
               if n is not None]
        self.names, self.pos = [], 0
        return got


class _RingSink:
    """Where a mark goes while the tracer is on and no body is being
    captured: the ring's next slot."""

    def __init__(self, tr: 'Tracer', ring: _Ring):
        self.tracer, self.ring = tr, ring

    def mark(self, name: str) -> None:
        seg, off = self.ring.reserve(1)
        stamp(seg, off)
        self.ring.names.append((name, self.tracer.current_id()))

    def count(self, name: str, value: torch.Tensor) -> None:
        self.tracer.add_device_count(name, value)


class LoopSlots:
    """Where the marks of a body go while it is captured with the tracer
    on: static slots of its own, which each replay of the graph writes,
    and the marks' names in order."""

    def __init__(self, device: torch.device):
        self.slots = torch.zeros(LOOP_SLOTS, dtype=torch.int64,
                                 device=device)
        self.names: List[str] = []
        self.counts: dict = {}

    def mark(self, name: str) -> None:
        i = len(self.names)
        if i == LOOP_SLOTS:
            raise ValueError(f'a captured body places more than '
                             f'{LOOP_SLOTS} marks')
        stamp(self.slots, i)
        self.names.append(name)

    def count(self, name: str, value: torch.Tensor) -> None:
        """A device count of one replay: its sum is made in the graph
        (the first count of a name copies, the others add), and the loop
        adds it to the tracer's after each replay."""
        if name in self.counts:
            self.counts[name].add_(value)
        else:
            self.counts[name] = value.to(torch.int64).clone()


class MarkProbe:
    """Where the marks of a body go while it is captured with the tracer
    off: their names only, so that the loop knows whether a traced graph
    would differ from this one."""

    def __init__(self):
        self.names: List[str] = []
        self.counts: dict = {}

    def mark(self, name: str) -> None:
        self.names.append(name)

    def count(self, name: str, value: torch.Tensor) -> None:
        self.counts[name] = None


_NULL = contextlib.nullcontext()   # a span while nothing records it


class _SpanContext:
    __slots__ = ('tracer', 'name', 'device', 'record', 'function')

    def __init__(self, tr: 'Tracer', name: str, device: bool):
        self.tracer, self.name, self.device = tr, name, device
        self.record = self.function = None

    def __enter__(self):
        tr = self.tracer
        if _profiling():
            self.function = torch.autograd.profiler.record_function(
                PHASE_PREFIX + self.name)
            self.function.__enter__()
        if tr.on:
            if tr._open:
                parent, at = tr._open[-1]
                rec = Span(self.name, parent.id, at, time.perf_counter_ns())
            else:
                rec = Span(self.name, tr._new_id(), None,
                           time.perf_counter_ns())
            tr._open.append((rec, len(tr._spans)))
            tr._spans.append(rec)
            self.record = rec
        if self.device:
            tr.mark(self.name + '.start')
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        if self.device:
            tr.mark(self.name + '.end')
        if self.record is not None:
            self.record.end_ns = time.perf_counter_ns()
            tr._open.pop()
        if self.function is not None:
            self.function.__exit__(*exc)
        return False


class Tracer:
    """The program's phases, recorded without a synchronisation.

    - ``span(name, device=False)``: a host span (name, host start and end,
      the enclosing span, the id of its top-level span). While a
      torch.profiler records, a span also opens
      ``record_function('marlsnake:' + name)``, on or off, so that the
      profiler's trace shows the program's phases beside the device's
      kernels. With ``device``, the span also places the marks
      ``name + '.start'`` and ``name + '.end'``.
    - ``mark(name)``: a device stamp (``ops/stamp.py``) that ends the phase
      ``name``. Outside a captured body it takes the next slot of the
      tracer's device ring; inside a body that ``CapturedLoop`` captures
      with the tracer on, a slot of the loop's own, which the loop copies
      into the ring after each replay. A phase's device time is the
      difference between its stamp and the one before it on the device's
      timeline, so idle time is charged to the phase it falls in.
    - ``count(name, n)``: a count kept beside the spans.
    - ``count_device(name, value)``: a count kept on the device: the
      integer tensor ``value`` (of a fixed shape a name) is added to its
      sum there, inside the captured loops too, and read back at
      ``flush``, into ``counts`` beside the host's (a list where the
      shape is not a scalar's).
    - ``flush()``: everything recorded; the ring and the device counts
      are read back there, once.

    Off (the default) a mark costs one attribute test, a span one more
    (is a profiler recording?), a count one; nothing is kept. On the CPU
    a stamp reads the host's clock, so the same code runs there."""

    def __init__(self):
        self.on = False
        self.device: Optional[torch.device] = None
        self._sink = None
        self._ring: Optional[_Ring] = None
        self._spans: List[Span] = []
        self._open: list = []    # (span, its index), innermost last
        self._counts: dict = {}
        self._device_counts: dict = {}
        self._ids = 0

    def enable(self, device) -> None:
        """Turn the tracer on for the device that the traced work runs on:
        its ring lives there, and a captured loop on another device
        refuses to place its stamps in it (``check_device``)."""
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        if self._ring is None or self.device != device:
            self._ring = _Ring(device)
        self.device = device
        self.on = True
        self._sink = _RingSink(self, self._ring)

    def disable(self) -> None:
        """Turn the tracer off; what it recorded waits for ``flush``."""
        self.on = False
        self._sink = None

    def check_device(self, device: torch.device) -> None:
        """Raise unless stamps on ``device`` may go into the ring: a stamp
        of another device reads another clock, and its copy into the ring
        would wait for that device."""
        if torch.device(device) != self.device:
            raise ValueError(f'stamps on {device} cannot go into the '
                             f'tracer\'s ring on {self.device}: enable the '
                             f'tracer for the device the work runs on')

    def _new_id(self) -> int:
        self._ids += 1
        return self._ids

    def current_id(self) -> Optional[int]:
        """The id of the innermost open span, None outside every span."""
        return self._open[-1][0].id if self._open else None

    def span(self, name: str, device: bool = False):
        if self._sink is None and not _profiling():
            return _NULL
        return _SpanContext(self, name, device)

    def mark(self, name: str) -> None:
        sink = self._sink
        if sink is not None:
            sink.mark(name)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self._counts[name] = self._counts.get(name, 0) + n

    def count_device(self, name: str, value: torch.Tensor) -> None:
        sink = self._sink
        if sink is not None:
            sink.count(name, value)

    def add_device_count(self, name: str, value: torch.Tensor) -> None:
        """``value`` into the device sum ``name``, in stream order."""
        if name in self._device_counts:
            self._device_counts[name].add_(value)
        else:
            self._device_counts[name] = value.to(torch.int64).clone()

    @contextlib.contextmanager
    def capturing(self, sink):
        """Marks go to ``sink`` (``LoopSlots``, ``MarkProbe``) inside the
        block: a body's capture."""
        if isinstance(sink, LoopSlots):
            self.check_device(sink.slots.device)
        before, self._sink = self._sink, sink
        try:
            yield sink
        finally:
            self._sink = before

    def replayed(self, slots: torch.Tensor, names: List[str],
                 counts: Optional[dict] = None) -> None:
        """After a replay of a traced graph: its slots into the ring, one
        device-to-device copy in stream order, and its device counts into
        the tracer's."""
        self.check_device(slots.device)
        if names:
            seg, off = self._ring.reserve(len(names))
            seg[off:off + len(names)].copy_(slots)
            sid = self.current_id()
            self._ring.names.extend((name, sid) for name in names)
        for name, value in (counts or {}).items():
            self.add_device_count(name, value)

    def flush(self) -> dict:
        """What was recorded since the last flush, and forget it:
        ``spans`` (name, id, parent index, host start and end ns, self ns:
        the duration less its children's), ``stamps`` in device order
        (name, span id, clock ns), ``counts``, and the clock the stamps
        read (``globaltimer`` or ``perf_counter``). The one read-back of
        the ring is here."""
        if self._open:
            raise RuntimeError('flush inside the span '
                               f'{self._open[-1][0].name!r}')
        stamps = self._ring.read() if self._ring is not None else []
        device_counts = {k: v.tolist()
                         for k, v in self._device_counts.items()}
        child = [0] * len(self._spans)
        for s in self._spans:
            if s.parent is not None:
                child[s.parent] += s.end_ns - s.start_ns
        got = {
            'clock': ('globaltimer' if self.device is not None
                      and self.device.type == 'cuda' else 'perf_counter'),
            'spans': [dict(dataclasses.asdict(s),
                           self_ns=s.end_ns - s.start_ns - c)
                      for s, c in zip(self._spans, child)],
            'stamps': [{'name': n, 'id': i, 't_ns': t}
                       for n, i, t in stamps],
            'counts': dict(self._counts, **device_counts)}
        self._spans, self._counts, self._device_counts = [], {}, {}
        if not self.on:
            self._ring = None
        return got


tracer = Tracer()


def add_phase_track(path: str, got: dict) -> None:
    """Write the phases of a flush (``got``) into the Chrome trace at
    ``path`` as one more track, placed by the stamps' own kernels: the
    trace's stamp kernels, in device order, are the flush's last stamps
    (those placed while the profiler recorded), and a phase runs from the
    start of the kernel of the stamp before it to that of its own. Its
    ``args`` give its span id and its device time from the stamps
    (``stamp_ns``). Stamps that the profiler did not see get no phase; on
    the CPU, where a stamp launches no kernel, that is every one."""
    with open(path) as fp:
        doc = json.load(fp)
    kernels = sorted(e['ts'] for e in doc['traceEvents']
                     if e.get('cat') == 'kernel'
                     and e.get('name', '').startswith(STAMP_KERNEL))
    stamps = got['stamps']
    if not kernels or len(kernels) > len(stamps):
        return
    placed = list(zip(stamps[len(stamps) - len(kernels):], kernels))
    pid = 'marlsnake phases'
    events = [{'ph': 'M', 'name': 'process_name', 'pid': pid, 'tid': 0,
               'args': {'name': pid}}]
    for (a, start), (b, end) in zip(placed, placed[1:]):
        events.append({'ph': 'X', 'name': b['name'], 'pid': pid, 'tid': 0,
                       'ts': start, 'dur': end - start,
                       'args': {'id': b['id'],
                                'stamp_ns': b['t_ns'] - a['t_ns']}})
    doc['traceEvents'].extend(events)
    with open(path, 'w') as fp:
        json.dump(doc, fp)
