"""A loop body captured once as a CUDA graph and replayed.

The counterpart of the JAX package's ``jax.jit`` over a ``lax.scan`` or
a ``lax.while_loop``: a body of many small kernels (a chunk of steps of
the DQN episode, of the batched evaluation, of the batched battle or of
a fitness episode; a PPO rollout; the bench rollout) is recorded once
and then launched as one graph, so that the host issues one launch where
it issued hundreds.

A ``CapturedLoop`` runs a body that reads and writes tensors at fixed
addresses (its static buffers, which the caller allocates and fills
with ``copy_into``). On a CUDA device the first call runs the body
uncaptured on a side stream, which is the call's own work and the
warm-up that capture needs (lazy initialisation, autograd's streams),
then captures it with ``torch.cuda.graph``; every later call replays
the graph. If capture or replay fails it raises: there is no fallback to
the uncaptured loop. On the CPU every call runs the body directly,
through the same buffers. ``uncaptured()`` runs the body without the
graph on any device, as a kernel's plain version is run beside it.

The body must not read a value back to the host, and must draw no
random number: every draw comes in through a static buffer
(``marlsnake_torch.rng``).

The tracer (``utils/profiling.tracer``) picks the graph: a body that
places marks has a second graph, captured on the first call with the
tracer on, whose stamps write slots of the loop's own; after each of its
replays the loop copies those slots into the tracer's ring. With the
tracer off the untraced graph replays, with not one node more. A body
that places no mark is captured once, and its one graph serves both.

Launch counters (``step_kernel.step.launches`` and the others that
``launch_counters`` lists, a tracked ``Counter`` among them) count in
Python, where a wrapper enqueues its kernel. Capture enqueues nothing, so
the counts a capture made are taken back and kept as the graph's tally,
and each replay adds that tally: a counter then counts the launches that
ran, replays included.

Results go back to the caller as clones (``clone_tree``), so that a state
the caller holds does not change when the next call replays over the
same buffers.

A loop of up to ``max_steps`` steps that ends early (every env done)
runs in chunks of ``chunk_steps`` steps (at most 8): ``run_chunks``
replays the chunk and reads back one flag a chunk (is anything still
live?), and stops after the chunk in which the loop ended. A chunk's
steps after that point, and past ``max_steps``, are no-ops on every
value the loop returns; their kernels still launch. The graphs of one
owner may share one memory pool (``GraphPool``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

from marlsnake_torch.utils.profiling import LoopSlots, MarkProbe, tracer

MOST_CHUNK_STEPS = 8


def chunk_steps(max_steps: int, update_every: int = 1,
                most: int = MOST_CHUNK_STEPS) -> int:
    """Steps of one chunk of an episode: the largest multiple of
    ``update_every`` that divides ``max_steps`` and is at most ``most``
    (``update_every`` itself where it exceeds ``most``)."""
    fits = [k for k in range(update_every, most + 1, update_every)
            if max_steps % k == 0]
    return fits[-1] if fits else update_every


def tail_chunk_steps(max_steps: int, most: int = MOST_CHUNK_STEPS) -> int:
    """Steps of one chunk of a loop whose body makes its steps past
    ``max_steps`` no-ops, so that the last chunk may run over: ``most``,
    or the whole loop where it is shorter."""
    return max(1, min(most, max_steps))


def run_chunks(loop: 'CapturedLoop', flags: torch.Tensor, max_steps: int,
               chunk: int, captured: bool = True, *, name: str
               ) -> List[int]:
    """Run ``loop`` (its graph, or its body uncaptured) chunk after chunk
    until the chunks cover ``max_steps`` steps or ``flags[0]``, which each
    chunk writes, reads 0 after one. ``flags.tolist()`` is the one
    read-back a chunk; returns the last one (that of ``flags`` as it is
    when no chunk runs). Each chunk's launch and read-back are the
    tracer's host spans ``<name>.replay`` and ``<name>.readback``."""
    run = loop if captured else loop.uncaptured
    replay, readback = f'{name}.replay', f'{name}.readback'
    got = None
    for _ in range(-(-max_steps // chunk)):
        with tracer.span(replay):
            run()
        with tracer.span(readback):
            got = flags.tolist()
        if not got[0]:
            break
    return flags.tolist() if got is None else got


class GraphPool:
    """One memory pool for the graphs of one owner (a trainer's buckets),
    made on the first capture: graphs that never run at once and carry
    nothing from one replay to the next in their pool may share it, and
    the pool then holds the largest graph's work, not their sum."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class Counter:
    """A count that a body adds to in Python, kept as the kernel wrappers
    keep ``launches``. Once ``track``ed, a captured loop treats it as it
    treats theirs: what a capture counted goes into the loop's tally, and
    each replay adds it."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


_TRACKED: 'weakref.WeakSet[Counter]' = weakref.WeakSet()


def track(counter: Counter) -> Counter:
    _TRACKED.add(counter)
    return counter


def launch_counters() -> tuple:
    """The wrappers whose ``launches`` attribute counts their kernel's
    launches, and the tracked counters."""
    from marlsnake_torch.ops import (floodfill, ppo_trunk, safety_mask, stamp,
                                     step_kernel)
    return (step_kernel.step_autoreset, step_kernel.step,
            safety_mask.safety_mask, floodfill.reachable_count,
            stamp.stamp, ppo_trunk.ppo_trunk, *_TRACKED)


class LaunchTally:
    """The launches of each counted wrapper that one replay of a graph
    runs. ``recording()`` wraps a capture: the counts made inside it are
    moved from the counters into the tally. ``add()`` puts them back for
    one replay."""

    def __init__(self):
        self.per_replay: Dict[Callable, int] = {}

    @contextlib.contextmanager
    def recording(self):
        before = {w: w.launches for w in launch_counters()}
        try:
            yield
        finally:
            for w, n in before.items():
                if w.launches != n:
                    self.per_replay[w] = (self.per_replay.get(w, 0)
                                          + w.launches - n)
                w.launches = n

    def add(self) -> None:
        for w, n in self.per_replay.items():
            w.launches += n

    def by_name(self) -> Dict[str, int]:
        return {w.__name__: n for w, n in self.per_replay.items()}


class CapturedLoop:
    """``body()`` over static buffers, captured on its first call on a
    CUDA device and replayed on every later one. ``capture_seconds``,
    ``pool_bytes`` (what the graph's private memory pool reserved) and
    ``replays`` say what it cost; ``tally`` holds its launches. With a
    ``pool`` (``GraphPool``) its graph shares that pool; ``pool_bytes`` is
    then what the pool grew by at this capture.

    ``marks`` is the number of tracer marks and device counts the body
    places (None until its first capture). Where it places some, a call
    with the tracer on replays ``traced_graph`` (captured on the first
    such call, into the pool of the untraced graph where there is one:
    the two never run at once), whose launches ``traced_tally`` holds and
    whose stamps and counts it copies into the tracer's."""

    def __init__(self, body: Callable[[], None], device,
                 pool: Optional[GraphPool] = None):
        self.body = body
        self.device = torch.device(device)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally = LaunchTally()
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.replays = 0
        self.marks: Optional[int] = None
        self.traced_graph: Optional[torch.cuda.CUDAGraph] = None
        self.traced_tally = LaunchTally()
        self._records = None   # the traced graph's slots, names, counts

    def __call__(self) -> None:
        if self.device.type != 'cuda':
            self.body()
            return
        traced = tracer.on and self.marks != 0
        graph = self.traced_graph if traced else self.graph
        if graph is None:
            self._warm_up()
            self._capture(traced)
            return
        graph.replay()
        self.replays += 1
        if traced:
            self.traced_tally.add()
            tracer.replayed(*self._records)
        else:
            self.tally.add()

    def uncaptured(self) -> None:
        """The body, run without the graph."""
        self.body()

    def _warm_up(self) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.body()
        current.wait_stream(side)

    def _capture(self, traced: bool) -> None:
        """Capture the body: with ``traced``, its marks stamping slots of
        the loop's own; else counted only. A traced capture that finds no
        mark is the untraced graph."""
        sink = LoopSlots(self.device) if traced else MarkProbe()
        tally = LaunchTally()
        with tally.recording(), tracer.capturing(sink):
            graph, seconds, pool_bytes = self._record()
        self.marks = len(sink.names) + len(sink.counts)
        if traced and self.marks:
            self.traced_graph, self.traced_tally = graph, tally
            self._records = (sink.slots[:len(sink.names)], sink.names,
                            sink.counts)
        else:
            self.graph, self.tally = graph, tally
            self.capture_seconds, self.pool_bytes = seconds, pool_bytes

    def _pool_handle(self):
        """The pool of this loop's owner, else that of its other graph
        (None: a private pool)."""
        if self.pool is not None:
            return self.pool.handle()
        other = self.graph or self.traced_graph
        return None if other is None else other.pool()

    def _record(self):
        """(the graph of one body, its capture's seconds, the bytes its
        pool reserved)."""
        torch.cuda.synchronize(self.device)
        # A graph that dies inside a capture (its owner left in a reference
        # cycle, found by the collector there) is destroyed by a call that
        # a capture forbids, and the capture fails. So the dead are
        # collected now, and the collector waits until the capture ends.
        gc.collect()
        # capture empties the allocator's cache first; emptied here, the
        # reserve grows by the graph's private pool alone
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool_handle()):
                self.body()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        return (graph, time.perf_counter() - t0,
                torch.cuda.memory_reserved(self.device) - reserved)

    def stats(self) -> dict:
        return {'capture_s': self.capture_seconds,
                'pool_bytes': self.pool_bytes, 'replays': self.replays,
                'launches_per_replay': self.tally.by_name()}


def copy_into(dst, src) -> None:
    """Copy ``src`` into the static buffers ``dst`` of the same structure
    (tensors, dicts, lists, tuples and dataclasses of them; ``None``
    leaves are skipped)."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src, strict=True):
            copy_into(d, s)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name))


def clone_tree(tree):
    """A copy of ``tree`` with every tensor cloned; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: clone_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree
