"""A loop body captured once as a CUDA graph and replayed.

The counterpart of the JAX package's ``jax.jit`` over a ``lax.scan``: a
body of many small kernels (a DQN chunk of steps, a PPO rollout, the
bench rollout) is recorded once and then launched as one graph, so that
the host issues one launch where it issued hundreds.

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

Launch counters (``step_kernel.step.launches`` and the others that
``launch_counters`` lists, a tracked ``Counter`` among them) count in
Python, where a wrapper enqueues its kernel. Capture enqueues nothing, so
the counts a capture made are taken back and kept as the graph's tally,
and each replay adds that tally: a counter then counts the launches that
ran, replays included.

Results go back to the caller as clones (``clone_tree``), so that a state
the caller holds does not change when the next call replays over the
same buffers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import weakref
from typing import Callable, Dict, Optional

import torch


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
    from marlsnake_torch.ops import floodfill, safety_mask, step_kernel
    return (step_kernel.step_autoreset, step_kernel.step,
            safety_mask.safety_mask, floodfill.reachable_count,
            *_TRACKED)


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
    ``replays`` say what it cost; ``tally`` holds its launches."""

    def __init__(self, body: Callable[[], None], device):
        self.body = body
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally = LaunchTally()
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.replays = 0

    def __call__(self) -> None:
        if self.device.type != 'cuda':
            self.body()
        elif self.graph is None:
            self._warm_up()
            self._capture()
        else:
            self.graph.replay()
            self.replays += 1
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

    def _capture(self) -> None:
        with self.tally.recording():
            self.graph, self.capture_seconds, self.pool_bytes = \
                self._record()

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
            with torch.cuda.graph(graph):
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
