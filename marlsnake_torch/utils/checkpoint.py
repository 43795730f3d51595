"""Checkpoints of nested dicts (and lists or tuples) of tensors and numbers.

``save`` writes the payload with ``torch.save`` to a temporary file beside
the target and renames it into place, so a reader never sees a file half
written. ``restore`` loads it with ``weights_only=True`` onto the devices of
a ``template`` of the same structure (a freshly initialised state) and
checks every leaf's shape and dtype against it, raising ``KeyError`` for a
key the file lacks and ``ValueError`` for a leaf that does not fit.
``AsyncCheckpointer`` copies a payload to the host at once and writes it
on a background thread, so that training goes on while it flushes.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import torch


def save(path: str, payload: Any) -> None:
    _write(path, _to_cpu(payload))


def _write(path: str, host_payload: Any) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.{threading.get_ident()}.tmp'
    try:
        torch.save(host_payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class AsyncCheckpointer:
    """Checkpoint writer whose writes run on a background thread: ``save``
    copies the payload to host memory before it returns (so the caller
    may go on changing its tensors) and writes it as ``save`` above does,
    after the previous write; ``wait`` blocks until the last write is on
    disk and raises its error, if it failed; ``close`` waits and stops the
    thread."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def save(self, path: str, payload: Any) -> None:
        self.wait()
        self._pending = self._pool.submit(_write, path,
                                          _to_cpu(payload, copy=True))

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()


def restore(path: str, template: Any) -> Any:
    loaded = torch.load(os.path.abspath(path), map_location='cpu',
                        weights_only=True)
    return _fit(loaded, template, '')


def _to_cpu(tree: Any, copy: bool = False) -> Any:
    """``tree`` with its tensors on the CPU; ``copy=True`` copies those
    that were there already."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=copy)
    if isinstance(tree, dict):
        return {k: _to_cpu(v, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v, copy) for v in tree]
    return tree


def _fit(loaded: Any, template: Any, where: str) -> Any:
    """``loaded`` in the structure, devices and types of ``template``."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f'{where or "checkpoint"}: expected a dict')
        missing = [k for k in template if k not in loaded]
        if missing:
            raise KeyError(f'{where or "checkpoint"} lacks {missing}')
        return {k: _fit(loaded[k], v, f'{where}/{k}')
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) \
                or len(loaded) != len(template):
            raise ValueError(f'{where}: expected {len(template)} items')
        return type(template)(_fit(a, b, f'{where}[{i}]')
                              for i, (a, b) in enumerate(zip(loaded,
                                                             template)))
    if isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) \
                or loaded.shape != template.shape \
                or loaded.dtype != template.dtype:
            got = (f'{loaded.dtype} {tuple(loaded.shape)}'
                   if isinstance(loaded, torch.Tensor) else type(loaded))
            raise ValueError(f'{where}: expected {template.dtype} '
                             f'{tuple(template.shape)}, got {got}')
        return loaded.to(template.device)
    return type(template)(loaded)
