"""Checkpoints of nested dicts (and lists or tuples) of tensors and numbers.

``save`` writes the payload with ``torch.save`` to a temporary file beside
the target and renames it into place, so a reader never sees a file half
written. ``restore`` loads it with ``weights_only=True`` onto the devices of
a ``template`` of the same structure (a freshly initialised state) and
checks every leaf's shape and dtype against it, raising ``KeyError`` for a
key the file lacks and ``ValueError`` for a leaf that does not fit.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save(path: str, payload: Any) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    try:
        torch.save(_to_cpu(payload), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore(path: str, template: Any) -> Any:
    loaded = torch.load(os.path.abspath(path), map_location='cpu',
                        weights_only=True)
    return _fit(loaded, template, '')


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
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
