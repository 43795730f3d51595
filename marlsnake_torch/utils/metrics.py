"""Metric sink: TensorBoard where it can be imported, and always a JSONL
file of the same scalars, so a headless run stays inspectable."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricWriter:
    def __init__(self, log_dir: str, jsonl: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._tb = None
        self._jsonl = None
        if jsonl:
            self._jsonl = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {'ts': time.time(), 'tag': tag, 'value': float(value),
                 'step': int(step)}) + '\n')

    def add_scalars(self, scalars: dict, step: int) -> None:
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


class Throughput:
    """Steps per second with exponential smoothing."""

    def __init__(self, alpha: float = 0.1):
        self._last_t: Optional[float] = None
        self._last_steps = 0
        self._rate = 0.0
        self._alpha = alpha

    def update(self, total_steps: int) -> float:
        now = time.perf_counter()
        if self._last_t is not None and now > self._last_t:
            inst = (total_steps - self._last_steps) / (now - self._last_t)
            self._rate = (self._alpha * inst
                          + (1 - self._alpha) * self._rate
                          if self._rate else inst)
        self._last_t = now
        self._last_steps = total_steps
        return self._rate
