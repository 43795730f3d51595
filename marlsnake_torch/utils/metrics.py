"""Metric sink: TensorBoard where it can be imported, and always a JSONL
file of the same scalars, so a headless run stays inspectable."""

from __future__ import annotations

import json
import os
import time


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

