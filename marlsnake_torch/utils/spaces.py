"""Minimal gym-free space types.

The port's copy of the JAX package's ``utils/spaces.py``. The framework
has no gym dependency; these cover the slice of the gym
space API the reference relies on (``.n``, ``.shape``, ``.sample()`` —
wrappers.py:84-124, tests/test_snake.py:64).
"""

from __future__ import annotations

import numpy as np


class Discrete:
    def __init__(self, n: int, seed: int = 0):
        self.n = int(n)
        self._rng = np.random.default_rng(seed)

    @property
    def shape(self):
        return ()

    def sample(self) -> int:
        return int(self._rng.integers(0, self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f'Discrete({self.n})'


class Box:
    def __init__(self, low, high, shape, dtype=np.uint8, seed: int = 0):
        self.low = low
        self.high = high
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        if np.issubdtype(self.dtype, np.integer):
            return self._rng.integers(
                self.low, self.high + 1, size=self.shape).astype(self.dtype)
        return self._rng.uniform(
            self.low, self.high, size=self.shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and np.all(x >= self.low)
                and np.all(x <= self.high))

    def __repr__(self):
        return f'Box({self.low}, {self.high}, {self.shape}, {self.dtype})'
