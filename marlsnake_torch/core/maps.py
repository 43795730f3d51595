"""ASCII map layouts: ``#`` is a wall, any other character is empty.

The port's copy of the JAX package's ``core/maps.py``: ``parse_layout``,
and ``load_layout`` / ``bundled_maps`` over the port's own copies of the
bundled map files (``marlsnake_torch/assets/*.txt``). The assets'
decorative ``O`` is empty, as in the reference.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets')

WALL_CHAR = '#'


def parse_layout(layout: Sequence[str]) -> np.ndarray:
    """(H, W) bool wall mask from layout strings."""
    widths = {len(row) for row in layout}
    if len(widths) != 1:
        raise ValueError('all map rows must have equal width')
    mask = np.array([[c == WALL_CHAR for c in row] for row in layout],
                    dtype=bool)
    if mask.shape[0] < 3 or mask.shape[1] < 3:
        raise ValueError('map too small')
    border = np.concatenate([mask[0], mask[-1], mask[:, 0], mask[:, -1]])
    if not border.all():
        raise ValueError('map border must be all walls (#)')
    return mask


def load_layout(path_or_name: str) -> Tuple[str, ...]:
    """Load a layout from a file path or a bundled asset name."""
    path = path_or_name
    if not os.path.exists(path):
        cand = os.path.join(ASSET_DIR, path_or_name)
        if not cand.endswith('.txt'):
            cand += '.txt'
        if os.path.exists(cand):
            path = cand
        else:
            raise FileNotFoundError(path_or_name)
    with open(path) as fp:
        rows = [line.rstrip('\n') for line in fp.read().split('\n')
                if line.strip()]
    return tuple(rows)


def bundled_maps() -> Tuple[str, ...]:
    if not os.path.isdir(ASSET_DIR):
        return ()
    return tuple(sorted(f[:-4] for f in os.listdir(ASSET_DIR)
                        if f.endswith('.txt')))
