"""ASCII map layouts: ``#`` is a wall, any other character is empty.

The port's copy of ``parse_layout`` from the JAX package's
``core/maps.py``. Loading the bundled map files is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

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
