"""Host-side rendering from grid snapshots.

The port's copy of the JAX package's ``core/render.py``, on the port's
``core/types``; PIL is imported inside the functions that draw.
Presentation-layer port of the reference render paths — ASCII
(snake_env.py:267-284), flat RGB with the per-snake color wheel and
``0.7**cycle`` dimming (core/grid_util.py:164-175 + core/snake.py:14-30),
GIF frame capture (snake_env.py:285-290,419-436), and the "fancy" renderer
with round heads and direction-aware eyes (snake_env.py:165-265). All of it
is pure host code operating on a numpy grid snapshot; it never touches the
device hot path.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import List, Optional

import numpy as np

from marlsnake_torch.core import types as T

# Body color wheel (core/snake.py:15) and brightened head wheel (:18-21).
COLOR_WHEEL = [(104, 255, 0), (255, 191, 0), (255, 0, 92), (0, 111, 255)]
HEAD_WHEEL = [tuple(min(255, int(v * 2.0)) for v in c) for c in COLOR_WHEEL]

CELL_COLORS = {
    T.EMPTY: [(0, 0, 0)],
    T.WALL: [(32, 32, 32)],
    T.FRUIT: [(223, 7, 22)],
    T.HEAD: HEAD_WHEEL,
    T.BODY: COLOR_WHEEL,
    T.TAIL: COLOR_WHEEL,
}

SYM2CHR = {T.EMPTY: '.', T.WALL: '#', T.FRUIT: 'o',
           T.BODY: 'b', T.HEAD: 'H', T.TAIL: 't'}

# Fancy-mode palette (snake_env.py:20-29).
FANCY_BG = (40, 44, 52)
FANCY_WALL = (80, 80, 80)
FANCY_FRUIT = (230, 70, 70)
FANCY_SNAKES = [(80, 200, 120), (80, 160, 240), (200, 100, 240),
                (240, 200, 80)]


def render_ascii(grid: np.ndarray) -> str:
    t = T.cell_type(np.asarray(grid))
    return '\n'.join(''.join(SYM2CHR[int(v)] for v in row) for row in t)


def rgb_from_grid(grid: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 flat render; vectorized (no per-cell Python loop)."""
    grid = np.asarray(grid)
    t = T.cell_type(grid)
    owner = T.cell_owner(grid)
    out = np.zeros((*grid.shape, 3), dtype=np.float32)
    out[t == T.WALL] = CELL_COLORS[T.WALL][0]
    out[t == T.FRUIT] = CELL_COLORS[T.FRUIT][0]
    ncolors = len(COLOR_WHEEL)
    for cell, wheel in ((T.HEAD, HEAD_WHEEL), (T.BODY, COLOR_WHEEL),
                        (T.TAIL, COLOR_WHEEL)):
        mask = t == cell
        if not mask.any():
            continue
        ids = owner[mask]
        base = np.asarray(wheel, dtype=np.float32)[ids % ncolors]
        dim = 0.7 ** (ids // ncolors).astype(np.float32)
        out[mask] = base * dim[:, None]
    return out.astype(np.uint8)


def image_from_grid(grid: np.ndarray, max_size: int = 300):
    from PIL import Image
    grid = np.asarray(grid)
    scale = max(max_size // max(grid.shape), 1)
    rgb = rgb_from_grid(grid)
    rgb = np.repeat(np.repeat(rgb, scale, axis=0), scale, axis=1)
    return Image.fromarray(rgb, 'RGB')


def render_fancy(grid: np.ndarray, directions: Optional[np.ndarray] = None,
                 alive: Optional[np.ndarray] = None,
                 cell_size: int = 40, save_path: Optional[str] = None
                 ) -> np.ndarray:
    """High-res render with round snake heads and direction-aware eyes."""
    from PIL import Image, ImageDraw
    grid = np.asarray(grid)
    h, w = grid.shape
    img = Image.new('RGB', (w * cell_size, h * cell_size), FANCY_BG)
    draw = ImageDraw.Draw(img)
    t = T.cell_type(grid)
    owner = T.cell_owner(grid)

    for r in range(h):
        for c in range(w):
            x, y = c * cell_size, r * cell_size
            if t[r, c] == T.WALL:
                draw.rectangle([x, y, x + cell_size, y + cell_size],
                               fill=FANCY_WALL)
            elif t[r, c] == T.FRUIT:
                p = cell_size * 0.2
                draw.ellipse([x + p, y + p, x + cell_size - p,
                              y + cell_size - p], fill=FANCY_FRUIT)

    snake_cells = t >= T.HEAD
    for r, c in zip(*np.where(snake_cells)):
        sid = owner[r, c]
        if alive is not None and not alive[sid]:
            continue
        color = FANCY_SNAKES[sid % len(FANCY_SNAKES)]
        x, y = c * cell_size, r * cell_size
        draw.rectangle([x, y, x + cell_size, y + cell_size], fill=color)

    # heads on top, with eyes
    for r, c in zip(*np.where(t == T.HEAD)):
        sid = owner[r, c]
        if alive is not None and not alive[sid]:
            continue
        color = FANCY_SNAKES[sid % len(FANCY_SNAKES)]
        x, y = c * cell_size, r * cell_size
        draw.ellipse([x, y, x + cell_size, y + cell_size], fill=color)
        if directions is None:
            continue
        dy, dx = T.DIR_DELTA[int(directions[sid])]
        cx, cy = x + cell_size / 2, y + cell_size / 2
        er = cell_size * 0.1
        off_f, off_s = cell_size * 0.3, cell_size * 0.15
        for sgn in (-1, 1):
            ex = cx + dx * off_f + sgn * dy * off_s
            ey = cy + dy * off_f + sgn * dx * off_s
            draw.ellipse([ex - er, ey - er, ex + er, ey + er],
                         fill=(255, 255, 255))
            pr = er * 0.5
            draw.ellipse([ex - pr, ey - pr, ex + pr, ey + pr],
                         fill=(0, 0, 0))

    if save_path:
        img.save(save_path)
    return np.asarray(img)


class GifRecorder:
    """Frame buffer + GIF writer (reference snake_env.py:285-290,419-436)."""

    def __init__(self):
        self.frames: List = []

    def capture(self, grid: np.ndarray):
        self.frames.append(image_from_grid(grid))

    def save(self, fp=None):
        if fp is None:
            save_dir = os.path.join(os.getcwd(), 'tmp')
            now = datetime.datetime.now().strftime('%Y%m%d%H%M%S')
            os.makedirs(save_dir, exist_ok=True)
            fp = os.path.join(save_dir, f'{now}.gif')
        if not self.frames:
            warnings.warn("No frames captured; call capture() first.")
        else:
            self.frames[0].save(fp, save_all=True,
                                append_images=self.frames[1:],
                                format='GIF', loop=0)
        return fp
