"""Spawn candidates and the pool of disjoint spawn combinations (host, numpy).

The candidate set depends only on the board: every k-cell self-avoiding
path on the empty bordered grid, enumerated in the reference's order
(row-major sweep, neighbours in ``SHIFTS`` order, the ``_head_blocked``
prune). ``spawn_pool`` then rejection-samples disjoint N-tuples ONCE per
config with a seeded numpy generator, and a reset draws one pool row.
Same enumeration and same seeded draws as the JAX package's
``core/spawn.py``, so both packages hold identical pools.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from marlsnake_torch.core import types as T

SHIFTS = ((0, 1), (1, 0), (0, -1), (-1, 0))


def _head_blocked(mask: np.ndarray, history, extra_node) -> bool:
    check = 0
    first = history[0]
    for sr, sc in SHIFTS:
        node = (first[0] + sr, first[1] + sc)
        if mask[node] == 0 or node in history or node == extra_node:
            check += 1
    return check == len(SHIFTS)


def _dfs(mask: np.ndarray, node, history, k, out):
    history = history + [node]
    if len(history) == k:
        out.append(history)
        return
    for sr, sc in SHIFTS:
        cand = (node[0] + sr, node[1] + sc)
        if (0 <= cand[0] < mask.shape[0] and 0 <= cand[1] < mask.shape[1]
                and cand not in history and mask[cand]):
            if not _head_blocked(mask, history, cand):
                _dfs(mask, cand, history, k, out)


@functools.lru_cache(maxsize=32)
def spawn_candidates(height: int, width: int, k: int,
                     map_layout=None) -> np.ndarray:
    """(C, k, 2) int32 candidate paths, head first, on a bordered grid
    (plus the interior walls of ``map_layout``)."""
    mask = np.ones((height, width), dtype=np.uint8)
    mask[[0, -1]] = 0
    mask[:, [0, -1]] = 0
    if map_layout is not None:
        from marlsnake_torch.core.maps import parse_layout
        mask[parse_layout(map_layout)] = 0
    out = []
    for r in range(height):
        for c in range(width):
            if mask[r, c]:
                _dfs(mask, (r, c), [], k, out)
    if not out:
        return np.zeros((0, k, 2), dtype=np.int32)
    return np.asarray(out, dtype=np.int32)


@functools.lru_cache(maxsize=32)
def spawn_pool(height: int, width: int, k: int, num_snakes: int,
               pool_size: int = 1 << 16, seed: int = 0,
               map_layout=None) -> np.ndarray:
    """(pool_size, num_snakes) int32 rows of candidate indices whose paths
    are pairwise disjoint."""
    cand = spawn_candidates(height, width, k, map_layout)
    c = len(cand)
    if c == 0:
        return np.zeros((0, num_snakes), np.int32)
    rng = np.random.default_rng(seed)
    cells = cand[:, :, 0].astype(np.int32) * width + cand[:, :, 1]
    rows = []
    need = pool_size
    for _ in range(64):
        if need <= 0:
            break
        draw = rng.integers(0, c, size=(max(need * 2, 1024), num_snakes))
        flat = cells[draw].reshape(len(draw), -1)
        ok = (np.diff(np.sort(flat, axis=1), axis=1) != 0).all(axis=1)
        good = draw[ok]
        rows.append(good[:need])
        need -= len(good[:need])
    if sum(len(r) for r in rows) == 0:
        raise ValueError('no disjoint spawn combination found')
    pool = np.concatenate(rows, axis=0)
    if len(pool) < pool_size:
        # tight boards: tile what was found
        pool = np.tile(pool, (-(-pool_size // len(pool)), 1))[:pool_size]
    return np.ascontiguousarray(pool.astype(np.int32))


class SpawnData(NamedTuple):
    """Per-pool-row reset data: ``cells`` (P, N*k) int32, the head-first
    flat cells ``r * W + c`` of every snake of the row."""
    cells: np.ndarray


def base_grid_host(height: int, width: int, map_layout=None) -> np.ndarray:
    """(H, W) int32 empty board: border walls (or the layout's walls)."""
    if map_layout is not None:
        from marlsnake_torch.core.maps import parse_layout
        return np.where(parse_layout(map_layout), T.WALL,
                        T.EMPTY).astype(np.int32)
    grid = np.full((height, width), T.EMPTY, dtype=np.int32)
    grid[[0, -1], :] = T.WALL
    grid[:, [0, -1]] = T.WALL
    return grid


@functools.lru_cache(maxsize=32)
def spawn_data(height: int, width: int, k: int, num_snakes: int,
               pool_size: int = 1 << 16, seed: int = 0,
               map_layout=None) -> SpawnData:
    """Flat spawn cells of every pool row."""
    cand = spawn_candidates(height, width, k, map_layout)
    pool = spawn_pool(height, width, k, num_snakes, pool_size, seed,
                      map_layout)
    coords = cand[pool]  # (P, N, k, 2)
    cells = coords[..., 0].astype(np.int64) * width + coords[..., 1]
    cells = cells.reshape(cells.shape[0], -1).astype(np.int32)
    return SpawnData(cells=np.ascontiguousarray(cells))
