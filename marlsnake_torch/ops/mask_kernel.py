"""The library of ``csrc/safety_mask.cu``: its limits, argument checks and
launchers.

Two entries: ``reachable_count`` (the bounded flood fill of many boards) and
``masked_actions`` (the whole safety mask of a batch of envs). Their
wrappers, which keep the launch counts and run the plain versions on CPU
tensors, are ``ops/floodfill.reachable_count`` and
``ops/safety_mask.safety_mask``; the launchers here take CUDA tensors only.

The checks (``check_reachable_args``, ``check_mask_args``) run before any
build or launch and need no GPU. They raise ``ValueError`` on a wrong dtype
or shape and ``NotImplementedError`` on what the kernel does not take: more
than 32 snakes, boards beyond 224 rows or 256 columns (one warp holds a
board as 32-bit rows, at most 7 rows a lane and 8 words a row), or an env
whose snakes' boards do not fit one block's shared memory.

The library is built on first use with nvcc (``ops/cuda_build.py``) into
``build/marlsnake_torch/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch

from marlsnake_torch.ops import cuda_build

SOURCE = os.path.join(cuda_build.CSRC_DIR, 'safety_mask.cu')

MAX_SNAKES = 32
MAX_HEIGHT = 224                 # 7 rows on each lane of a warp
MAX_WIDTH = 256                  # 8 words of 32 bits a row
MAX_SMEM_PER_ENV = 232448        # one block's shared memory on an H100
SNAKE_INFO_BYTES = 112           # sizeof(SnakeInfo) in the source
INT32_MAX = 2 ** 31 - 1


class _MaskArgs(ctypes.Structure):
    """Mirror of ``struct MaskArgs`` in csrc/safety_mask.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            'obs', 'q', 'dirs', 'active', 'claims', 'act', 'new_dir',
            'next_pos', 'head_exists', 'scratch')]
        + [('s_env', ctypes.c_int64), ('s_snake', ctypes.c_int64)]
        + [(name, ctypes.c_int) for name in (
            'E', 'N', 'H', 'W', 'C', 'limit', 'vec8')])


def build_library() -> Tuple[str, str]:
    """(library path, compiler output); see ``cuda_build.build``."""
    return cuda_build.build(SOURCE)[0]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return bind_library(build_library()[0])


def bind_library(path: str) -> ctypes.CDLL:
    """The library at ``path`` with its entries' argument types set."""
    lib = ctypes.CDLL(path)
    lib.marlsnake_reachable_count.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.marlsnake_reachable_count.restype = ctypes.c_int
    lib.marlsnake_masked_actions.argtypes = [ctypes.POINTER(_MaskArgs),
                                             ctypes.c_void_p]
    lib.marlsnake_masked_actions.restype = ctypes.c_int
    lib.marlsnake_mask_error_string.argtypes = [ctypes.c_int]
    lib.marlsnake_mask_error_string.restype = ctypes.c_char_p
    return lib


def words_per_row(w: int) -> int:
    """32-bit words a board row takes in the kernel (1, 2, 4 or 8)."""
    need = -(-w // 32)
    return next(k for k in (1, 2, 4, 8) if k >= need)


def smem_per_env(n: int, h: int, w: int) -> int:
    """Shared memory that one env's block in ``masked_actions`` needs: each
    snake's record and its deadly plane (the blocked cells of its post-move
    boards, a bit a cell, H x words_per_row(W) words)."""
    return n * (SNAKE_INFO_BYTES + 4 * h * words_per_row(w))


def extra_planes_bytes(n: int, h: int, w: int) -> int:
    """The block's other planes (each snake's other heads, fruit and own
    body, and the env's claimed cells), in shared memory beside
    ``smem_per_env``'s where both fit, else in scratch in device memory."""
    return (3 * n + 1) * 4 * h * words_per_row(w)


def check_board(h: int, w: int) -> None:
    if not (1 <= h <= MAX_HEIGHT and 1 <= w <= MAX_WIDTH):
        raise NotImplementedError(
            f'the safety-mask kernel takes boards of 1 to {MAX_HEIGHT} rows '
            f'and 1 to {MAX_WIDTH} columns, not {h}x{w}; see ROADMAP.md')


def _limit(limit: int) -> int:
    # the count never exceeds H * W, so a larger cap means no cap
    return max(min(int(limit), INT32_MAX), -INT32_MAX - 1)


def check_reachable_args(passable: torch.Tensor, start: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boards (M, H, W) bool, starts (M, 2) int32), both contiguous, of
    ``reachable_count``'s arguments: passable (..., H, W) bool, start
    (..., 2) integer with the same leading axes."""
    if passable.dtype != torch.bool:
        raise ValueError(f'passable must be bool, not {passable.dtype}')
    if passable.dim() < 2:
        raise ValueError('passable must be (..., H, W)')
    h, w = passable.shape[-2:]
    if tuple(start.shape) != tuple(passable.shape[:-2]) + (2,):
        raise ValueError(f'start must be {tuple(passable.shape[:-2]) + (2,)}'
                         f', not {tuple(start.shape)}')
    if start.dtype.is_floating_point or start.dtype == torch.bool \
            or start.is_complex():
        raise ValueError(f'start must be integer, not {start.dtype}')
    if start.device != passable.device:
        raise ValueError(f'start is on {start.device}, passable on '
                         f'{passable.device}')
    check_board(h, w)
    return (passable.reshape(-1, h, w).contiguous(),
            start.reshape(-1, 2).to(torch.int32).contiguous())


def launch_reachable_count(boards: torch.Tensor, starts: torch.Tensor,
                           limit: int) -> torch.Tensor:
    """One launch of ``reachable_count`` on checked CUDA tensors; returns
    int32 (M,)."""
    m, h, w = boards.shape
    out = torch.empty(m, dtype=torch.int32, device=boards.device)
    lib = load_library()
    rc = cuda_build.on_current_stream(
        boards.device.index, lambda stream: lib.marlsnake_reachable_count(
            boards.data_ptr(), starts.data_ptr(), m, h, w, _limit(limit),
            out.data_ptr(), stream))
    cuda_build.raise_on(rc, 'reachable_count',
                        lib.marlsnake_mask_error_string)
    return out


class MaskInputs(NamedTuple):
    """``check_mask_args``'s result: the kernel's inputs."""
    obs: torch.Tensor              # (E, N, H, W, C) uint8, (H, W, C) dense
    q: torch.Tensor                # (E, N, 3) float32, contiguous
    dirs: torch.Tensor             # (E, N, 2) int32, contiguous
    active: torch.Tensor           # (E, N) bool, contiguous
    claims: Optional[torch.Tensor]  # (E, H, W) bool, contiguous, or None


def check_mask_args(obs: torch.Tensor, q: torch.Tensor,
                    cur_dirs: torch.Tensor, active: torch.Tensor,
                    claims: Optional[torch.Tensor] = None) -> MaskInputs:
    """The kernel's inputs from ``safety_mask``'s arguments: obs (E, N, H,
    W, C >= 8) uint8 (any env and snake strides), q (E, N, 3) floating
    (cast to float32, which keeps the order), cur_dirs (E, N, 2) integer,
    active (E, N) bool, claims None or (E, H, W) bool."""
    if obs.dtype != torch.uint8:
        raise ValueError(f'obs must be uint8, not {obs.dtype}')
    if obs.dim() != 5 or obs.shape[-1] < 8:
        raise ValueError(f'obs must be (E, N, H, W, C >= 8), not '
                         f'{tuple(obs.shape)}')
    e, n, h, w, c = obs.shape
    if n < 1:
        raise ValueError('obs must hold at least one snake an env')
    if n > MAX_SNAKES:
        raise NotImplementedError(
            f'the safety-mask kernel takes at most {MAX_SNAKES} snakes an '
            f'env, not {n}; see ROADMAP.md')
    check_board(h, w)
    smem = smem_per_env(n, h, w)
    if smem > MAX_SMEM_PER_ENV:
        raise NotImplementedError(
            f'the safety-mask kernel holds an env in at most '
            f'{MAX_SMEM_PER_ENV} bytes of shared memory; {n} snakes of '
            f'{h}x{w} need {smem}; see ROADMAP.md')
    if tuple(q.shape) != (e, n, 3):
        raise ValueError(f'q must be (E, N, 3) = {(e, n, 3)}, not '
                         f'{tuple(q.shape)}')
    if not q.dtype.is_floating_point:
        raise ValueError(f'q must be floating, not {q.dtype}')
    if tuple(cur_dirs.shape) != (e, n, 2):
        raise ValueError(f'cur_dirs must be {(e, n, 2)}, not '
                         f'{tuple(cur_dirs.shape)}')
    if cur_dirs.dtype.is_floating_point or cur_dirs.dtype == torch.bool:
        raise ValueError(f'cur_dirs must be integer, not {cur_dirs.dtype}')
    if tuple(active.shape) != (e, n) or active.dtype != torch.bool:
        raise ValueError(f'active must be bool {(e, n)}, not '
                         f'{active.dtype} {tuple(active.shape)}')
    if claims is not None and (tuple(claims.shape) != (e, h, w)
                               or claims.dtype != torch.bool):
        raise ValueError(f'claims must be bool {(e, h, w)}, not '
                         f'{claims.dtype} {tuple(claims.shape)}')
    for name, t in (('q', q), ('cur_dirs', cur_dirs), ('active', active),
                    ('claims', claims)):
        if t is not None and t.device != obs.device:
            raise ValueError(f'{name} is on {t.device}, obs on {obs.device}')
    if obs.stride()[2:] != (w * c, c, 1):
        obs = obs.contiguous()
    return MaskInputs(
        obs, q.to(torch.float32).contiguous(),
        cur_dirs.to(torch.int32).contiguous(), active.contiguous(),
        None if claims is None else claims.contiguous())


class MaskOut(NamedTuple):
    """What the safety mask gives for E envs x N snakes."""
    act: torch.Tensor          # (E, N) int32; 0 for an inactive snake
    new_dir: torch.Tensor      # (E, N, 2) int32; an inactive snake's own
    next_pos: torch.Tensor     # (E, N, 2) int32: head + the chosen move
    head_exists: torch.Tensor  # (E, N) bool


def launch_masked_actions(inp: MaskInputs, limit: int) -> MaskOut:
    """One launch of ``masked_actions`` on checked CUDA tensors."""
    obs = inp.obs
    e, n, h, w, c = obs.shape
    dev = obs.device
    out = MaskOut(torch.empty((e, n), dtype=torch.int32, device=dev),
                  torch.empty((e, n, 2), dtype=torch.int32, device=dev),
                  torch.empty((e, n, 2), dtype=torch.int32, device=dev),
                  torch.empty((e, n), dtype=torch.bool, device=dev))
    scratch = None
    if smem_per_env(n, h, w) + extra_planes_bytes(n, h, w) \
            > MAX_SMEM_PER_ENV:
        scratch = torch.empty(e * extra_planes_bytes(n, h, w) // 4,
                              dtype=torch.int32, device=dev)
    # a stride of an axis of size 1 is never used
    s_env = obs.stride(0) if e > 1 else 0
    s_snake = obs.stride(1) if n > 1 else 0
    vec8 = (c % 8 == 0 and obs.data_ptr() % 8 == 0 and s_env % 8 == 0
            and s_snake % 8 == 0)
    args = _MaskArgs(
        obs=obs.data_ptr(), q=inp.q.data_ptr(), dirs=inp.dirs.data_ptr(),
        active=inp.active.data_ptr(),
        claims=None if inp.claims is None else inp.claims.data_ptr(),
        act=out.act.data_ptr(), new_dir=out.new_dir.data_ptr(),
        next_pos=out.next_pos.data_ptr(),
        head_exists=out.head_exists.data_ptr(),
        scratch=None if scratch is None else scratch.data_ptr(),
        s_env=s_env, s_snake=s_snake, E=e, N=n, H=h, W=w, C=c,
        limit=_limit(limit), vec8=int(vec8))
    lib = load_library()
    rc = cuda_build.on_current_stream(
        dev.index, lambda stream: lib.marlsnake_masked_actions(
            ctypes.byref(args), stream))
    cuda_build.raise_on(rc, 'masked_actions',
                        lib.marlsnake_mask_error_string)
    return out
