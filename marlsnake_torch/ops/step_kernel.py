"""The fused step + auto-reset on the GPU: a hand-written CUDA kernel.

``step_autoreset`` computes ``engine.step_autoreset`` (state, reward,
done, rank, episodic stats and the uint8 obs) for a batch of envs in one
launch of ``csrc/step_autoreset.cu``, the port of the Pallas kernel
``marlsnake_tpu/ops/pallas_step.py::_step_block`` and its launcher. The
random numbers come in as ``StepDraws``, as the Pallas launcher
precomputes them, so kernel and plain version agree bit for bit.

On CPU tensors the wrapper runs the plain version,
``engine.step_autoreset``. On CUDA tensors it launches the kernel or
raises; it never falls back. ``step_autoreset.launches`` counts launches.

The library is built on first use with ``nvcc`` (sm_90a, ``-fmad=false``)
from the source in this package into ``build/marlsnake_torch/`` at the
repository root, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

import torch

from marlsnake_torch.core import engine
from marlsnake_torch.core.state import EnvState, ring_num_words
from marlsnake_torch.core.types import EnvConfig, check_port_scope
from marlsnake_torch.rng import StepDraws

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, 'csrc', 'step_autoreset.cu')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'marlsnake_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-fmad=false', '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

# Limits of the kernel itself (the plain version has none): per-snake
# phases run on threads < N of a 128-thread block, the fruit draws on
# threads < max(N, nf), and the grid, a prefix-count buffer and the rings
# must fit the block's static shared-memory window.
MAX_SNAKES = 32
MAX_DRAWS = 32
MAX_DYNAMIC_SMEM = 40 * 1024


class _StepArgs(ctypes.Structure):
    """Mirror of ``struct StepArgs`` in csrc/step_autoreset.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            'grid', 'dir', 'head', 'tail', 'ring', 'ring_head', 'ring_len',
            'alive', 'alive_count', 'epi_scores', 'epi_steps',
            'epi_fruits', 'epi_kills', 'episode_length', 'actions',
            'fruit_u', 'reset_spawn_u', 'reset_fruit_u', 'pool_cells',
            'base_grid',
            'o_grid', 'o_dir', 'o_head', 'o_tail', 'o_ring',
            'o_ring_head', 'o_ring_len', 'o_alive', 'o_alive_count',
            'o_epi_scores', 'o_epi_steps', 'o_epi_fruits', 'o_epi_kills',
            'o_episode_length', 'o_reward', 'o_done', 'o_rank',
            'o_io_scores', 'o_io_steps', 'o_io_fruits', 'o_io_kills',
            'o_done_all', 'o_obs')]
        + [(name, ctypes.c_int) for name in (
            'B', 'H', 'W', 'N', 'K', 'NF', 'P', 'CW', 'cap', 'human',
            'any_mode', 'max_steps')]
        + [(name, ctypes.c_float) for name in (
            'r_fruit', 'r_kill', 'r_lose', 'r_win', 'r_time')])


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA step kernel is built '
                           'with the CUDA toolkit on the GPU machine')
    return found


def build_library() -> Tuple[str, str]:
    """Compile the kernel if its library is not built yet; returns
    (library path, compiler output, which lists registers and shared
    memory). The file name carries a hash of the source and flags, so an
    edited source is rebuilt."""
    with open(SOURCE, 'rb') as fp:
        digest = hashlib.sha256(fp.read() + ' '.join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR,
                        f'step_autoreset_{digest.hexdigest()[:16]}.so')
    if os.path.exists(path):
        return path, ''
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    lib.marlsnake_step_autoreset.argtypes = [ctypes.POINTER(_StepArgs),
                                             ctypes.c_void_p]
    lib.marlsnake_step_autoreset.restype = ctypes.c_int
    lib.marlsnake_error_string.argtypes = [ctypes.c_int]
    lib.marlsnake_error_string.restype = ctypes.c_char_p
    return lib


def _check_scope(cfg: EnvConfig, spawn: engine.SpawnTables) -> None:
    check_port_scope(cfg)
    if spawn.cells.shape[0] != cfg.spawn_pool_size:
        # the row pick maps u -> int(u * P): a pool of another size would
        # silently give other resets than the config promises
        raise ValueError(
            f'spawn pool has {spawn.cells.shape[0]} rows but '
            f'cfg.spawn_pool_size={cfg.spawn_pool_size}')


def _check_kernel_limits(cfg: EnvConfig) -> None:
    n, nf = cfg.num_snakes, cfg.resolved_num_fruits
    cw = ring_num_words(cfg.body_capacity)
    smem = (2 * cfg.height * cfg.width + n * cw) * 4
    if n > MAX_SNAKES or nf > MAX_DRAWS or smem > MAX_DYNAMIC_SMEM:
        raise NotImplementedError(
            f'the CUDA step kernel takes num_snakes <= {MAX_SNAKES}, '
            f'num_fruits <= {MAX_DRAWS} and boards whose grid and rings '
            f'fit {MAX_DYNAMIC_SMEM} bytes of shared memory (this config: '
            f'{n} snakes, {nf} fruits, {smem} bytes); see ROADMAP.md')


def _input(t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f'expected {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'expected shape {tuple(shape)}, got '
                         f'{tuple(t.shape)}')
    if t.device != device:
        raise ValueError(f'expected a tensor on {device}, got {t.device}')
    return t.contiguous()


def _launch(cfg: EnvConfig, spawn: engine.SpawnTables, state: EnvState,
            actions: torch.Tensor, draws: StepDraws
            ) -> Tuple[EnvState, engine.StepOutput]:
    _check_kernel_limits(cfg)
    lib = load_library()
    dev = state.device
    b = state.num_envs
    h, w, n, k = cfg.height, cfg.width, cfg.num_snakes, cfg.snake_length
    nf = cfg.resolved_num_fruits
    cap = cfg.body_capacity
    cw = ring_num_words(cap)
    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    bn = (b, n)
    ins = [
        _input(state.grid, i32, (b, h, w), dev),
        _input(state.direction, i32, bn, dev),
        _input(state.head, i32, (b, n, 2), dev),
        _input(state.tail, i32, (b, n, 2), dev),
        _input(state.ring, i32, (b, n, cw), dev),
        _input(state.ring_head, i32, bn, dev),
        _input(state.ring_len, i32, bn, dev),
        _input(state.alive, torch.bool, bn, dev),
        _input(state.alive_count, i32, (b,), dev),
        _input(state.epi_scores, f32, bn, dev),
        _input(state.epi_steps, f32, bn, dev),
        _input(state.epi_fruits, f32, bn, dev),
        _input(state.epi_kills, f32, bn, dev),
        _input(state.episode_length, i32, (b,), dev),
        _input(actions.to(i32), i32, bn, dev),
        _input(draws.fruit_u, f32, bn, dev),
        _input(draws.reset_spawn_u, f32, (b,), dev),
        _input(draws.reset_fruit_u, f32, (b, nf), dev),
        _input(spawn.cells, i32, (cfg.spawn_pool_size, n * k), dev),
        _input(spawn.base_grid, i32, (h, w), dev),
    ]

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    new_state = EnvState(
        grid=empty((b, h, w), i32), direction=empty(bn, i32),
        head=empty((b, n, 2), i32), tail=empty((b, n, 2), i32),
        ring=empty((b, n, cw), i32), ring_head=empty(bn, i32),
        ring_len=empty(bn, i32), alive=empty(bn, torch.bool),
        alive_count=empty((b,), i32), epi_scores=empty(bn, f32),
        epi_steps=empty(bn, f32), epi_fruits=empty(bn, f32),
        epi_kills=empty(bn, f32), episode_length=empty((b,), i32))
    out = engine.StepOutput(
        obs=empty((b, n, h, w, 8), u8), reward=empty(bn, f32),
        done=empty(bn, torch.bool), rank=empty(bn, i32),
        episode_scores=empty(bn, f32), episode_steps=empty(bn, f32),
        episode_fruits=empty(bn, f32), episode_kills=empty(bn, f32),
        done_all=empty((b,), torch.bool))
    outs = ([t for _, t in new_state.fields()]
            + [out.reward, out.done, out.rank, out.episode_scores,
               out.episode_steps, out.episode_fruits, out.episode_kills,
               out.done_all, out.obs])
    r_fruit, r_kill, r_lose, r_win, r_time = cfg.rewards
    args = _StepArgs(
        *[t.data_ptr() for t in ins + outs],
        b, h, w, n, k, nf, cfg.spawn_pool_size, cw, cap,
        int(cfg.observer == 'human'), int(cfg.done_mode == 'any'),
        cfg.max_episode_steps, r_fruit, r_kill, r_lose, r_win, r_time)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.marlsnake_step_autoreset(ctypes.byref(args),
                                          ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError('step_autoreset kernel launch failed: '
                           f'{lib.marlsnake_error_string(rc).decode()}')
    step_autoreset.launches += 1
    return new_state, out


def step_autoreset(cfg: EnvConfig, spawn: engine.SpawnTables,
                   state: EnvState, actions: torch.Tensor,
                   draws: StepDraws) -> Tuple[EnvState, engine.StepOutput]:
    """``engine.step_autoreset`` for a batch of envs: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    _check_scope(cfg, spawn)
    if state.device.type == 'cpu':
        return engine.step_autoreset(cfg, spawn, state, actions, draws)
    if state.device.type != 'cuda':
        raise ValueError(f'unsupported device {state.device}')
    return _launch(cfg, spawn, state, actions, draws)


step_autoreset.launches = 0
