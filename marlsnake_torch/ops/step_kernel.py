"""The env step on the GPU: a hand-written CUDA kernel with two entries.

``step_autoreset`` computes ``engine.step_autoreset`` (state, reward,
done, rank, episodic stats and the obs) for a batch of envs in one
launch of ``csrc/step_autoreset.cu``, the port of the Pallas kernel
``marlsnake_tpu/ops/pallas_step.py::_step_block`` and its launcher. The
random numbers come in as ``StepDraws``, as the Pallas launcher
precomputes them, so kernel and plain version agree bit for bit.

``step`` computes ``engine.step``, the same step without auto-reset (the
DQN trainer's env step), through the kernel's second entry: the same
body with the reset compiled out, the same arena and launch plan. It can
hold chosen envs still inside the same launch (``hold``): such an env
leaves the step with the state and the step output it came in with.

Both entries cover every ``EnvConfig`` option: pool and procedural spawn,
uint8 and packed obs, the frame stack (raw-grid history and stored window
frames, both part of the state arena) and the vision window.

On CPU tensors a wrapper runs its plain version (``engine.step_autoreset``
or ``engine.step``). On CUDA tensors it launches the kernel or raises; it
never falls back. ``step_autoreset.launches`` and ``step.launches`` count
each entry's launches.

The launch path is built to cost the host less than the kernel costs the
device. A launch plan, made once per (cfg, num_envs, device), holds the
checks, the output layout and a reusable argument struct. Each step
allocates one byte arena for all 25 outputs (``output_layout``); the
returned ``EnvState`` and ``StepOutput`` cut their typed views from it on
first read, since the main path reads two or three of them and making a
tensor view is host work on the order of a kernel launch. A state this
wrapper returned goes back into the kernel as its arena, unchecked and
uncopied; any other state is checked and copied into an arena first.

The library is built on first use with ``nvcc`` (sm_90a, ``-fmad=false``;
``ops/cuda_build.py``) from the source in this package into
``build/marlsnake_torch/`` at the repository root, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch

from marlsnake_torch.core import engine
from marlsnake_torch.core.state import EnvState, ring_num_words
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.ops import cuda_build
from marlsnake_torch.rng import StepDraws, spawn_draw_shape

SOURCE = os.path.join(cuda_build.CSRC_DIR, 'step_autoreset.cu')

# Limits of the kernel itself (the plain version has none): one warp per
# env with lane i = snake i, the fruit draws on lanes < nf, and one env's
# grid and rings in shared memory, which one block holds at most
# 227 KB of on an H100.
MAX_SNAKES = 32
MAX_DRAWS = 32
MAX_SMEM_PER_ENV = 232448

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))
OUTPUT_FIELDS = tuple(f.name for f in dataclasses.fields(engine.StepOutput))
_INPUTS = ('actions', 'fruit_u', 'reset_spawn_u', 'reset_fruit_u',
           'pool_cells', 'base_grid', 'keep')


class _StepArgs(ctypes.Structure):
    """Mirror of ``struct StepArgs`` in csrc/step_autoreset.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in ('state', 'out') + _INPUTS]
        + [(f'o_{name}', ctypes.c_int64)
           for name in STATE_FIELDS + OUTPUT_FIELDS]
        + [(name, ctypes.c_int) for name in (
            'B', 'H', 'W', 'N', 'K', 'NF', 'P', 'CW', 'cap', 'human',
            'any_mode', 'max_steps', 'FS', 'V', 'packed', 'procedural',
            'vertical')]
        + [(name, ctypes.c_float) for name in (
            'r_fruit', 'r_kill', 'r_lose', 'r_win', 'r_time')])


class Field(NamedTuple):
    """One output of a step inside the byte arena."""
    name: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    offset: int  # bytes, a multiple of 16


def output_layout(cfg: EnvConfig, num_envs: int
                  ) -> Tuple[Tuple[Field, ...], int]:
    """Where each output of one step lies in its byte arena: the new
    state's fields, then the step output's, in declaration order (the
    order of StepArgs's offsets), each at a 16-byte-aligned offset.
    Returns (fields, arena bytes); the state's fields end where ``obs``
    starts."""
    b, h, w, n = num_envs, cfg.height, cfg.width, cfg.num_snakes
    cw = ring_num_words(cfg.body_capacity)
    i32, f32, flag = torch.int32, torch.float32, torch.bool
    bn = (b, n)
    fs = cfg.frame_stack
    frame = (n, cfg.obs_height, cfg.obs_width, cfg.frame_channels)
    spec = dict(
        grid=(i32, (b, h, w)), direction=(i32, bn), head=(i32, (b, n, 2)),
        tail=(i32, (b, n, 2)), ring=(i32, (b, n, cw)), ring_head=(i32, bn),
        ring_len=(i32, bn), alive=(flag, bn), alive_count=(i32, (b,)),
        epi_scores=(f32, bn), epi_steps=(f32, bn), epi_fruits=(f32, bn),
        epi_kills=(f32, bn), episode_length=(i32, (b,)),
        hist_grid=(i32, (b, fs - 1 if cfg.hist_mode else 0, h, w)),
        obs_stack=(torch.uint8,
                   (b, fs if fs > 1 and cfg.vision_range else 0) + frame),
        obs=(torch.uint8, (b,) + cfg.obs_shape), reward=(f32, bn),
        done=(flag, bn), rank=(i32, bn), episode_scores=(f32, bn),
        episode_steps=(f32, bn), episode_fruits=(f32, bn),
        episode_kills=(f32, bn), done_all=(flag, (b,)))
    fields, offset = [], 0
    for name in STATE_FIELDS + OUTPUT_FIELDS:
        dtype, shape = spec[name]
        fields.append(Field(name, dtype, shape, offset))
        offset += -(-math.prod(shape) * dtype.itemsize // 16) * 16
    return tuple(fields), offset


def field_view(arena: torch.Tensor, field: Field) -> torch.Tensor:
    """The typed view of ``field`` in a uint8 ``arena``."""
    size = field.dtype.itemsize
    strides = [1]
    for dim in reversed(field.shape[1:]):
        strides.insert(0, strides[0] * dim)
    return arena.view(field.dtype).as_strided(field.shape, strides,
                                              field.offset // size)


class _Carved:
    """Fields of a dataclass kept as views of one step's output arena,
    each cut on its first read and kept. ``_plan`` and ``_arena`` mark
    the object as the kernel's own: a state that carries them goes back
    into the kernel as its arena."""

    def __getattr__(self, name):
        # runs only for names not yet set on the object
        d = self.__dict__
        if '_plan' not in d or name not in d['_plan'].by_name:
            raise AttributeError(name)
        view = field_view(d['_arena'], d['_plan'].by_name[name])
        object.__setattr__(self, name, view)
        return view

    def __reduce__(self):
        # pickled and copied as the plain dataclass, with every field
        return self._plain, tuple(getattr(self, f.name)
                                  for f in dataclasses.fields(self))


class _CarvedState(_Carved, EnvState):
    _plain = EnvState


class _CarvedOutput(_Carved, engine.StepOutput):
    _plain = engine.StepOutput


def _carved(cls, plan, arena):
    obj = object.__new__(cls)
    object.__setattr__(obj, '_plan', plan)
    object.__setattr__(obj, '_arena', arena)
    return obj


def build_library() -> Tuple[str, str]:
    """Compile the kernel if its library is not built yet; returns
    (library path, compiler output, which lists registers and shared
    memory; '' where it was built before)."""
    return cuda_build.build(SOURCE)[0]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    for entry in (lib.marlsnake_step_autoreset, lib.marlsnake_step):
        entry.argtypes = [ctypes.POINTER(_StepArgs), ctypes.c_void_p]
        entry.restype = ctypes.c_int
    lib.marlsnake_error_string.argtypes = [ctypes.c_int]
    lib.marlsnake_error_string.restype = ctypes.c_char_p
    return lib


def _check_scope(cfg: EnvConfig, spawn: Optional[engine.SpawnTables]
                 ) -> None:
    if cfg.spawn_mode == 'procedural':
        if spawn is not None:
            raise ValueError('the procedural spawn takes no spawn tables')
        return
    if spawn.cells.shape[0] != cfg.spawn_pool_size:
        # the row pick maps u -> int(u * P): a pool of another size would
        # silently give other resets than the config promises
        raise ValueError(
            f'spawn pool has {spawn.cells.shape[0]} rows but '
            f'cfg.spawn_pool_size={cfg.spawn_pool_size}')


def smem_per_env(cfg: EnvConfig) -> int:
    """Bytes of shared memory the kernel gives one env: its grid and its
    rings, each rounded up to 16 bytes (``smem_per_env`` in the .cu)."""
    rings = cfg.num_snakes * ring_num_words(cfg.body_capacity)
    return (-(-cfg.height * cfg.width // 4) + -(-rings // 4)) * 16


def _check_kernel_limits(cfg: EnvConfig) -> None:
    n, nf = cfg.num_snakes, cfg.resolved_num_fruits
    smem = smem_per_env(cfg)
    if n > MAX_SNAKES or nf > MAX_DRAWS or smem > MAX_SMEM_PER_ENV:
        raise NotImplementedError(
            f'the CUDA step kernel takes num_snakes <= {MAX_SNAKES}, '
            f'num_fruits <= {MAX_DRAWS} and boards whose grid and rings '
            f'fit {MAX_SMEM_PER_ENV} bytes of shared memory (this config: '
            f'{n} snakes, {nf} fruits, {smem} bytes); see ROADMAP.md')


def _check(t: torch.Tensor, name: str, dtype, shape, index: int) -> int:
    """The tensor's address, once it is ``dtype``, ``shape``, contiguous
    and on CUDA device ``index``."""
    if (t.dtype is not dtype or t.shape != shape or not t.is_contiguous()
            or t.get_device() != index):
        raise ValueError(
            f'{name}: expected a contiguous {dtype} tensor of shape '
            f'{tuple(shape)} on cuda:{index}, got {t.dtype} '
            f'{tuple(t.shape)} on {t.device}'
            f'{"" if t.is_contiguous() else ", not contiguous"}')
    return t.data_ptr()


class _LaunchPlan:
    """What launches at one (cfg, num_envs, device) share: the scope and
    limit checks (made once, here), the output layout, the inputs' shapes
    and one argument struct whose per-step fields each call sets (so one
    plan serves one thread at a time)."""

    def __init__(self, cfg: EnvConfig, num_envs: int, device: torch.device):
        _check_kernel_limits(cfg)
        self.lib = load_library()
        self.cfg, self.device, self.index = cfg, device, device.index
        self.fields, self.nbytes = output_layout(cfg, num_envs)
        self.by_name = {f.name: f for f in self.fields}
        self.state_nbytes = self.by_name['obs'].offset
        b, n, nf = num_envs, cfg.num_snakes, cfg.resolved_num_fruits
        f32 = torch.float32
        self.draw_specs = (('fruit_u', f32, (b, n)),
                           ('reset_spawn_u', f32, spawn_draw_shape(cfg, b)),
                           ('reset_fruit_u', f32, (b, nf)))
        self.actions_shape = (b, n)
        self.spawn = None
        r_fruit, r_kill, r_lose, r_win, r_time = cfg.rewards
        self.args = _StepArgs(
            B=b, H=cfg.height, W=cfg.width, N=n, K=cfg.snake_length, NF=nf,
            P=cfg.spawn_pool_size, CW=ring_num_words(cfg.body_capacity),
            cap=cfg.body_capacity, human=int(cfg.observer == 'human'),
            any_mode=int(cfg.done_mode == 'any'),
            max_steps=cfg.max_episode_steps, FS=cfg.frame_stack,
            V=cfg.vision_range or 0, packed=int(cfg.obs_format == 'packed'),
            procedural=int(cfg.spawn_mode == 'procedural'),
            vertical=int(cfg.spawn_mode == 'procedural'
                         and cfg.spawn_vertical), r_fruit=r_fruit,
            r_kill=r_kill, r_lose=r_lose, r_win=r_win, r_time=r_time)
        for f in self.fields:
            setattr(self.args, f'o_{f.name}', f.offset)

    def pack(self, state: EnvState,
             out: Optional[engine.StepOutput] = None) -> torch.Tensor:
        """A state the kernel did not make, copied into a state arena;
        with ``out``, the step output that came with it, into a whole
        arena."""
        given = state.fields() + (out.fields() if out is not None else [])
        arena = torch.empty(
            self.state_nbytes if out is None else self.nbytes,
            dtype=torch.uint8, device=self.device)
        for (name, t), f in zip(given, self.fields):
            if t.dtype != f.dtype or t.shape != f.shape:
                raise ValueError(f'{name}: expected {f.dtype} '
                                 f'{f.shape}, got {t.dtype} '
                                 f'{tuple(t.shape)}')
            field_view(arena, f).copy_(t)
        return arena

    def _set_spawn(self, spawn: engine.SpawnTables) -> None:
        # the pool must have cfg.spawn_pool_size rows, and the procedural
        # spawn takes none (see _check_scope)
        cfg, i32 = self.cfg, torch.int32
        _check_scope(cfg, spawn)
        self.args.pool_cells = _check(
            spawn.cells, 'spawn.cells', i32,
            (cfg.spawn_pool_size, cfg.num_snakes * cfg.snake_length),
            self.index)
        self.args.base_grid = _check(spawn.base_grid, 'spawn.base_grid',
                                     i32, (cfg.height, cfg.width),
                                     self.index)
        self.spawn = spawn

    def launch(self, state_arena: torch.Tensor,
               spawn: Optional[engine.SpawnTables],
               actions: torch.Tensor, draws: StepDraws
               ) -> Tuple[EnvState, engine.StepOutput]:
        """One launch of the auto-reset entry."""
        if spawn is not self.spawn:
            self._set_spawn(spawn)
        for (name, dtype, shape), t in zip(self.draw_specs, draws):
            setattr(self.args, name, _check(t, name, dtype, shape,
                                            self.index))
        return self._launch(step_autoreset, self.lib.marlsnake_step_autoreset,
                            state_arena, actions)

    def launch_step(self, state_arena: torch.Tensor, actions: torch.Tensor,
                    fruit_u: torch.Tensor,
                    keep: Optional[torch.Tensor] = None
                    ) -> Tuple[EnvState, engine.StepOutput]:
        """One launch of the entry without auto-reset, which reads none
        of the reset inputs of the argument struct. With ``keep`` (B,)
        bool, ``state_arena`` must be a whole arena (state and output)."""
        name, dtype, shape = self.draw_specs[0]
        self.args.fruit_u = _check(fruit_u, name, dtype, shape, self.index)
        if keep is None:
            self.args.keep = None
        else:
            if state_arena.numel() != self.nbytes:
                raise ValueError('keep needs the whole arena of the step '
                                 'before, state and output')
            self.args.keep = _check(keep, 'keep', torch.bool,
                                    self.actions_shape[:1], self.index)
        return self._launch(step, self.lib.marlsnake_step, state_arena,
                            actions)

    def _launch(self, wrapper, entry, state_arena: torch.Tensor,
                actions: torch.Tensor
                ) -> Tuple[EnvState, engine.StepOutput]:
        args, index = self.args, self.index
        if actions.dtype != torch.int32:
            actions = actions.to(torch.int32)
        args.actions = _check(actions, 'actions', torch.int32,
                              self.actions_shape, index)
        out = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
        args.state = state_arena.data_ptr()
        args.out = out.data_ptr()
        if torch.cuda.current_device() != index:
            with torch.cuda.device(index):
                rc = self._enqueue(entry)
        else:
            rc = self._enqueue(entry)
        if rc != 0:
            raise RuntimeError(
                f'{wrapper.__name__} kernel launch failed: '
                f'{self.lib.marlsnake_error_string(rc).decode()}')
        wrapper.launches += 1
        return (_carved(_CarvedState, self, out),
                _carved(_CarvedOutput, self, out))

    def _enqueue(self, entry) -> int:
        # the raw handle of PyTorch's current stream, as its own Triton
        # launcher takes it: torch.cuda.current_stream() would build a
        # Stream object on every call
        stream = torch._C._cuda_getCurrentRawStream(self.index)
        return entry(ctypes.byref(self.args), stream)


@functools.lru_cache(maxsize=16)
def _plan(cfg: EnvConfig, num_envs: int, device: torch.device
          ) -> _LaunchPlan:
    return _LaunchPlan(cfg, num_envs, device)


def step_autoreset(cfg: EnvConfig, spawn: Optional[engine.SpawnTables],
                   state: EnvState, actions: torch.Tensor,
                   draws: StepDraws) -> Tuple[EnvState, engine.StepOutput]:
    """``engine.step_autoreset`` for a batch of envs: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors. ``spawn`` is None
    for the procedural spawn."""
    plan = getattr(state, '_plan', None)
    if plan is not None and (plan.cfg is cfg or plan.cfg == cfg):
        return plan.launch(state._arena, spawn, actions, draws)
    _check_scope(cfg, spawn)
    if state.device.type == 'cpu':
        return engine.step_autoreset(cfg, spawn, state, actions, draws)
    if state.device.type != 'cuda':
        raise ValueError(f'unsupported device {state.device}')
    plan = _plan(cfg, state.num_envs, state.device)
    return plan.launch(plan.pack(state), spawn, actions, draws)


def step(cfg: EnvConfig, state: EnvState, actions: torch.Tensor,
         fruit_u: torch.Tensor,
         hold: Optional[Tuple[torch.Tensor, engine.StepOutput]] = None
         ) -> Tuple[EnvState, engine.StepOutput]:
    """``engine.step`` (no auto-reset) for a batch of envs: the plain
    version for CPU tensors, the CUDA kernel's second entry for CUDA
    tensors. An env whose episode is over is stepped like any other, as
    ``engine.step`` steps it.

    ``hold=(keep, out)``, with ``keep`` (B,) bool and ``out`` the step
    output that came with ``state``, holds envs still: where ``keep`` is
    set the env is not stepped, and every field of the returned state and
    output has the value it has in ``state`` and ``out``. This is how a
    caller freezes finished envs while the others go on; its plain
    version is ``engine.step`` followed by ``select_envs``. On CUDA the
    kernel copies the held envs' rows itself, with no further launch.
    """
    keep, out = hold if hold is not None else (None, None)
    plan = getattr(state, '_plan', None)
    if plan is not None and (plan.cfg is cfg or plan.cfg == cfg) and (
            out is None or getattr(out, '_arena', None) is state._arena):
        return plan.launch_step(state._arena, actions, fruit_u, keep)
    if state.device.type == 'cpu':
        new = engine.step(cfg, state, actions, fruit_u)
        return new if hold is None else select_envs(keep, (state, out), new)
    if state.device.type != 'cuda':
        raise ValueError(f'unsupported device {state.device}')
    plan = _plan(cfg, state.num_envs, state.device)
    return plan.launch_step(plan.pack(state, out), actions, fruit_u, keep)


def select_envs(keep: torch.Tensor, old, new):
    """Per env, every field of the (state, output) pair ``old`` where
    ``keep`` (B,) bool, of ``new`` elsewhere, as a new pair of plain
    dataclasses: the plain version of ``step``'s ``hold``."""
    def where(a, b):
        return torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    return tuple(
        cls(*[where(a, b) for (_, a), (_, b) in zip(o.fields(), n.fields())])
        for cls, o, n in zip((EnvState, engine.StepOutput), old, new))


step_autoreset.launches = 0
step.launches = 0


class StaticEnvs:
    """A (state, step output) pair of ``num_envs`` envs at fixed
    addresses, for a captured loop to carry from one replay to the next
    (``utils/cuda_graph.py``). On CUDA it is one whole output arena of
    the kernel's layout: ``state`` and ``out`` are the kernel's own views
    of it, so both entries take the pair as they take a pair they
    returned, ``hold`` included. On the CPU it is one tensor a field."""

    def __init__(self, cfg: EnvConfig, num_envs: int, device):
        device = torch.device(device)
        self.arena = None
        if device.type == 'cuda':
            _, nbytes = output_layout(cfg, num_envs)
            self.arena = torch.zeros(nbytes, dtype=torch.uint8,
                                     device=device)
            # the plan of the arena's own device, index and all
            self.plan = _plan(cfg, num_envs, self.arena.device)
            self.state = _carved(_CarvedState, self.plan, self.arena)
            self.out = _carved(_CarvedOutput, self.plan, self.arena)
            return
        fields, _ = output_layout(cfg, num_envs)
        tensors = [torch.zeros(f.shape, dtype=f.dtype, device=device)
                   for f in fields]
        cut = len(STATE_FIELDS)
        self.state = EnvState(*tensors[:cut])
        self.out = engine.StepOutput(*tensors[cut:])

    def _whole(self, state, out) -> bool:
        arena = getattr(state, '_arena', None)
        return (self.arena is not None and arena is not None
                and arena.numel() == self.arena.numel()
                and state._plan.fields == self.plan.fields
                and (out is None or getattr(out, '_arena', None) is arena))

    def load(self, state: EnvState) -> None:
        """Copy ``state`` in and zero the output part (a reset's pair)."""
        if self._whole(state, None):
            cut = self.plan.state_nbytes
            self.arena[:cut].copy_(state._arena[:cut])
        else:
            for (_, dst), (_, src) in zip(self.state.fields(),
                                          state.fields(), strict=True):
                dst.copy_(src)
        for _, dst in self.out.fields():
            dst.zero_()

    def store(self, state: EnvState,
              out: Optional[engine.StepOutput] = None) -> None:
        """Copy a step's result in, inside a captured body: the pair the
        kernel returned is one arena copy; without ``out`` the output part
        is left as it is."""
        if self._whole(state, out):
            cut = self.arena.numel() if out is not None \
                else self.plan.state_nbytes
            self.arena[:cut].copy_(state._arena[:cut])
            return
        for (_, dst), (_, src) in zip(self.state.fields(), state.fields(),
                                      strict=True):
            dst.copy_(src)
        if out is not None:
            for (_, dst), (_, src) in zip(self.out.fields(), out.fields(),
                                          strict=True):
                dst.copy_(src)

    def clone(self) -> Tuple[EnvState, engine.StepOutput]:
        """The pair as new tensors: on CUDA a copy of the arena, which
        the kernel takes back as its own."""
        if self.arena is not None:
            arena = self.arena.clone()
            return (_carved(_CarvedState, self.plan, arena),
                    _carved(_CarvedOutput, self.plan, arena))
        return (EnvState(*[t.clone() for _, t in self.state.fields()]),
                engine.StepOutput(*[t.clone() for _, t in self.out.fields()]))
