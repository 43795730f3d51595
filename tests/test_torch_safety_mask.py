"""The safety mask and the flood fill (``ops/safety_mask.py``,
``ops/floodfill.py``, ``ops/mask_kernel.py``) on the CPU.

Their CUDA kernel (``csrc/safety_mask.cu``) runs only on the card, where
chip_smoke.py holds it against the plain versions. Here:

- the plain versions against the JAX package at shapes the evaluator's
  tests lack: rows wider than 32 cells (40x40, 8 snakes), a board that is
  not square (11x9, 3 snakes), and flood-fill limits 0, 1, 7 and 60, with
  dead, inactive and boxed-in snakes and unknown directions. Every value
  is an integer or a boolean, so they must be EQUAL;
- the wrappers: CPU tensors take the plain path and launch nothing, the
  argument checks raise on what the kernel does not take, the ctypes
  mirror of the argument struct matches the C source, the launch path
  hands a stand-in library the right layout, and importing the modules
  needs neither nvcc nor a GPU.
"""

import ctypes
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo import evaluator as JEV
from marlsnake_tpu.ops.floodfill import reachable_count as jax_reachable
from marlsnake_torch.algo import battle_batch as BB
from marlsnake_torch.algo import evaluator as EV
from marlsnake_torch.core import types as T
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.ops import floodfill, mask_kernel
from marlsnake_torch.ops import safety_mask as SM
from test_torch_engine import _t
from test_torch_evaluator import bfs_count

LIMIT = 60
_JAX_MASKED = jax.jit(jax.vmap(
    lambda o, q, d, a: JEV.masked_actions(o, q, d, a, LIMIT)))
_JAX_SINGLE = jax.jit(jax.vmap(jax.vmap(
    lambda o, q, d, c: JEV.masked_action_single(o, q, d, c, LIMIT))))
UNITS = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)], np.int32)


# --- the plain flood fill against JAX and the BFS --------------------------

@pytest.mark.parametrize('limit', [0, 1, 7, 60])
@pytest.mark.parametrize('h,w', [(40, 40), (11, 9)], ids=['40x40', '11x9'])
def test_reachable_count_plain_matches_jax_and_bfs(h, w, limit):
    """Eight boards, a third of the cells blocked (one all blocked, one
    all open), some starts on blocked cells: every count equal to the
    BFS's and to JAX's."""
    rng = np.random.default_rng(h * 100 + limit)
    passable = rng.random((8, h, w)) > 0.35
    start = np.stack([rng.integers(0, h, 8), rng.integers(0, w, 8)], -1)
    passable[0, start[0, 0], start[0, 1]] = False
    passable[1] = False                 # the start alone
    passable[2] = True                  # the whole board
    got = floodfill.reachable_count(_t(passable), _t(start), limit)
    assert got.dtype == torch.int32 and got.shape == (8,)
    want = [bfs_count(passable[i], start[i], limit) for i in range(8)]
    np.testing.assert_array_equal(got.numpy(), want)
    jfn = jax.jit(jax.vmap(lambda p, s: jax_reachable(p, s, limit)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfn(jnp.asarray(passable),
                                    jnp.asarray(start))))
    if limit > 1:
        assert min(want) < limit <= max(want)


@pytest.mark.parametrize('limit', [0, 7, 60])
@pytest.mark.parametrize('where', ['row-1', 'row-h', 'col-1', 'col-w',
                                   'row-h+5'])
def test_reachable_count_plain_off_the_board_matches_jax(where, limit):
    """A start off the board seeds no cell: JAX counts ``min(0, limit)``
    and so does the plain fill, on open and blocked boards alike."""
    h, w = 11, 9
    rng = np.random.default_rng(limit)
    passable = rng.random((4, h, w)) > 0.35
    passable[1] = True                  # the whole board open
    along = rng.integers(0, min(h, w), 4)
    off = {'row-1': (-1, None), 'row-h': (h, None), 'col-1': (None, -1),
           'col-w': (None, w), 'row-h+5': (h + 5, None)}[where]
    start = np.stack([along if off[0] is None else np.full(4, off[0]),
                      along if off[1] is None else np.full(4, off[1])],
                     -1).astype(np.int32)
    got = floodfill.reachable_count(_t(passable), _t(start), limit)
    jfn = jax.jit(jax.vmap(lambda p, s: jax_reachable(p, s, limit)))
    want = np.asarray(jfn(jnp.asarray(passable), jnp.asarray(start)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.zeros(4, np.int32))


# --- the plain mask against JAX ---------------------------------------------

SHAPES = {'40x40x8': (40, 40, 8), '11x9x3': (11, 9, 3)}


def mask_inputs(shape, steps, e=4):
    """Obs (E, N, H, W, 8) of the port's engine after ``steps`` random
    steps without reset (some snakes dead), random Q-values, directions
    unknown for about half the snakes, some live snakes inactive, and the
    first snake with a head boxed in by walls on its four neighbours
    (returned as its (env, snake))."""
    h, w, n = SHAPES[shape]
    env = VectorSnakeEnv(EnvConfig(height=h, width=w, num_snakes=n,
                                   snake_length=3), e, autoreset=False,
                         device='cpu', seed=steps)
    states, obs = env.reset()
    gen = torch.Generator().manual_seed(steps)
    done = torch.zeros((e, n), dtype=torch.bool)
    for _ in range(steps):
        states, out = env.step(states, torch.randint(
            0, 3, (e, n), generator=gen, dtype=torch.int32))
        obs, done = out.obs, done | out.done
    obs = obs.numpy().copy()
    rng = np.random.default_rng(steps + n)
    q = rng.normal(size=(e, n, 3)).astype(np.float32)
    dirs = UNITS[rng.integers(0, 4, (e, n))]
    dirs[rng.random((e, n)) < 0.5] = 0
    active = ~done.numpy()
    active[1:][rng.random((e - 1, n)) < 0.2] = False
    # box in the first snake that has a head
    i, j, y, x = np.argwhere(obs[..., T.CH_MY_HEAD] == 1)[0]
    for dy, dx in UNITS:
        if 0 <= y + dy < h and 0 <= x + dx < w:
            obs[i, j, y + dy, x + dx, T.CH_WALL] = 1
    active[i, j] = True
    return obs, q, dirs, active, (i, j)


CASES = [('40x40x8', 0), ('40x40x8', 10), ('11x9x3', 0), ('11x9x3', 4)]
IDS = [f'{s}-{k}steps' for s, k in CASES]


@pytest.mark.parametrize('shape,steps', CASES, ids=IDS)
def test_masked_actions_plain_matches_jax(shape, steps):
    obs, q, dirs, active, boxed = mask_inputs(shape, steps)
    want = _JAX_MASKED(jnp.asarray(obs), jnp.asarray(q), jnp.asarray(dirs),
                       jnp.asarray(active))
    got = EV.masked_actions(_t(obs), _t(q), _t(dirs), _t(active))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(want[0][boxed]) == 0     # boxed in: all three vetoed
    if steps:
        assert not active.all()


@pytest.mark.parametrize('shape,steps', CASES, ids=IDS)
def test_masked_seat0_plain_matches_jax(shape, steps):
    """Seat 0 alone active: the battle's masking equals JAX's
    ``masked_actions`` of the whole env, seat 0's column."""
    obs, q, dirs, active, _ = mask_inputs(shape, steps)
    alone = np.zeros_like(active)
    alone[:, 0] = active[:, 0]
    want = _JAX_MASKED(jnp.asarray(obs), jnp.asarray(q), jnp.asarray(dirs),
                       jnp.asarray(alone))
    act, new_dir = BB.masked_seat0(_t(obs[:, 0]), _t(q[:, 0]),
                                   _t(dirs[:, 0]), _t(active[:, 0]))
    np.testing.assert_array_equal(act.numpy(), np.asarray(want[0])[:, 0])
    np.testing.assert_array_equal(new_dir.numpy(),
                                  np.asarray(want[1])[:, 0])


@pytest.mark.parametrize('shape', list(SHAPES))
def test_masked_action_single_plain_matches_jax(shape):
    """Each snake alone under a random claim set."""
    obs, q, dirs, _, _ = mask_inputs(shape, 3)
    rng = np.random.default_rng(5)
    claimed = rng.random(obs.shape[:4]) < 0.1
    want = _JAX_SINGLE(jnp.asarray(obs), jnp.asarray(q), jnp.asarray(dirs),
                       jnp.asarray(claimed))
    got = EV.masked_action_single(_t(obs), _t(q), _t(dirs), _t(claimed))
    for g, w, name in zip(got, want, ('act', 'new_dir', 'next_pos',
                                      'head_exists')):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


# --- the wrappers -----------------------------------------------------------

def test_cpu_tensors_take_the_plain_path_and_launch_nothing(monkeypatch):
    """Every wrapper runs its plain version on CPU tensors: no library is
    loaded and no launch is counted."""
    def no_library():
        raise AssertionError('the library was asked for')

    monkeypatch.setattr(mask_kernel, 'load_library', no_library)
    monkeypatch.setattr(floodfill.reachable_count, 'launches', 0)
    monkeypatch.setattr(SM.safety_mask, 'launches', 0)
    obs, q, dirs, active, _ = mask_inputs('11x9x3', 2)
    o, qq, d, a = _t(obs), _t(q), _t(dirs), _t(active)
    passable = torch.ones((2, 11, 9), dtype=torch.bool)
    assert floodfill.reachable_count(
        passable, torch.tensor([[1, 1], [5, 4]]), 60).tolist() == [60, 60]
    out = SM.safety_mask(o, qq, d, a)
    want = SM.masked_actions_plain(o, qq, d, a)
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    EV.masked_actions(o, qq, d, a)
    EV.masked_action_single(o, qq, d, torch.zeros(o.shape[:4], dtype=bool))
    BB.masked_seat0(o[:, 0], qq[:, 0], d[:, 0], a[:, 0])
    assert floodfill.reachable_count.launches == 0
    assert SM.safety_mask.launches == 0


def _mask_args(e=2, n=3, h=11, w=9, c=8):
    return dict(obs=torch.zeros((e, n, h, w, c), dtype=torch.uint8),
                q=torch.zeros((e, n, 3)),
                cur_dirs=torch.zeros((e, n, 2), dtype=torch.int32),
                active=torch.ones((e, n), dtype=torch.bool), claims=None)


def _with(**changes):
    args = _mask_args(**{k: changes.pop(k) for k in ('e', 'n', 'h', 'w', 'c')
                         if k in changes})
    args.update(changes)
    return args


@pytest.mark.parametrize('args,error', [
    (_with(n=33), NotImplementedError),
    (_with(n=0), ValueError),
    (_with(h=225, w=20), NotImplementedError),
    (_with(h=20, w=257), NotImplementedError),
    (_with(n=32, h=224, w=256), NotImplementedError),   # shared memory
    (_with(obs=torch.zeros((2, 3, 11, 9, 8))), ValueError),
    (_with(c=7), ValueError),
    (_with(q=torch.zeros((2, 3, 4))), ValueError),
    (_with(q=torch.zeros((2, 3, 3), dtype=torch.int32)), ValueError),
    (_with(cur_dirs=torch.zeros((2, 3, 2))), ValueError),
    (_with(active=torch.ones((2, 3), dtype=torch.uint8)), ValueError),
    (_with(claims=torch.zeros((2, 9, 11), dtype=torch.bool)), ValueError),
    (_with(q=torch.zeros((2, 3, 3), device='meta')), ValueError)],
    ids=['33-snakes', 'no-snake', '225-rows', '257-columns', 'shared-memory',
         'float-obs', '7-channels', 'q-not-3', 'int-q', 'float-dirs',
         'uint8-active', 'claims-shape', 'q-elsewhere'])
def test_mask_checks_raise(args, error):
    with pytest.raises(error):
        mask_kernel.check_mask_args(**args)


@pytest.mark.parametrize('passable,start,error', [
    (torch.ones((4, 10, 10), dtype=torch.uint8), torch.zeros((4, 2)),
     ValueError),
    (torch.ones((4, 10, 10), dtype=torch.bool), torch.zeros((4, 2)),
     ValueError),
    (torch.ones((4, 10, 10), dtype=torch.bool),
     torch.zeros((3, 2), dtype=torch.int64), ValueError),
    (torch.ones((4, 10, 257), dtype=torch.bool),
     torch.zeros((4, 2), dtype=torch.int64), NotImplementedError),
    (torch.ones((4, 225, 10), dtype=torch.bool),
     torch.zeros((4, 2), dtype=torch.int64), NotImplementedError),
    (torch.ones((4, 10, 10), dtype=torch.bool),
     torch.zeros((4, 2), dtype=torch.int64, device='meta'), ValueError)],
    ids=['uint8-board', 'float-start', 'start-shape', '257-columns',
         '225-rows', 'start-elsewhere'])
def test_reachable_checks_raise(passable, start, error):
    with pytest.raises(error):
        mask_kernel.check_reachable_args(passable, start)


def test_checks_normalise_what_they_take():
    """Largest accepted shapes pass; q is cast to float32 (which keeps its
    order), directions to int32; a view of seat 0 goes in uncopied."""
    mask_kernel.check_mask_args(**_with(n=32, h=216, w=216))
    mask_kernel.check_mask_args(**_with(n=4, h=224, w=256))
    obs = torch.zeros((3, 4, 20, 20, 8), dtype=torch.uint8)
    seat0 = obs[:, :1]
    inp = mask_kernel.check_mask_args(
        seat0, torch.zeros((3, 1, 3), dtype=torch.float16),
        torch.zeros((3, 1, 2), dtype=torch.int64),
        torch.ones((3, 1), dtype=torch.bool))
    assert inp.obs.data_ptr() == obs.data_ptr()
    assert inp.obs.stride()[:2] == obs.stride()[:2]
    assert inp.q.dtype == torch.float32 and inp.dirs.dtype == torch.int32
    boards, starts = mask_kernel.check_reachable_args(
        torch.ones((2, 3, 5, 7), dtype=torch.bool),
        torch.zeros((2, 3, 2), dtype=torch.int64))
    assert boards.shape == (6, 5, 7) and starts.dtype == torch.int32
    assert [mask_kernel.words_per_row(w) for w in (1, 32, 33, 65, 129, 256)] \
        == [1, 1, 2, 4, 8, 8]


def _source():
    with open(mask_kernel.SOURCE) as fp:
        return fp.read()


def _struct_body(name):
    body = re.search(r'struct %s \{(.*?)\n\};' % name, _source(),
                     re.S).group(1)
    return re.sub(r'//[^\n]*', '', body)


def test_struct_mirror_matches_the_cuda_source():
    c_types = {'int64_t': ctypes.c_int64, 'int': ctypes.c_int}
    want = []
    for decl in filter(None, (d.strip() for d in
                              _struct_body('MaskArgs').split(';'))):
        m = re.fullmatch(r'(const\s+)?(\w+)\s*(\*?)\s*(\w+)', decl)
        assert m, decl
        want.append((m.group(4), ctypes.c_void_p if m.group(3)
                     else c_types[m.group(2)]))
    assert list(mask_kernel._MaskArgs._fields_) == want


def test_snake_record_size_matches_the_cuda_source():
    """``smem_per_env`` counts SNAKE_INFO_BYTES a snake: the size of
    ``struct SnakeInfo``, all of whose members are int."""
    ints = 0
    for decl in filter(None, (d.strip() for d in
                              _struct_body('SnakeInfo').split(';'))):
        assert decl.startswith('int '), decl
        for name in decl[4:].split(','):
            size = re.search(r'\[(\d+)\]', name)
            ints += int(size.group(1)) if size else 1
    assert ints * 4 == mask_kernel.SNAKE_INFO_BYTES


def test_import_needs_no_nvcc_or_gpu():
    """The modules import, and their checks run, with no nvcc on the path
    and no CUDA toolkit: the library is built only at the first launch."""
    code = ('import torch\n'
            'from marlsnake_torch.ops import mask_kernel, safety_mask\n'
            'from marlsnake_torch.algo import evaluator, battle_batch\n'
            'mask_kernel.check_mask_args(torch.zeros((1, 1, 4, 4, 8), '
            'dtype=torch.uint8), torch.zeros((1, 1, 3)), torch.zeros((1, 1, '
            '2), dtype=torch.int32), torch.ones((1, 1), dtype=torch.bool))\n'
            'assert mask_kernel.load_library.cache_info().currsize == 0\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_HOME='/nonexistent',
               PATH=os.path.dirname(sys.executable), CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run([sys.executable, '-c', code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# --- the launch path, with a stand-in library -------------------------------

def _at(address, dtype, shape):
    """A tensor over ``shape`` contiguous elements at ``address``."""
    size = int(np.prod(shape)) * dtype.itemsize
    buf = (ctypes.c_uint8 * size).from_address(address)
    return torch.from_numpy(np.ctypeslib.as_array(buf)).view(dtype).view(
        shape)


class _PlainMaskLibrary:
    """Stands in for the CUDA library: reads the arguments the launchers
    pass, runs the plain versions on the memory they point at and writes
    the outputs where they point."""

    def __init__(self):
        self.calls = []

    def marlsnake_mask_error_string(self, rc):
        return b'stand-in'

    def marlsnake_reachable_count(self, passable, start, m, h, w, limit,
                                  out, stream):
        boards = _at(passable, torch.bool, (m, h, w))
        # limit rounds of the plain fill; past h * w + 1 the count is the
        # region's whatever the limit
        _at(out, torch.int32, (m,)).copy_(floodfill.reachable_count_plain(
            boards, _at(start, torch.int32, (m, 2)), min(limit, h * w + 1)))
        self.calls.append(('reachable_count', limit))
        return 0

    def marlsnake_masked_actions(self, args_ref, stream):
        a = args_ref._obj
        e, n, h, w, c = a.E, a.N, a.H, a.W, a.C
        span = (e - 1) * a.s_env + (n - 1) * a.s_snake + h * w * c
        obs = torch.as_strided(_at(a.obs, torch.uint8, (span,)),
                               (e, n, h, w, c),
                               (a.s_env, a.s_snake, w * c, c, 1))
        claims = (None if not a.claims
                  else _at(a.claims, torch.bool, (e, h, w)))
        out = SM.masked_actions_plain(
            obs, _at(a.q, torch.float32, (e, n, 3)),
            _at(a.dirs, torch.int32, (e, n, 2)),
            _at(a.active, torch.bool, (e, n)), claims, a.limit)
        _at(a.act, torch.int32, (e, n)).copy_(out.act)
        _at(a.new_dir, torch.int32, (e, n, 2)).copy_(out.new_dir)
        _at(a.next_pos, torch.int32, (e, n, 2)).copy_(out.next_pos)
        _at(a.head_exists, torch.bool, (e, n)).copy_(out.head_exists)
        self.calls.append(('masked_actions', a.vec8, a.s_env, a.s_snake))
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = _PlainMaskLibrary()
    monkeypatch.setattr(mask_kernel, 'load_library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: None)
    monkeypatch.setattr(torch._C, '_cuda_getCurrentRawStream', lambda i: 0,
                        raising=False)
    return lib


@pytest.mark.parametrize('layout', ['whole', 'seat0-claims', 'odd-cells'])
def test_mask_launch_path_hands_over_its_layout(stand_in, layout):
    """The launcher's struct carries the obs's env and snake strides (a
    view of seat 0 goes in as it is), the 8-byte fast path only for
    aligned 8-byte cells, the claims and all four outputs."""
    obs, q, dirs, active, _ = mask_inputs('11x9x3', 3)
    obs, q, dirs, active = _t(obs), _t(q), _t(dirs), _t(active)
    claims = None
    if layout == 'seat0-claims':
        obs, q, dirs, active = obs[:, :1], q[:, :1], dirs[:, :1], \
            active[:, :1]
        claims = torch.rand(obs.shape[:1] + obs.shape[2:4]) < 0.2
    elif layout == 'odd-cells':
        obs = torch.cat([obs, torch.zeros(obs.shape[:-1] + (1,),
                                          dtype=torch.uint8)], -1)
    inp = mask_kernel.check_mask_args(obs, q.half(), dirs.long(), active,
                                      claims)
    got = mask_kernel.launch_masked_actions(inp, 7)
    want = SM.masked_actions_plain(obs, q.half().float(), dirs, active,
                                   claims, 7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (_, vec8, s_env, s_snake), = stand_in.calls
    assert vec8 == (layout != 'odd-cells')
    assert s_env == obs.stride(0) and s_snake == (
        0 if layout == 'seat0-claims' else obs.stride(1))


@pytest.mark.parametrize('n,h,w,scratch', [
    (3, 11, 9, False), (8, 216, 216, False), (32, 57, 256, True)],
    ids=['11x9x3', '216x216x8', '57x256x32'])
def test_mask_launch_path_puts_the_planes_where_they_fit(stand_in,
                                                         monkeypatch, n, h,
                                                         w, scratch):
    """The kernel's deadly planes and records always take shared memory
    (``smem_per_env``, the check); the other planes go there too where
    they fit beside them, else the launcher hands the kernel scratch in
    device memory. 32 snakes of 57x256 pass the check but overflow with
    the other planes."""
    seen = []

    def record(args_ref, stream):
        seen.append(args_ref._obj.scratch)
        return 0

    monkeypatch.setattr(stand_in, 'marlsnake_masked_actions', record)
    args = _mask_args(e=1, n=n, h=h, w=w)
    inp = mask_kernel.check_mask_args(**args)
    mask_kernel.launch_masked_actions(inp, 60)
    total = (mask_kernel.smem_per_env(n, h, w)
             + mask_kernel.extra_planes_bytes(n, h, w))
    assert (total > mask_kernel.MAX_SMEM_PER_ENV) == scratch
    assert bool(seen[0]) == scratch


def test_fill_launch_path_hands_over_its_boards(stand_in):
    rng = np.random.default_rng(3)
    passable = torch.from_numpy(rng.random((2, 5, 11, 9)) < 0.6)
    start = torch.from_numpy(np.stack(
        [rng.integers(0, 11, (2, 5)), rng.integers(0, 9, (2, 5))], -1))
    boards, starts = mask_kernel.check_reachable_args(passable, start)
    got = mask_kernel.launch_reachable_count(boards, starts, 10 ** 12)
    assert stand_in.calls == [('reachable_count', 2 ** 31 - 1)]
    np.testing.assert_array_equal(
        got.view(2, 5).numpy(),
        floodfill.reachable_count_plain(passable, start, 100).numpy())
