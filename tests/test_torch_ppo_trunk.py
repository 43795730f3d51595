"""The PPO ActorCritic's conv trunk (``ops/ppo_trunk.py``,
``csrc/ppo_trunk.cu``).

On the CPU:

- ``ActorCritic.features`` and its weights' gradients equal the trunk as
  the net computed it before the kernel (``_features_before``, a copy of
  that code), bit for bit, on uint8 and float32 obs, with and without
  ``assume_binary_obs``, at 20x20, 10x10, 11x9 and frame-stack 4;
- the wrapper picks the kernel for float32 on CUDA tensors only: the
  bfloat16 option keeps its plain path;
- the argument checks raise on what the kernel does not take;
- the shared-memory layouts keep the kernel's loads aligned and inside
  one block's memory, the plans stay within the batch, and the ctypes
  mirror of the argument struct matches the C source;
- the launch path, with a stand-in library that does in PyTorch what the
  kernels do (the pools' codes and the pooled conv1 map saved, the
  gradients routed back through them), gives the plain trunk's features
  and gradients.

On the card (marker ``cuda``; skipped without one; run with
``python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_ppo_trunk.py``): the kernels against the plain versions at
B = 1, 33, 1,024 and 32,768 of each shape above and 40x40, at 1, 16 and 64
input planes, at boards whose planes lie in device memory, and at a batch
that leaves the last tile ragged; the backward deterministic and equal
under graph replay.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from marlsnake_torch.models import ppo as ppo_model
from marlsnake_torch.models.ppo import ActorCritic
from marlsnake_torch.ops import cuda_build
from marlsnake_torch.ops import ppo_trunk as PT
from marlsnake_torch.ops.obs_pack import prepare_obs

SHAPES = {'20x20': (20, 20, 8), '10x10': (10, 10, 8), '11x9': (11, 9, 8),
          'stack4': (20, 20, 32)}
# rows whose planes do not fit one block's shared memory (kept in device
# memory), and two groups of 32 input channels in the backward
SCRATCH_SHAPES = {'30x30-stack4': (30, 30, 32), '48x48': (48, 48, 8),
                  'stack5': (20, 20, 40)}
# the weight gradients' channel groups: one partly filled, two, eight
LANE_SHAPES = {'20x20x1': (20, 20, 1), '11x11x16': (11, 11, 16),
               '20x20x64': (20, 20, 64)}
CARD_SHAPES = {**SHAPES, '40x40': (40, 40, 8), **SCRATCH_SHAPES,
               **LANE_SHAPES}
# the shapes the port trains at every batch up to a minibatch, the
# scratch and lane shapes up to a rollout step's; 4,099 rows leave the last
# tile of 4 rows ragged
CARD_CASES = ([(shape, b) for shape in list(SHAPES) + ['40x40']
               for b in (1, 33, 1024, 32768)]
              + [(shape, b) for shape in list(SCRATCH_SHAPES)
                 + list(LANE_SHAPES) for b in (1, 33, 1024)]
              + [('20x20', 4099)])


def _features_before(net, x):
    """``ActorCritic.features`` as it was before the kernel."""
    dt = net.compute_dtype
    x = prepare_obs(x, dt, net.assume_binary_obs).permute(0, 3, 1, 2)
    for conv in (net.conv1, net.conv2):
        x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                            padding=1))
        x = F.max_pool2d(x, 2, 2)
    h, w = x.shape[2:]
    window = (max(h // 2, 1), max(w // 2, 1))
    x = F.avg_pool2d(x, window, window)[:, :, :2, :2]
    return x.permute(0, 2, 3, 1).flatten(1)


def _obs(rng, b, h, w, c, dtype, wide=False):
    """One-hot-like planes (a fifth of the cells set), times 255 where
    ``wide``, as uint8 or float32."""
    obs = (rng.random((b, h, w, c)) < 0.2).astype(np.float32)
    if wide:
        obs *= 255
    return torch.as_tensor(obs).to(dtype)


def _net(h, w, c, binary, seed=0, device='cpu'):
    torch.manual_seed(seed)
    return ActorCritic((h, w), c, 3, assume_binary_obs=binary, device=device)


def _weights(net):
    return [net.conv1.weight, net.conv1.bias, net.conv2.weight,
            net.conv2.bias]


def _features_and_grads(fn, net, x, seed=1):
    """Features of ``fn(net, x)`` and the gradients of a fixed random
    projection of them in the trunk's four weights."""
    feats = fn(net, x)
    proj = torch.randn(feats.shape, generator=torch.Generator().manual_seed(
        seed)).to(feats.device)
    grads = torch.autograd.grad((feats * proj).sum(), _weights(net))
    return feats.detach(), grads


# --- the CPU path ------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.uint8, torch.float32],
                         ids=['uint8', 'float32'])
@pytest.mark.parametrize('binary', [True, False], ids=['binary', 'scaled'])
@pytest.mark.parametrize('shape', list(SHAPES))
def test_cpu_features_and_grads_equal_the_code_before(shape, binary, dtype):
    h, w, c = SHAPES[shape]
    net = _net(h, w, c, binary)
    x = _obs(np.random.default_rng(7), 6, h, w, c, dtype, wide=not binary)
    got, got_g = _features_and_grads(lambda n, o: n.features(o), net, x)
    want, want_g = _features_and_grads(_features_before, net, x)
    assert got.shape == (6, ppo_model.feature_size((h, w)))
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(net.features(x[0]), want[:1])   # (H, W, C)


@pytest.mark.parametrize('device,dtype,kernel', [
    ('cuda', torch.float32, True), ('cuda', torch.bfloat16, False),
    ('cpu', torch.float32, False), ('cpu', torch.bfloat16, False)])
def test_the_kernel_serves_float32_on_the_card_only(monkeypatch, device,
                                                    dtype, kernel):
    """``trunk`` goes to ``ppo_trunk`` for float32 on a CUDA tensor and to
    ``trunk_plain`` otherwise; the bfloat16 option's plain path is the
    net's, cast layer by layer."""
    taken = []
    monkeypatch.setattr(PT, 'ppo_trunk', lambda *a: taken.append('kernel'))
    monkeypatch.setattr(PT, 'trunk_plain',
                        lambda *a: taken.append('plain'))

    class Probe:
        def __init__(self, kind):
            self.device = torch.device(kind)
    PT.trunk(Probe(device), None, None, None, None, dtype, True)
    assert taken == ['kernel' if kernel else 'plain']


def test_bfloat16_keeps_its_plain_path():
    net = ActorCritic((10, 10), 8, 3, assume_binary_obs=True, device='cpu',
                      compute_dtype=torch.bfloat16)
    x = _obs(np.random.default_rng(3), 4, 10, 10, 8, torch.uint8)
    with torch.no_grad():
        got = net.features(x)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, _features_before(net, x))


def _checked(**change):
    args = dict(x=torch.zeros((2, 20, 20, 8), dtype=torch.uint8),
                w1=torch.zeros((32, 8, 3, 3)), b1=torch.zeros(32),
                w2=torch.zeros((32, 32, 3, 3)), b2=torch.zeros(32))
    args.update(change)
    return PT.check_trunk_args(**args)


@pytest.mark.parametrize('change,error,match', [
    (dict(x=torch.zeros((2, 20, 20, 8), dtype=torch.int32)), ValueError,
     'uint8 or float32'),
    (dict(x=torch.zeros((20, 20, 8), dtype=torch.uint8)), ValueError,
     r'\(B, H, W, C\)'),
    (dict(w1=torch.zeros((32, 8, 3, 3), dtype=torch.float64)), ValueError,
     'conv1.weight must be float32'),
    (dict(b2=torch.zeros(16)), ValueError, 'conv2.bias must be'),
    (dict(w2=torch.zeros((32, 32, 3, 3), device='meta')), ValueError,
     'conv2.weight is on meta'),
    (dict(x=torch.zeros((2, 3, 20, 8), dtype=torch.uint8)), ValueError,
     'at least 4x4'),
    (dict(x=torch.zeros((2, 20, 20, 72), dtype=torch.uint8),
          w1=torch.zeros((32, 72, 3, 3))), NotImplementedError,
     '1 to 64 input channels'),
    (dict(x=torch.zeros((2, 20, 20, 8), requires_grad=True)),
     NotImplementedError, 'no gradient for the obs'),
], ids=['obs-dtype', 'obs-rank', 'weight-dtype', 'bias-shape',
        'weight-device', 'board-3', 'channels-72', 'obs-grad'])
def test_argument_checks_raise(change, error, match):
    with pytest.raises(error, match=match):
        _checked(**change)


@pytest.mark.parametrize('device,dtype,cin,refused', [
    ('cuda', torch.float32, 72, True), ('cuda', torch.float32, 64, False),
    ('cuda', torch.bfloat16, 72, False), ('cpu', torch.float32, 72, False)])
def test_check_served_refuses_what_the_kernel_would_not_take(device, dtype,
                                                             cin, refused):
    check = lambda: PT.check_served(cin, torch.device(device), dtype)
    if refused:
        with pytest.raises(NotImplementedError, match='frame_stack'):
            check()
    else:
        check()


def test_the_net_refuses_channels_the_kernel_does_not_take(monkeypatch):
    """An ActorCritic whose trunk would run on the kernel with more input
    planes than it takes is refused where it is built (the PPO trainer,
    the CLI and the battles build it), not at its first call."""
    monkeypatch.setattr(ppo_model, 'resolve_device',
                        lambda device: torch.device('cuda'))
    with pytest.raises(NotImplementedError, match='1 to 64 input channels'):
        ActorCritic((20, 20), 72, 3)
    monkeypatch.undo()
    # the plain trunk takes any number of planes
    net = ActorCritic((20, 20), 72, 3, device='cpu')
    with torch.no_grad():
        assert net.features(torch.zeros((2, 20, 20, 72))).shape == (2, 128)


@pytest.mark.parametrize('hw,c', [((20, 20), 8), ((10, 10), 8),
                                  ((11, 9), 8), ((20, 20), 32),
                                  ((40, 40), 8), ((4, 4), 8), ((6, 6), 8),
                                  ((11, 11), 16), ((20, 12), 8), ((7, 7), 3)])
def test_layout_keeps_loads_aligned_and_reads_inside_the_planes(hw, c):
    """Offsets are multiples of 4 floats and the planes read 8 bytes at a
    time have even rows (16- and 8-byte loads); the weight gradients'
    cells hold whole 16-byte loads of their channels, and the four cells
    of a window start in distinct banks; every cell the kernels read lies
    inside its padded plane; a row fits one block; the cells computed are
    those the plain trunk's output reads."""
    s = _checked(x=torch.zeros((1,) + hw + (c,), dtype=torch.uint8),
                 w1=torch.zeros((32, c, 3, 3)))
    lay = PT.layout(s)
    p = lay.planes
    offsets = {**lay.fwd, **lay.w1, **lay.w2}
    for name, v in offsets.items():
        if not name.endswith('plane'):
            assert v % 4 == 0, name
    assert p['XW'] % 2 == p['P1W'] % 2 == 0
    h1, w1 = hw[0] // 2, hw[1] // 2
    # conv1 reads padded rows 2qy .. 2qy + 3 of the obs planes
    assert 2 * s.uh1 + 1 < p['XH'] and 2 * s.uw1 + 1 < p['XW']
    # conv2 reads padded rows 2qy .. 2qy + 3 of the pool-1 planes, whose
    # cells past the computed ones are the zero halo or SAME padding
    assert 2 * s.uh2 + 1 < p['P1H'] and 2 * s.uw2 + 1 < p['P1W']
    assert s.uh1 == min(2 * s.uh2 + 1, h1) and s.uw1 == min(2 * s.uw2 + 1,
                                                           w1)
    # the weight gradients read the cells (2q + d + k) of the padded
    # planes, q < uh, d and k < 2 and 3: conv1's cell by cell, whole 16-byte
    # loads whose four cells of a window start in distinct banks; conv2's a
    # lane a plane, planes an odd number of floats apart
    b = lay.bwd_planes
    assert b['b_csx'] % 4 == 0 and b['b_csx'] >= PT.GROUP * -(-c // PT.GROUP)
    assert PT.distinct_banks(b['b_csx'], b['b_xw'])
    assert b['b_p1pp'] % 2 == 1 and b['b_p1pp'] >= p['P1H'] * b['b_p1w']
    assert 2 * s.uw2 + 1 < b['b_p1w'] and 2 * s.uw1 + 1 < b['b_xw']
    assert b['b_xw'] >= hw[1] + 2 and b['b_p1w'] >= s.uw1 + 2
    # a stage holds pool 1's codes as saved: 32 channels of uh1 x uw1 bytes
    n1 = s.uh1 * s.uw1
    assert 4 * (lay.w1['w1_st'] - lay.w1['w1_c1']) >= PT.C * n1
    assert all(lay.bytes(kind, 1) <= PT.MAX_SMEM for kind in PT.KINDS)
    assert s.features == ppo_model.feature_size(hw)
    # the plain trunk's features depend on these pooled cells only
    h2, w2 = h1 // 2, w1 // 2
    assert s.uh2 <= h2 and s.uw2 <= w2
    assert s.ph == min(h2 // s.wh, 2) and s.pw == min(w2 // s.ww, 2)


@pytest.mark.parametrize('batch', [1, 33, 1024, 2048, 32768])
@pytest.mark.parametrize('kind', PT.KINDS)
def test_plans_stay_within_the_batch_and_the_block(batch, kind):
    s = PT.trunk_shape(20, 20, 8)
    lay = PT.layout(s)
    plan = PT.plan(batch, kind, s, 132, lambda smem, scratch: 1)
    assert 1 <= plan.rows <= min(batch, lay.max_rows(kind))
    assert 1 <= plan.grid <= min(-(-batch // plan.rows), 132)
    assert plan.smem == lay.bytes(kind, plan.rows) <= PT.MAX_SMEM
    assert plan.scratch == 0


@pytest.mark.parametrize('batch', [1, 33, 1024, 5000, 32768])
@pytest.mark.parametrize('kind', PT.KINDS)
@pytest.mark.parametrize('shape', list(SHAPES))
def test_plan_takes_the_fewest_rows_of_the_fewest_rounds(shape, kind, batch):
    """A tile's rows: no more rounds of 132 blocks than the most rows
    that fit would take, and one row fewer would take more."""
    s = PT.trunk_shape(*SHAPES[shape])
    plan = PT.plan(batch, kind, s, 132, lambda smem, scratch: 1)
    most = min(PT.layout(s).max_rows(kind), batch)

    def rounds(rows):
        return -(-batch // (132 * rows))
    assert rounds(plan.rows) == rounds(most)
    assert plan.rows == 1 or rounds(plan.rows - 1) > rounds(most)


@pytest.mark.parametrize('hw,c,fits', [
    ((30, 30), 32, (False, False, True)), ((48, 48), 8, (True, False, True)),
    ((64, 64), 8, (False, False, False)),
    ((100, 100), 16, (False, False, False)),
    ((20, 20), 40, (True, True, True)), ((40, 40), 8, (True, True, True)),
    ((20, 20), 64, (False, True, True))])
@pytest.mark.parametrize('batch', [1, 1024])
def test_rows_that_do_not_fit_keep_their_planes_in_device_memory(
        hw, c, fits, batch):
    """Where one row's planes exceed a block's shared memory (``fits``:
    the forward's, conv1's and conv2's weight gradients'), a tile is one
    row, shared memory holds what the block keeps for every row alone,
    and each block has its row's planes in a scratch buffer; where they
    fit, nothing is kept in device memory."""
    s = _checked(x=torch.zeros((1,) + hw + (c,), dtype=torch.uint8),
                 w1=torch.zeros((32, c, 3, 3)))
    lay = PT.layout(s)
    for kind, fit in zip(PT.KINDS, fits):
        head, ss = lay.head(kind), lay.row(kind)
        plan = PT.plan(batch, kind, s, 132, lambda smem, scratch: 1)
        assert (lay.max_rows(kind) >= 1) == fit
        if fit:
            assert plan.scratch == 0 and plan.smem == 4 * (
                head + plan.rows * ss)
        else:
            assert plan == PT.Plan(1, min(batch, 132), 4 * head,
                                   min(batch, 132) * ss)
        assert plan.smem <= PT.MAX_SMEM


@pytest.mark.parametrize('hw,c', [
    ((20, 20), 8), ((4, 4), 1), ((7, 7), 3), ((11, 9), 8), ((11, 11), 16),
    ((20, 20), 32), ((20, 20), 64), ((30, 30), 32), ((40, 40), 8),
    ((48, 48), 8), ((100, 100), 16), ((128, 96), 64)])
@pytest.mark.parametrize('batch', [1, 33, 32768])
def test_every_served_shape_backward_fits_shared_memory(hw, c, batch):
    """Both kernels of the backward ask one block for at most 232,448
    bytes of shared memory at every shape the wrapper serves (1 to 64
    planes, any board of at least 4x4): the pool-1 gradient's is fixed,
    the weight gradients' tile is what fits, or one row in device memory;
    the pool-1 gradient's grid has a warp for every row at most."""
    s = _checked(x=torch.zeros((1,) + hw + (c,), dtype=torch.uint8),
                 w1=torch.zeros((32, c, 3, 3)))
    assert PT.POOL1_SMEM <= PT.MAX_SMEM
    pool1 = PT.plan_pool1(batch, 132, lambda smem, scratch: 2)
    assert pool1.smem == PT.POOL1_SMEM
    assert 1 <= pool1.grid <= min(264, -(-batch // PT.BWD_WARPS))
    for kind in ('w1', 'w2'):
        bwd = PT.plan(batch, kind, s, 132, lambda smem, scratch: 1)
        assert 0 <= bwd.smem <= PT.MAX_SMEM
        assert (bwd.scratch == 0) == (PT.layout(s).max_rows(kind) >= 1)
    both = PT.plan_weight_grads(batch, s, 132, lambda smem, scratch: 2)
    assert 0 <= both.smem <= PT.MAX_SMEM and 1 <= both.pairs <= 132


def test_struct_mirror_matches_the_cuda_source():
    with open(PT.SOURCE) as fp:
        body = re.search(r'struct TrunkArgs \{(.*?)\n\};', fp.read(),
                         re.S).group(1)
    want = []
    for decl in filter(None, (d.strip() for d in
                              re.sub(r'//[^\n]*', '', body).split(';'))):
        m = re.fullmatch(r'(const\s+)?(\w+)\s*(\*?)\s*(.*)', decl, re.S)
        assert m, decl
        for name in m.group(4).split(','):
            want.append((name.strip(), ctypes.c_void_p if m.group(3)
                         else ctypes.c_int))
    assert list(PT._TrunkArgs._fields_) == want


def test_source_constants_match_the_wrapper():
    with open(PT.SOURCE) as fp:
        src = fp.read()
    assert re.search(rf'constexpr int kC = {PT.C};', src)
    # the weight gradients' warps take MAX_CIN input channels at most, in
    # groups of GROUP; the pool-1 gradient's shared memory
    assert re.search(rf'constexpr int kMaxCin = {PT.MAX_CIN};', src)
    assert re.search(rf'constexpr int kBwdThreads = {32 * PT.BWD_WARPS};',
                     src)
    assert re.search(rf'constexpr int kGroup = {PT.GROUP};', src)
    assert re.search(rf'constexpr int kWin = {PT.WIN};', src)
    assert PT.MAX_CIN <= PT.GROUP * PT.BWD_WARPS


# --- the launch path, with a stand-in library --------------------------------

def _at(address, dtype, shape):
    """A tensor over ``shape`` contiguous elements at ``address``."""
    size = int(np.prod(shape)) * dtype.itemsize
    buf = (ctypes.c_uint8 * size).from_address(address)
    return torch.from_numpy(np.ctypeslib.as_array(buf)).view(dtype).view(
        shape)


class _PlainTrunkLibrary:
    """Stands in for the CUDA library: reads the arguments the launchers
    pass and does in PyTorch what the kernels do, on the memory they point
    at."""

    def __init__(self):
        self.calls = []

    def marlsnake_trunk_error_string(self, rc):
        return b'stand-in'

    def _args(self, a, is_float):
        shape = PT.trunk_shape(a.H, a.W, a.Cin)
        x = _at(a.x, torch.float32 if is_float else torch.uint8,
                (a.B, a.H, a.W, a.Cin))
        # the wrapper's flag is the plain rule's: divide where the batch's
        # maximum exceeds 1
        binary = not a.divide
        if a.divide:
            assert bool(_at(a.divide, torch.bool, ())) == bool(x.max() > 1)
        return shape, x, binary

    def marlsnake_trunk_forward(self, args_ref, is_float, grid, smem,
                                stream):
        a = args_ref._obj
        shape, x, binary = self._args(a, is_float)
        self.calls.append(('forward', a.B, a.S, grid, smem, bool(a.scratch),
                           bool(a.p1)))
        lay = PT.layout(shape)
        assert smem == lay.bytes('forward', 0 if a.scratch else a.S)
        feats, saved = PT.forward_plain(
            x, _at(a.w1, torch.float32, (32, a.Cin, 3, 3)),
            _at(a.b1, torch.float32, (32,)),
            _at(a.w2, torch.float32, (32, 32, 3, 3)),
            _at(a.b2, torch.float32, (32,)), shape, binary)
        _at(a.feats, torch.float32, tuple(feats.shape)).copy_(feats)
        if a.p1:
            for name, dtype, t in zip(('p1', 'code1', 'code2'),
                                      (torch.float32, torch.uint8,
                                       torch.uint8), saved):
                _at(getattr(a, name), dtype, tuple(t.shape)).copy_(t)
        return 0

    def marlsnake_trunk_backward(self, args_ref, is_float, grid_p, smem_p,
                                 pairs, smem_w, stream):
        a = args_ref._obj
        shape, x, binary = self._args(a, is_float)
        self.calls.append(('backward', a.B, a.S, pairs, smem_w,
                           bool(a.scratch), bool(a.scratch2)))
        lay = PT.layout(shape)
        assert smem_w == max(lay.bytes('w1', 0 if a.scratch else a.S),
                             lay.bytes('w2', 0 if a.scratch2 else a.S2))
        assert smem_p == PT.POOL1_SMEM and 1 <= grid_p <= -(-a.B // 8)
        assert 1 <= pairs <= min(-(-a.B // a.S), -(-a.B // a.S2))
        s = shape
        # the pool-1 gradient's buffer, (B, UH1 * UW1, 32)
        _at(a.dp1, torch.float32, (a.B, s.uh1 * s.uw1, 32)).zero_()
        saved = (_at(a.p1, torch.float32, (a.B, 32, s.uh1, s.uw1)),
                 _at(a.code1, torch.uint8, (a.B, 32, s.uh1, s.uw1)),
                 _at(a.code2, torch.uint8, (a.B, 32, s.uh2, s.uw2)))
        grads = PT.backward_plain(
            _at(a.gfeats, torch.float32, (a.B, s.features)), x,
            _at(a.w2, torch.float32, (32, 32, 3, 3)), saved, s, binary)
        _at(a.grads, torch.float32, (a.nw,)).copy_(
            torch.cat([g.flatten() for g in grads]))
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = _PlainTrunkLibrary()
    monkeypatch.setattr(PT, 'load_library', lambda: lib)
    monkeypatch.setattr(PT, '_sm_count', lambda index: 4)
    monkeypatch.setattr(PT, '_occupancy', lambda *args: 1)
    monkeypatch.setattr(cuda_build, 'on_current_stream',
                        lambda index, call: call(0))
    PT._plans.cache_clear()
    yield lib
    PT._plans.cache_clear()


@pytest.mark.parametrize('dtype,binary', [(torch.uint8, True),
                                          (torch.float32, False)],
                         ids=['uint8-binary', 'float32-scaled'])
@pytest.mark.parametrize('shape', list(SHAPES) + list(SCRATCH_SHAPES)
                         + list(LANE_SHAPES))
def test_launch_path_saves_what_the_gradients_need(stand_in, shape, dtype,
                                                   binary):
    """Through the stand-in, the wrapper's features equal the plain
    trunk's, and its weights' gradients, routed back through the pools'
    codes and the saved pooled conv1 map alone, agree with autograd's
    through the plain trunk (the same sums in another order: within
    float32 rounding). Under no_grad nothing is saved; every call is
    counted."""
    h, w, c = CARD_SHAPES[shape]
    net = _net(h, w, c, binary, seed=4)
    x = _obs(np.random.default_rng(5), 9, h, w, c, dtype, wide=not binary)
    fwd, bwd = PT.ppo_trunk.launches, PT.ppo_trunk.backward_launches

    def kernel(n, o):
        return PT.ppo_trunk(o, *_weights(n), binary)

    got, got_g = _features_and_grads(kernel, net, x)
    want, want_g = _features_and_grads(_features_before, net, x)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        if shape in SCRATCH_SHAPES or shape in LANE_SHAPES:
            # sums over up to six times the cells: rounding relative to
            # the largest gradient, as the card's tests hold it
            _close(a, b.double())
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        assert torch.equal(kernel(net, x), want)
    assert PT.ppo_trunk.launches - fwd == 2
    assert PT.ppo_trunk.backward_launches - bwd == 1
    assert [call[0] for call in stand_in.calls] == ['forward', 'backward',
                                                    'forward']
    assert [call[-1] for call in stand_in.calls if call[0] == 'forward'] == [
        True, False]
    lay = PT.layout(PT.trunk_shape(h, w, c))
    assert [call[5] for call in stand_in.calls] == [
        lay.max_rows('forward') < 1, lay.max_rows('w1') < 1,
        lay.max_rows('forward') < 1]
    assert stand_in.calls[1][6] == (lay.max_rows('w2') < 1)


def test_choice_gaps_tell_a_near_tie_from_a_wrong_position():
    """The plain forward's own codes have no gap; codes moved to another
    cell of their window (what a forward kernel writing wrong positions
    would save) differ in most open windows, by far more than rounding."""
    h, w, c = SHAPES['20x20']
    net = _net(h, w, c, True, seed=2)
    x = _obs(np.random.default_rng(2), 8, h, w, c, torch.uint8)
    s = PT.trunk_shape(h, w, c)
    w64 = [p.detach().double() for p in _weights(net)]
    codes = PT.forward_plain(x, *w64, s, True)[1][1:]
    assert PT.choice_gaps(x, *w64, codes, s, True) == [(0, 0.0), (0, 0.0)]
    moved = [torch.where(k > 0, (k - 1 + 1) % 4 + 1, k).to(torch.uint8)
             for k in codes]
    for (count, gap), k in zip(PT.choice_gaps(x, *w64, moved, s, True),
                               codes):
        assert count > 1e-3 * k.numel() and count == int((k > 0).sum())
        assert gap > 1e-3


def test_an_empty_batch_launches_no_trunk(stand_in):
    net = _net(20, 20, 8, True)
    fwd = PT.ppo_trunk.launches
    with torch.no_grad():
        out = PT.ppo_trunk(torch.zeros((0, 20, 20, 8), dtype=torch.uint8),
                           *_weights(net), True)
    assert out.shape == (0, 128) and PT.ppo_trunk.launches == fwd
    assert stand_in.calls == []


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the trunk kernel runs only there')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _card_case(card, shape, batch, seed, dtype=torch.uint8, binary=True):
    h, w, c = CARD_SHAPES[shape]
    net = _net(h, w, c, binary, seed=seed, device=card)
    x = _obs(np.random.default_rng(seed), batch, h, w, c, dtype,
             wide=not binary).to(card)
    return net, x


def _projection(shape, device, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        seed)).to(device)


def _reference(x, weights, saved, gfeats, s, binary, chunk=4096):
    """The plain versions of both kernels in float64 on the card, ``chunk``
    rows at a time: features, the pooled conv1 map, the gradients routed
    through the kernel's own codes (``saved``), and for each pool the
    windows whose code differs from the kernel's and the largest gap
    between the values the two codes name."""
    w64 = [w.detach().double() for w in weights]
    feats, p1s, grads = [], [], [0.0] * 4
    ties = {'code1': [0, 0.0], 'code2': [0, 0.0]}
    for i in range(0, x.shape[0], chunk):
        rows = slice(i, i + chunk)
        mine = tuple(t[rows] for t in saved)
        f, (p1, _, _) = PT.forward_plain(x[rows], *w64, s, binary)
        feats.append(f)
        p1s.append(p1)
        for name, (count, gap) in zip(ties, PT.choice_gaps(
                x[rows], *w64, mine[1:], s, binary)):
            ties[name][0] += count
            ties[name][1] = max(ties[name][1], gap)
        for k, g in enumerate(PT.backward_plain(
                gfeats[rows], x[rows], w64[2], mine, s, binary)):
            grads[k] = grads[k] + g
    return torch.cat(feats), torch.cat(p1s), grads, ties


def _close(got, want, rel=1e-5):
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    assert err <= rel * max(scale, 1e-3), (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,batch', CARD_CASES)
def test_card_kernel_against_the_plain_trunk(card, shape, batch):
    """Both kernels against their plain versions in float64:

    - features and the pooled conv1 map within 1e-5 of the largest (the
      kernel sums a few hundred products in float32 in another order);
    - every pool's choice the plain version's, but where the two values
      the codes name lie within 1e-5 of the largest pre-ReLU value (a
      near-tie that float32 rounding may settle either way; at most one
      window in a thousand);
    - the weight gradients within 1e-5 of the largest of
      ``backward_plain`` over the kernel's own codes: a near-tie moves a
      window's whole gradient, so the plain trunk's own routing would
      differ by far more than rounding there;
    - the net's autograd path launches each kernel once and gives the same
      gradients, bit for bit."""
    h, w, c = CARD_SHAPES[shape]
    net, x = _card_case(card, shape, batch, seed=batch)
    s = PT.trunk_shape(h, w, c)
    weights = [p.detach() for p in _weights(net)]
    feats, saved = PT.launch_forward(x, None, *weights, s, True)
    proj = _projection(feats.shape, card)
    grads = PT.launch_backward(proj, x, None, weights[2], saved, s)
    want, want_p1, want_g, ties = _reference(x, weights, saved, proj, s,
                                             True)
    _close(feats, want)
    _close(saved[0], want_p1)
    for name, (count, gap) in ties.items():
        assert gap <= 1e-5 and count <= 1e-3 * saved[1].numel(), (name,
                                                                  count, gap)
    for a, b in zip(grads, want_g):
        _close(a, b)
    fwd, bwd = PT.ppo_trunk.launches, PT.ppo_trunk.backward_launches
    auto = torch.autograd.grad((net.features(x) * proj).sum(),
                               _weights(net))
    torch.cuda.synchronize()
    assert PT.ppo_trunk.launches - fwd == 1
    assert PT.ppo_trunk.backward_launches - bwd == 1
    for a, b in zip(auto, grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,binary', [(torch.uint8, False),
                                          (torch.float32, True),
                                          (torch.float32, False)],
                         ids=['uint8-scaled', 'float32-binary',
                              'float32-scaled'])
def test_card_obs_types_and_scaling(card, dtype, binary):
    """The obs's type and the /255 rule (a flag the wrapper computes on
    the device): features within 1e-5 of the largest of the plain trunk's
    in float64."""
    net, x = _card_case(card, '20x20', 1024, 11, dtype, binary)
    s = PT.trunk_shape(20, 20, 8)
    with torch.no_grad():
        got = net.features(x)
        want, _ = PT.forward_plain(x, *(p.double() for p in _weights(net)),
                                   s, binary)
    _close(got, want)


def _integer_net(shape, card, seed):
    """Small integer weights and biases: every sum is an exact integer in
    any order, so ties between neighbouring cells of an empty region are
    ties on both sides."""
    h, w, c = CARD_SHAPES[shape]
    net = _net(h, w, c, True, device=card)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in _weights(net):
            p.copy_(torch.randint(-2, 3, p.shape, generator=gen).float())
    return net


def _sparse_boards(rng, b, h, w, c):
    """One-hot boards with large empty regions: a few cells of each
    plane set, in the top-left quarter."""
    obs = np.zeros((b, h, w, c), np.uint8)
    for i in range(b):
        for _ in range(6):
            obs[i, rng.integers(h // 2), rng.integers(w // 2),
                rng.integers(c)] = 1
    return torch.as_tensor(obs)


@pytest.mark.cuda
@pytest.mark.parametrize('batch', [1, 33, 1024])
@pytest.mark.parametrize('shape', list(CARD_SHAPES))
def test_card_ties_exact(card, shape, batch):
    """Integer weights on sparse one-hot boards: the kernel's features,
    its pools' choices and its weight gradients EQUAL the plain trunk's on
    the CPU (every sum exact; the features' gradient a multiple of the
    average pool's window, so the routed gradients are integers too)."""
    h, w, c = CARD_SHAPES[shape]
    net = _integer_net(shape, card, seed=batch)
    x = _sparse_boards(np.random.default_rng(batch), batch, h, w, c)
    s = PT.trunk_shape(h, w, c)
    gf = (torch.randint(-3, 4, (batch, s.features),
                        generator=torch.Generator().manual_seed(1))
          * s.wh * s.ww).float()
    feats, saved = PT.launch_forward(x.to(card), None, *(
        p.detach() for p in _weights(net)), s, True)
    grads = PT.launch_backward(gf.to(card), x.to(card), None,
                               net.conv2.weight.detach(), saved, s)
    cpu = [p.detach().cpu().requires_grad_(True) for p in _weights(net)]
    want = PT.trunk_plain(x, *cpu, torch.float32, True)
    want_g = torch.autograd.grad((want * gf).sum(), cpu)
    assert torch.equal(feats.cpu(), want.detach())
    for a, b in zip(grads, want_g):
        assert torch.equal(a.cpu(), b)
    # the pools' choices: pool 1's codes against the plain max pool's
    # indices where the maximum is above 0
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), cpu[0].detach(),
                 cpu[1].detach(), padding=1)
    _, code1 = PT._pool_with_codes(y)
    assert torch.equal(saved[1].cpu(), code1[:, :, :s.uh1, :s.uw1])
    assert int((saved[1] > 0).sum()) > 0


@pytest.mark.cuda
def test_card_backward_is_deterministic(card):
    """Two backwards of a minibatch, through the pool-1 gradient, the
    weight gradients' block partials and their reduction, give the same
    bits."""
    net, x = _card_case(card, '20x20', 32768, 3)
    bwd = PT.ppo_trunk.backward_launches
    a = _features_and_grads(lambda n, o: n.features(o), net, x)[1]
    b = _features_and_grads(lambda n, o: n.features(o), net, x)[1]
    assert PT.ppo_trunk.backward_launches - bwd == 2
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize('backward', [False, True],
                         ids=['forward', 'backward'])
@pytest.mark.parametrize('batch', [33, 1024])
def test_card_graph_replay_equals_the_uncaptured_forward(card, batch,
                                                         backward):
    """A captured graph of the forward (or of the forward and the
    backward), replayed on other obs, gives what the uncaptured calls give
    on them, bit for bit."""
    net, x = _card_case(card, '20x20', batch, 5)
    proj = _projection((batch, 128), card)
    net.requires_grad_(backward)

    def call():
        with torch.set_grad_enabled(backward):
            feats = net.features(x)
            if not backward:
                return (feats,)
            return torch.autograd.grad((feats * proj).sum(), _weights(net))

    flipped = torch.flip(x, (0,))
    x_saved = x.clone()
    x.copy_(flipped)
    want = [t.clone() for t in call()]
    x.copy_(x_saved)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    x.copy_(flipped)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert torch.equal(a, b)
