"""The PPO ActorCritic's conv trunk: plain version and kernel.

The trunk is ``ActorCritic.features`` (``models/ppo.py``): NHWC obs ->
float -> conv1 3x3 SAME + bias -> ReLU -> 2x2 max pool -> conv2 3x3 SAME +
bias -> ReLU -> 2x2 max pool -> the average pool of window
``(max(h2 // 2, 1), max(w2 // 2, 1))`` cropped to at most 2x2 -> the
features flattened in NHWC order.

``trunk`` is the wrapper: on CPU tensors, and for a compute dtype other
than float32, the plain version ``trunk_plain`` (PyTorch operations, the
net's code before the kernel); on CUDA tensors in float32, ``ppo_trunk``:
one launch of ``csrc/ppo_trunk.cu``'s forward, and, where autograd needs
the weights' gradients, one backward per backward call: the pool-1
gradient's kernel, the weight gradients' and the reduction that sums the
latter's per-block partials. No gradient is taken for the obs.
``ppo_trunk.launches`` and ``ppo_trunk.backward_launches`` count forwards
and backwards. ``forward_plain`` and
``backward_plain`` are the plain versions of the two kernels: the forward
with what it saves (the pooled conv1 map and both pools' codes), the
backward from those alone, routing each window's gradient to the cell its
code names. A max pool's choice between two cells within float32 rounding
of each other is the plain trunk's or not by the order of the sums, so the
card's tests hold the backward to ``backward_plain`` over the kernel's own
codes.

The checks (``check_trunk_args``), the plan of a launch (rows a tile,
blocks, and where a row's planes do not fit one block's shared memory,
the scratch buffer in device memory that holds them) and the
shared-memory layouts are computed here, need no GPU and are tested on
the CPU. The library is built on first use with nvcc
(``ops/cuda_build.py``) into ``build/marlsnake_torch/`` and loaded with
ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from marlsnake_torch.ops import cuda_build
from marlsnake_torch.ops.obs_pack import prepare_obs

SOURCE = os.path.join(cuda_build.CSRC_DIR, 'ppo_trunk.cu')

C = 32                        # output channels of both convolutions
MAX_CIN = 64                  # input channels the backward's warps cover
MAX_SMEM = 232448             # one block's shared memory on an H100
HALF_SMEM = 115712            # each of two blocks an SM holds at once
BWD_WARPS = 8                 # warps a block of the backward's kernels
GROUP = 8                     # input channels a warp's weight gradient
WIN = 2                       # pool-1 gradient: 2x2 pool-2 windows a block
# the pool-1 gradient's shared memory: conv2's weights, then each warp's
# codes (a byte) and gradients of a block's windows
POOL1_SMEM = 4 * (C * 9 * C + BWD_WARPS * (C * WIN * WIN // 4
                                           + C * WIN * WIN))


class _TrunkArgs(ctypes.Structure):
    """Mirror of ``struct TrunkArgs`` in csrc/ppo_trunk.cu."""
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            'x', 'divide', 'w1', 'b1', 'w2', 'b2', 'feats', 'p1', 'code1',
            'code2', 'gfeats', 'dp1', 'partial', 'grads', 'scratch',
            'scratch2')]
        + [(name, ctypes.c_int) for name in (
            'B', 'H', 'W', 'Cin', 'UH1', 'UW1', 'UH2', 'UW2', 'WH', 'WW',
            'PH', 'PW', 'XH', 'XW', 'P1H', 'P1W', 'S', 'S2', 'nw', 'vec4',
            'f_w1', 'f_b1', 'f_w2', 'f_b2', 'f_samples', 'f_ss', 'f_x',
            'f_p1', 'f_p2', 'w1_ss', 'w1_x', 'w1_st', 'w1_raw', 'w1_d',
            'w1_c1', 'w2_head', 'w2_ss', 'w2_st', 'w2_p1', 'w2_g2', 'w2_c2',
            'w2_ct', 'b_p1w', 'b_p1pp', 'b_xw', 'b_csx')])


def trunk_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor,
                compute_dtype: torch.dtype,
                assume_binary_obs: bool) -> torch.Tensor:
    """The trunk in PyTorch operations, on either device and in any
    compute dtype: the weights are cast to ``compute_dtype`` as they are
    used, and the features come out in it."""
    dt = compute_dtype
    x = prepare_obs(x, dt, assume_binary_obs).permute(0, 3, 1, 2)
    for w, b in ((w1, b1), (w2, b2)):
        x = F.relu(F.conv2d(x, w.to(dt), b.to(dt), padding=1))
        x = F.max_pool2d(x, 2, 2)
    h, w = x.shape[2:]
    window = (max(h // 2, 1), max(w // 2, 1))
    x = F.avg_pool2d(x, window, window)[:, :, :2, :2]
    return x.permute(0, 2, 3, 1).flatten(1)


def _pool_with_codes(y: torch.Tensor):
    """2x2 max pool of pre-ReLU maps (B, C, H, W) as the kernel pools:
    the ReLU'd maximum and its code (0 where it is not above 0, else 1 +
    the first maximum's position in the window, row-major)."""
    m, idx = F.max_pool2d(y, 2, 2, return_indices=True)
    w = y.shape[3]
    at = (idx // w % 2) * 2 + idx % w % 2
    return F.relu(m), torch.where(m > 0, at + 1, 0).to(torch.uint8)


def _route(code: torch.Tensor, g: torch.Tensor, out_hw) -> torch.Tensor:
    """A zero map of ``out_hw`` holding ``g`` at each 2x2 window's coded
    position."""
    b, c, h, w = code.shape
    dense = g.new_zeros((b, c, h, 2, w, 2))
    at = code.long() - 1
    for k in range(4):
        dense[:, :, :, k // 2, :, k % 2] = torch.where(at == k, g, 0.0)
    full = g.new_zeros((b, c) + tuple(out_hw))
    full[:, :, :2 * h, :2 * w] = dense.view(b, c, 2 * h, 2 * w)
    return full


def _code_values(y: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """The pre-ReLU value each code names in its 2x2 window of ``y`` (0
    for code 0, the ReLU's level)."""
    b, c, h, w = code.shape
    win = y[:, :, :2 * h, :2 * w].reshape(b, c, h, 2, w, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, h, w, 4)
    v = win.gather(-1, (code.long() - 1).clamp(min=0)[..., None])[..., 0]
    return torch.where(code > 0, v, torch.zeros_like(v))


def choice_gaps(x: torch.Tensor, w1, b1, w2, b2, codes, s: 'TrunkShape',
                assume_binary_obs: bool):
    """The pools' choices ``codes`` (pool 1's, pool 2's, over the cells
    the kernel computes) against the plain forward's in the weights'
    dtype: for each pool, the windows whose code differs and the largest
    gap between the pre-ReLU values the two codes name, over the largest
    pre-ReLU value (0 where none differs). A near-tie that rounding
    settles the other way has a gap of rounding's size; a wrong position
    has a gap of the values' own."""
    x = prepare_obs(x, w1.dtype, assume_binary_obs).permute(0, 3, 1, 2)
    y1 = F.conv2d(x, w1, b1, padding=1)
    p1, want1 = _pool_with_codes(y1)
    y2 = F.conv2d(p1, w2, b2, padding=1)
    want2 = _pool_with_codes(y2)[1]
    out = []
    for y, want, got in ((y1, want1[:, :, :s.uh1, :s.uw1], codes[0]),
                         (y2, want2[:, :, :s.uh2, :s.uw2], codes[1])):
        diff = want != got
        gap = 0.0
        if diff.any():
            gap = float((_code_values(y, want) - _code_values(y, got)
                         ).abs()[diff].max() / y.abs().max())
        out.append((int(diff.sum()), gap))
    return out


def forward_plain(x: torch.Tensor, w1, b1, w2, b2, s: 'TrunkShape',
                  assume_binary_obs: bool):
    """The plain version of the forward kernel, in the weights' dtype:
    (features, (pooled conv1 map, pool-1 codes, pool-2 codes)) over the
    cells the kernel computes and saves."""
    x = prepare_obs(x, w1.dtype, assume_binary_obs).permute(0, 3, 1, 2)
    p1, code1 = _pool_with_codes(F.conv2d(x, w1, b1, padding=1))
    p2, code2 = _pool_with_codes(F.conv2d(p1, w2, b2, padding=1))
    pooled = F.avg_pool2d(p2[:, :, :s.uh2, :s.uw2], (s.wh, s.ww))
    return (pooled.permute(0, 2, 3, 1).flatten(1),
            (p1[:, :, :s.uh1, :s.uw1], code1[:, :, :s.uh1, :s.uw1],
             code2[:, :, :s.uh2, :s.uw2]))


def backward_plain(gfeats: torch.Tensor, x: torch.Tensor, w2: torch.Tensor,
                   saved, s: 'TrunkShape', assume_binary_obs: bool):
    """The plain version of the backward kernel, in ``w2``'s dtype: (dw1,
    db1, dw2, db2) of the features' gradient, routed through the saved
    codes and pooled conv1 map alone, as the kernel routes it."""
    p1s, code1, code2 = saved
    dt = w2.dtype
    b, h1, w1 = x.shape[0], s.h // 2, s.w // 2
    p1 = p1s.new_zeros((b, C, h1, w1), dtype=dt)
    p1[:, :, :s.uh1, :s.uw1] = p1s
    g2 = gfeats.to(dt).view(b, s.ph, s.pw, C).permute(0, 3, 1, 2) / (
        s.wh * s.ww)
    g2 = g2.repeat_interleave(s.wh, 2).repeat_interleave(s.ww, 3)
    dc2 = _route(code2, g2, (h1, w1))
    dp1 = torch.nn.grad.conv2d_input(p1.shape, w2, dc2, padding=1)
    dc1 = _route(code1, dp1[:, :, :s.uh1, :s.uw1], (s.h, s.w))
    x = prepare_obs(x, dt, assume_binary_obs).permute(0, 3, 1, 2)
    return (torch.nn.grad.conv2d_weight(x, (C, s.cin, 3, 3), dc1, padding=1),
            dc1.sum((0, 2, 3)),
            torch.nn.grad.conv2d_weight(p1, (C, C, 3, 3), dc2, padding=1),
            dc2.sum((0, 2, 3)))


class TrunkShape(NamedTuple):
    """The cells of an h x w x cin input that the trunk computes."""
    h: int
    w: int
    cin: int
    uh1: int      # pool-1 cells conv2 reads (rows, columns)
    uw1: int
    uh2: int      # pool-2 cells the average pool reads
    uw2: int
    wh: int       # the average pool's window
    ww: int
    ph: int       # its output cells, after the crop
    pw: int

    @property
    def features(self) -> int:
        return self.ph * self.pw * C


def trunk_shape(h: int, w: int, cin: int) -> TrunkShape:
    h2, w2 = h // 2 // 2, w // 2 // 2
    wh, ww = max(h2 // 2, 1), max(w2 // 2, 1)
    ph, pw = min(h2 // wh, 2), min(w2 // ww, 2)
    uh2, uw2 = ph * wh, pw * ww
    return TrunkShape(h, w, cin, min(2 * uh2 + 1, h // 2),
                      min(2 * uw2 + 1, w // 2), uh2, uw2, wh, ww, ph, pw)


def _even(n: int) -> int:
    return n + (n & 1)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


KINDS = ('forward', 'w1', 'w2')   # the kernels that walk tiles of rows


class Layout(NamedTuple):
    """A launch's padded planes and shared-memory offsets (floats), as
    ``TrunkArgs`` carries them, for the three kernels that walk tiles of
    rows: the forward (``fwd['f_samples']`` floats of weights, then
    ``fwd['f_ss']`` floats a row), conv1's weight gradient (``w1['w1_ss']``
    floats a row: its obs planes, then two stages) and conv2's
    (``w2['w2_head']`` floats of each pool-2 window's cell of the features'
    gradient, a byte each, then ``w2['w2_ss']`` floats a row: two stages).
    The weight gradients' plane and cell strides are in ``bwd_planes``."""
    planes: dict
    fwd: dict
    w1: dict
    w2: dict
    bwd_planes: dict

    def head(self, kind: str) -> int:
        return {'forward': self.fwd['f_samples'], 'w1': 0,
                'w2': self.w2['w2_head']}[kind]

    def row(self, kind: str) -> int:
        return {'forward': self.fwd['f_ss'], 'w1': self.w1['w1_ss'],
                'w2': self.w2['w2_ss']}[kind]

    def bytes(self, kind: str, rows: int) -> int:
        return 4 * (self.head(kind) + rows * self.row(kind))

    def max_rows(self, kind: str) -> int:
        """The most rows a tile that fit one block; for the weight
        gradients, two blocks an SM where a row fits half of it, so that
        one block's copies and passes overlap the other's multiply-adds."""
        rows = (MAX_SMEM // 4 - self.head(kind)) // self.row(kind)
        if kind != 'forward':
            rows = (HALF_SMEM // 4 - self.head(kind)) // self.row(kind) or rows
        return rows


def distinct_banks(cs: int, rw: int) -> bool:
    """Whether the four cells a 2x2 window's code may name (0, 1, rw and
    rw + 1 cells from its first, ``cs`` floats a cell) start in four
    distinct groups of 4 of shared memory's 32 banks: a warp's 16-byte
    loads of one tap at those cells then meet in no bank."""
    offsets = [0, cs, rw * cs, (rw + 1) * cs]
    return all(4 <= (u - v) % 32 <= 28 for i, u in enumerate(offsets)
               for v in offsets[i + 1:])


def _cells(width: int, channels: int) -> Tuple[int, int]:
    """(cells a row, floats a cell) of padded planes laid out cell by cell,
    at least ``width`` cells a row and ``channels`` floats a cell in whole
    16-byte loads, whose window cells lie in distinct banks, in the fewest
    floats. (On an H100 the plain cell of round8(channels) floats, whose
    window cells share banks at 16 and 32 channels, made the backward 1.7x
    and 2.3x slower at 20x20; at 8 channels the two are the same.)"""
    best = None
    for cs in range(_round4(channels), _round4(channels) + 32, 4):
        rw = next((rw for rw in range(width, width + 8)
                   if distinct_banks(cs, rw)), None)
        if rw and (best is None or rw * cs < best[0] * best[1]):
            best = (rw, cs)
    return best


@functools.lru_cache(maxsize=None)
def layout(shape: TrunkShape) -> Layout:
    s = shape
    xh, xw = s.h + 2, _even(s.w + 2)
    p1h, p1w = s.uh1 + 2, _even(s.uw1 + 2)
    nq1, nq2 = s.uh1 * s.uw1, s.uh2 * s.uw2
    planes = dict(XH=xh, XW=xw, P1H=p1h, P1W=p1w)
    # forward: weights [cin][9][32], bias, [32][9][32], bias; then a row's
    # obs planes, pool-1 planes (both padded) and pool-2 cells
    f_x = 0
    f_p1 = f_x + _round4(s.cin * xh * xw)
    f_p2 = f_p1 + _round4(C * p1h * p1w)
    fwd = dict(f_w1=0, f_b1=s.cin * 9 * C, f_w2=s.cin * 9 * C + C,
               f_b2=(s.cin + C) * 9 * C + C, f_samples=(s.cin + C) * 9 * C
               + 2 * C, f_x=f_x, f_p1=f_p1, f_p2=f_p2,
               f_ss=f_p2 + _round4(C * nq2))
    # conv1's weight gradient: the obs' padded cells (the channels in whole
    # groups of GROUP, zero past cin), a row's planes, then two stages of
    # the raw uint8 obs where they come in whole words, the pool-1 gradient
    # [cell][32] and pool 1's codes as saved (a channel's windows in a run)
    xw_b, csx = _cells(s.w + 2, GROUP * -(-s.cin // GROUP))
    w1_d = _round4(s.h * s.w * s.cin // 4) if s.cin % 4 == 0 else 0
    w1_c1 = w1_d + nq1 * C
    w1_st = w1_c1 + _round4(-(-C * nq1 // 4))
    w1_x = _round4(xh * xw_b * csx)
    w1 = dict(w1_x=w1_x, w1_raw=0, w1_d=w1_d, w1_c1=w1_c1, w1_st=w1_st,
              w1_ss=w1_x + 2 * w1_st)
    # conv2's: each pool-2 window's cell of the features' gradient, then
    # two stages of a row's pooled conv1 map (padded planes read a lane a
    # plane: an odd stride), features' gradient, pool 2's codes as saved
    # and as [window][channel]
    p1w_b = s.uw1 + 2
    p1pp = (p1h * p1w_b) | 1
    w2_g2 = _round4(C * p1pp)
    w2_c2 = w2_g2 + _round4(s.features)
    w2_ct = w2_c2 + _round4(C * nq2 // 4)
    w2_st = w2_ct + _round4(C * nq2 // 4)
    w2 = dict(w2_head=_round4(-(-nq2 // 4)), w2_p1=0, w2_g2=w2_g2,
              w2_c2=w2_c2, w2_ct=w2_ct, w2_st=w2_st, w2_ss=2 * w2_st)
    bwd_planes = dict(b_p1w=p1w_b, b_p1pp=p1pp, b_xw=xw_b, b_csx=csx)
    return Layout(planes, fwd, w1, w2, bwd_planes)


def grads_size(cin: int) -> int:
    """Floats of dw1, db1, dw2, db2 together."""
    return C * cin * 9 + C + C * C * 9 + C


class Plan(NamedTuple):
    rows: int       # rows a tile (S)
    grid: int
    smem: int       # bytes
    scratch: int = 0  # floats of planes in device memory; 0: in shared


def plan(batch: int, kind: str, s: TrunkShape, sms: int,
         occupancy) -> Plan:
    """The rows a tile of the forward, or of conv1's or conv2's weight
    gradient (``kind``, one of ``KINDS``): the fewest that take no more
    rounds of the grid's blocks than the most rows that fit one block (so
    the last round is as full as the others: at 20x20 with 8 planes, 5
    rows a forward tile at B = 32,768 and 4 at 1,024). ``occupancy(smem,
    scratch)`` is the blocks an SM holds. Where one row's planes do not
    fit shared memory, a tile is one row and each block's planes lie in
    device memory."""
    lay = layout(s)
    head, ss = lay.head(kind), lay.row(kind)
    if lay.max_rows(kind) < 1:
        grid = min(batch, sms * max(occupancy(4 * head, True), 1))
        return Plan(1, grid, 4 * head, grid * ss)
    most = min(lay.max_rows(kind), batch)
    blocks = sms * max(occupancy(4 * (head + most * ss), False), 1)
    rounds = -(-batch // (blocks * most))
    rows = -(-batch // (blocks * rounds))
    smem = 4 * (head + rows * ss)
    grid = min(-(-batch // rows), sms * max(occupancy(smem, False), 1))
    return Plan(rows, grid, smem)


class PairPlan(NamedTuple):
    """The weight gradients' launch: ``pairs`` blocks of each
    convolution's (even blocks conv1's, odd ones conv2's), ``rows1`` and
    ``rows2`` rows a tile, ``smem`` bytes a block, and where a row's planes
    do not fit shared memory, each one's scratch in device memory
    (floats; 0: in shared memory)."""
    rows1: int
    rows2: int
    pairs: int
    smem: int
    scratch1: int = 0
    scratch2: int = 0


def plan_weight_grads(batch: int, s: TrunkShape, sms: int,
                      occupancy) -> PairPlan:
    """Each convolution's tile as ``plan`` takes it for one block of each
    an SM; as many pairs as the card holds at once (``occupancy(smem,
    scratch)`` blocks an SM, two a pair) and no more than both fill."""
    one = lambda smem, scratch: 1
    p1 = plan(batch, 'w1', s, sms, one)
    p2 = plan(batch, 'w2', s, sms, one)
    smem = max(p1.smem, p2.smem)
    pairs = min(p1.grid, p2.grid,
                sms * max(occupancy(smem, bool(p1.scratch or p2.scratch))
                          // 2, 1))
    lay = layout(s)
    return PairPlan(p1.rows, p2.rows, pairs, smem,
                    pairs * lay.row('w1') if p1.scratch else 0,
                    pairs * lay.row('w2') if p2.scratch else 0)


def plan_pool1(batch: int, sms: int, occupancy) -> Plan:
    """The pool-1 gradient's launch: a warp a row, as many blocks as the
    card holds at once and no more than the rows fill."""
    grid = min(-(-batch // BWD_WARPS),
               sms * max(occupancy(POOL1_SMEM, False), 1))
    return Plan(1, grid, POOL1_SMEM)


def check_trunk_args(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> TrunkShape:
    """The shape of what the kernel computes for obs ``x`` (B, H, W, Cin)
    uint8 or float32 and the float32 weights and biases of both
    convolutions in PyTorch's layouts; raises ``ValueError`` on a wrong
    dtype, shape or device and ``NotImplementedError`` on what the kernel
    does not take."""
    if x.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f'obs must be uint8 or float32, not {x.dtype}')
    if x.dim() != 4:
        raise ValueError(f'obs must be (B, H, W, C), not {tuple(x.shape)}')
    _, h, w, cin = x.shape
    want = {'conv1.weight': (w1, (C, cin, 3, 3)), 'conv1.bias': (b1, (C,)),
            'conv2.weight': (w2, (C, C, 3, 3)), 'conv2.bias': (b2, (C,))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, not {t.dtype}')
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} must be {shape}, not '
                             f'{tuple(t.shape)}')
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, obs on {x.device}')
    if h < 4 or w < 4:
        raise ValueError(f'the trunk needs an obs of at least 4x4, not '
                         f'{h}x{w}')
    _check_channels(cin)
    if x.requires_grad:
        raise NotImplementedError('the trunk kernel takes no gradient for '
                                  'the obs')
    return trunk_shape(h, w, cin)


def _check_channels(cin: int) -> None:
    if not 1 <= cin <= MAX_CIN:
        raise NotImplementedError(
            f'the trunk kernel takes 1 to {MAX_CIN} input channels, not '
            f'{cin} (frame_stack at most 8 of 8-plane frames); see '
            f'ROADMAP.md')


def check_served(in_channels: int, device: torch.device,
                 compute_dtype: torch.dtype) -> None:
    """Raises ``NotImplementedError`` where a net of ``in_channels``
    input planes would run its trunk on the kernel (float32 on a CUDA
    device) and the kernel does not take them: the net refuses to be
    built rather than fail at its first call."""
    if device.type == 'cuda' and compute_dtype == torch.float32:
        _check_channels(in_channels)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return bind_library(cuda_build.build(SOURCE)[0][0])


def bind_library(path: str) -> ctypes.CDLL:
    """The library at ``path`` with its entries' argument types set."""
    lib = ctypes.CDLL(path)
    lib.marlsnake_trunk_occupancy.argtypes = [ctypes.c_int] * 5
    lib.marlsnake_trunk_occupancy.restype = ctypes.c_int
    lib.marlsnake_trunk_forward.argtypes = [
        ctypes.POINTER(_TrunkArgs)] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.marlsnake_trunk_forward.restype = ctypes.c_int
    lib.marlsnake_trunk_backward.argtypes = [
        ctypes.POINTER(_TrunkArgs)] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.marlsnake_trunk_backward.restype = ctypes.c_int
    lib.marlsnake_trunk_error_string.argtypes = [ctypes.c_int]
    lib.marlsnake_trunk_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, kind: int, is_float: int, arg: int, smem: int,
               scratch: int) -> int:
    lib = load_library()
    with torch.cuda.device(index):
        n = lib.marlsnake_trunk_occupancy(kind, is_float, arg, int(scratch),
                                          smem)
    if n < 0:
        raise RuntimeError(f'ppo_trunk occupancy query failed: '
                           f'{lib.marlsnake_trunk_error_string(-n).decode()}')
    return n


@functools.lru_cache(maxsize=64)
def _plans(index: int, batch: int, s: TrunkShape, is_float: int,
           save: bool) -> Tuple[Plan, ...]:
    """The forward's plan, and where it saves, the backward's: the pool-1
    gradient's and the weight gradients'."""
    sms = _sm_count(index)
    fwd = plan(batch, 'forward', s, sms, functools.partial(
        _occupancy, index, 0, is_float, int(save)))
    if not save:
        return fwd, None, None
    lay = layout(s)
    scratch = int(lay.max_rows('w1') < 1) + 2 * int(lay.max_rows('w2') < 1)
    return (fwd,
            plan_pool1(batch, sms, functools.partial(_occupancy, index, 2,
                                                     0, 0)),
            plan_weight_grads(batch, s, sms, lambda smem, _: _occupancy(
                index, 1, is_float, s.cin, smem, scratch)))


def _args(s: TrunkShape, batch: int, rows: int, x: torch.Tensor,
          rows2: int = 0, **pointers) -> _TrunkArgs:
    lay = layout(s)
    # the obs read 4 channels a load where that keeps each load aligned
    vec4 = s.cin % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
    return _TrunkArgs(
        B=batch, H=s.h, W=s.w, Cin=s.cin, UH1=s.uh1, UW1=s.uw1, UH2=s.uh2,
        UW2=s.uw2, WH=s.wh, WW=s.ww, PH=s.ph, PW=s.pw, S=rows, S2=rows2,
        nw=grads_size(s.cin), vec4=int(vec4), x=x.data_ptr(), **lay.planes,
        **lay.fwd, **lay.w1, **lay.w2, **lay.bwd_planes,
        **{k: (None if v is None else v.data_ptr())
           for k, v in pointers.items()})


def _scratch(p: Plan, dev: torch.device) -> Optional[torch.Tensor]:
    """The blocks' planes in device memory where the plan has them
    there; the kernel zeroes what it reads before it writes."""
    if not p.scratch:
        return None
    return torch.empty(p.scratch, dtype=torch.float32, device=dev)


def launch_forward(x: torch.Tensor, divide: Optional[torch.Tensor],
                   w1, b1, w2, b2, s: TrunkShape, save: bool):
    """One launch of the forward on checked CUDA tensors (``x``
    contiguous): (features (B, F), (pooled conv1 map, pool-1 codes, pool-2
    codes) where ``save``, else Nones)."""
    dev, batch = x.device, x.shape[0]
    feats = torch.empty((batch, s.features), dtype=torch.float32, device=dev)
    saved = (None, None, None)
    if save:
        saved = (torch.empty((batch, C, s.uh1, s.uw1), dtype=torch.float32,
                             device=dev),
                 torch.empty((batch, C, s.uh1, s.uw1), dtype=torch.uint8,
                             device=dev),
                 torch.empty((batch, C, s.uh2, s.uw2), dtype=torch.uint8,
                             device=dev))
    if batch == 0:
        return feats, saved
    is_float = int(x.dtype == torch.float32)
    fwd = _plans(dev.index, batch, s, is_float, save)[0]
    scratch = _scratch(fwd, dev)
    args = _args(s, batch, fwd.rows, x, divide=divide, w1=w1, b1=b1,
                 w2=w2, b2=b2, feats=feats, p1=saved[0], code1=saved[1],
                 code2=saved[2], gfeats=None, dp1=None, partial=None,
                 grads=None, scratch=scratch, scratch2=None)
    lib = load_library()
    rc = cuda_build.on_current_stream(dev.index, lambda stream:
                                      lib.marlsnake_trunk_forward(
                                          ctypes.byref(args), is_float,
                                          fwd.grid, fwd.smem, stream))
    cuda_build.raise_on(rc, 'ppo_trunk forward',
                        lib.marlsnake_trunk_error_string)
    return feats, saved


def launch_backward(gfeats: torch.Tensor, x: torch.Tensor,
                    divide: Optional[torch.Tensor], w2_weight: torch.Tensor,
                    saved, s: TrunkShape) -> Tuple[torch.Tensor, ...]:
    """The backward of the features' gradient ``gfeats`` (B, F): one
    launch each of the pool-1 gradient, both convolutions' weight
    gradients and their reduction; (dw1, db1, dw2, db2)."""
    dev, batch = x.device, x.shape[0]
    is_float = int(x.dtype == torch.float32)
    _, pool1, wg = (_plans(dev.index, batch, s, is_float, True) if batch
                    else (None, Plan(1, 0, 0), PairPlan(1, 1, 0, 0)))
    nw = grads_size(s.cin)
    partial = torch.empty((max(wg.pairs, 1), nw), dtype=torch.float32,
                          device=dev)
    grads = torch.empty(nw, dtype=torch.float32, device=dev)
    dp1 = torch.empty((batch, s.uh1 * s.uw1, C), dtype=torch.float32,
                      device=dev)
    scratch = [torch.empty(n, dtype=torch.float32, device=dev) if n else None
               for n in (wg.scratch1, wg.scratch2)]
    p1, code1, code2 = saved
    args = _args(s, batch, wg.rows1, x, rows2=wg.rows2, divide=divide,
                 w1=None, b1=None, w2=w2_weight, b2=None, feats=None, p1=p1,
                 code1=code1, code2=code2, gfeats=gfeats, dp1=dp1,
                 partial=partial, grads=grads, scratch=scratch[0],
                 scratch2=scratch[1])
    lib = load_library()
    rc = cuda_build.on_current_stream(dev.index, lambda stream:
                                      lib.marlsnake_trunk_backward(
                                          ctypes.byref(args), is_float,
                                          pool1.grid, pool1.smem, wg.pairs,
                                          wg.smem, stream))
    cuda_build.raise_on(rc, 'ppo_trunk backward',
                        lib.marlsnake_trunk_error_string)
    n1 = C * s.cin * 9
    return (grads[:n1].view(C, s.cin, 3, 3), grads[n1:n1 + C],
            grads[n1 + C:n1 + C + C * C * 9].view(C, C, 3, 3),
            grads[n1 + C + C * C * 9:])


class _Trunk(torch.autograd.Function):
    """The kernel's forward, saving what its backward reads."""

    @staticmethod
    def forward(ctx, x, divide, w1, b1, w2, b2, s):
        feats, saved = launch_forward(x, divide, w1, b1, w2, b2, s, True)
        ctx.shape = s
        ctx.save_for_backward(x, divide, w2, *saved)
        return feats

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gfeats):
        x, divide, w2, *saved = ctx.saved_tensors
        grads = launch_backward(gfeats.contiguous(), x, divide, w2, saved,
                                ctx.shape)
        ppo_trunk.backward_launches += 1
        return (None, None) + grads + (None,)


def ppo_trunk(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              assume_binary_obs: bool) -> torch.Tensor:
    """The trunk's features (B, F) float32 of CUDA obs (B, H, W, Cin) or
    (H, W, Cin), uint8 or float32, by the kernel; differentiable in the
    weights and biases (``check_trunk_args`` says what it takes). Without
    ``assume_binary_obs`` the obs are divided by 255 where the batch's
    maximum exceeds 1, the test made on the device."""
    if x.dim() == 3:
        x = x[None]
    s = check_trunk_args(x, w1, b1, w2, b2)
    x = x.contiguous()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    divide = None
    if not assume_binary_obs and x.shape[0]:
        divide = x.max() > 1
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (w1, b1, w2, b2))
    if save:
        feats = _Trunk.apply(x, divide, w1, b1, w2, b2, s)
    else:
        feats = launch_forward(x, divide, w1, b1, w2, b2, s, False)[0]
    if x.shape[0]:
        ppo_trunk.launches += 1
    return feats


ppo_trunk.launches = 0
ppo_trunk.backward_launches = 0


def trunk(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
          w2: torch.Tensor, b2: torch.Tensor, compute_dtype: torch.dtype,
          assume_binary_obs: bool) -> torch.Tensor:
    """The trunk's features: ``ppo_trunk`` (the kernel) for float32 on a
    CUDA tensor, else ``trunk_plain``."""
    if x.device.type == 'cuda' and compute_dtype == torch.float32:
        return ppo_trunk(x, w1, b1, w2, b2, assume_binary_obs)
    return trunk_plain(x, w1, b1, w2, b2, compute_dtype, assume_binary_obs)
