"""The observation encoders of marlsnake_torch against marlsnake_tpu's:
packed bytes, the vision window, the frame stack. Byte work: every
comparison is exact (tolerance 0)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.core import engine as JE
from marlsnake_tpu.ops import obs_pack as JP
from marlsnake_torch.core import engine as TE
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.ops import obs_pack as TP
from test_torch_engine import _random_grid, _t, configs


@pytest.mark.parametrize('fs', [1, 4])
def test_pack_and_unpack_parity(fs):
    rng = np.random.default_rng(fs)
    frame = (rng.random((3, 2, 6, 5, 8)) < 0.3).astype(np.uint8)
    got = TP.pack_frame(_t(frame))
    assert got.dtype == torch.uint8 and got.shape == (3, 2, 6, 5, 1)
    np.testing.assert_array_equal(np.asarray(JP.pack_frame(jnp.asarray(frame))),
                                  got.numpy())
    packed = rng.integers(0, 256, size=(3, 2, 6, 5, fs), dtype=np.uint8)
    unpacked = TP.unpack_obs(_t(packed))
    assert unpacked.dtype == torch.uint8
    assert unpacked.shape == (3, 2, 6, 5, 8 * fs)
    np.testing.assert_array_equal(
        np.asarray(JP.unpack_obs(jnp.asarray(packed))), unpacked.numpy())
    # bit c of frame f's byte is channel f * 8 + c
    for f in range(fs):
        for c in range(8):
            assert torch.equal(unpacked[..., f * 8 + c],
                               (_t(packed)[..., f] >> c) & 1)
    assert torch.equal(TP.unpack_obs(got), _t(frame))


@pytest.mark.parametrize('n', [2, 4])
def test_encode_frame_packed_parity(n):
    jcfg, cfg = configs(height=12, width=9, num_snakes=n)
    grid = _random_grid(np.random.default_rng(n), 6, 12, 9, n)
    want = jax.vmap(functools.partial(JE.encode_frame_packed, jcfg))(
        jnp.asarray(grid))
    got = TE.encode_frame_packed(cfg, _t(grid))
    assert got.dtype == torch.uint8 and got.shape == (6, n, 12, 9, 1)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert torch.equal(got, TP.pack_frame(TE.encode_frame(cfg, _t(grid))))


@pytest.mark.parametrize('v,n', [(2, 2), (5, 4), (3, 17)])
def test_encode_frame_cropped_parity(v, n):
    """Heads at the border and in a corner (the window leaves the grid), a
    dead snake (anchored at (0, 0)); n = 17 takes the JAX package's second
    gather path, for which the port has no separate code."""
    h, w = 12, 9
    jcfg, cfg = configs(height=h, width=w, num_snakes=n, vision_range=v)
    rng = np.random.default_rng(v)
    b = 6
    grid = _random_grid(rng, b, h, w, n)
    head = np.stack([rng.integers(0, h, size=(b, n)),
                     rng.integers(0, w, size=(b, n))], -1).astype(np.int32)
    head[0, 0] = (0, 0)
    head[1, 0] = (h - 1, w - 1)
    head[2, 1] = (5, 0)
    alive = rng.random((b, n)) < 0.7
    alive[:3] = True
    alive[3, 0] = False
    want = jax.jit(jax.vmap(functools.partial(JE.encode_frame_cropped, jcfg)))(
        jnp.asarray(grid), jnp.asarray(head), jnp.asarray(alive))
    got = TE.encode_frame_cropped(cfg, _t(grid), _t(head), _t(alive))
    assert got.dtype == torch.uint8
    assert got.shape == (b, n, 2 * v + 1, 2 * v + 1, 8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # the dead snake sees the window around (0, 0)
    moved = head.copy()
    moved[3, 0] = (0, 0)
    again = TE.encode_frame_cropped(cfg, _t(grid), _t(moved), _t(alive))
    assert torch.equal(again[3, 0], got[3, 0])
    # the window's centre is the head's own cell; outside the grid is zero
    centre = TE.encode_frame(cfg, _t(grid))[1, 0, h - 1, w - 1]
    assert torch.equal(got[1, 0, v, v], centre)
    assert not bool(got[1, 0, v + 1:].any())
    assert not bool(got[1, 0, :, v + 1:].any())


@pytest.mark.parametrize('c', [8, 1])
def test_stack_to_obs_parity(c):
    rng = np.random.default_rng(c)
    stack = rng.integers(0, 256 if c == 1 else 2, size=(5, 3, 2, 4, 6, c),
                         dtype=np.uint8)
    want = jax.vmap(JE.stack_to_obs)(jnp.asarray(stack))
    got = TE.stack_to_obs(_t(stack))
    assert got.shape == (5, 2, 4, 6, 3 * c)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # frame-major channels, oldest first
    for f in range(3):
        assert torch.equal(got[..., f * c:(f + 1) * c], _t(stack)[:, f])


@pytest.mark.parametrize('kwargs,shape', [
    (dict(obs_format='packed'), (2, 10, 10, 1)),
    (dict(frame_stack=4), (2, 10, 10, 32)),
    (dict(frame_stack=4, obs_format='packed'), (2, 10, 10, 4)),
    (dict(vision_range=3), (2, 7, 7, 8)),
    (dict(vision_range=5, frame_stack=2), (2, 11, 11, 16)),
    (dict(vision_range=5, frame_stack=2, obs_format='packed'),
     (2, 11, 11, 2))])
def test_obs_shapes_and_history_fields(kwargs, shape):
    from marlsnake_torch.rng import reset_draws
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3,
                    **kwargs)
    assert cfg.obs_shape == shape
    gen = torch.Generator().manual_seed(0)
    state, obs = TE.reset(cfg, TE.spawn_tables(cfg, 'cpu'),
                          reset_draws(cfg, 3, gen, 'cpu'))
    assert obs.shape == (3,) + shape and obs.dtype == torch.uint8
    fs, vision = cfg.frame_stack, bool(cfg.vision_range)
    assert state.hist_grid.shape == (
        3, fs - 1 if fs > 1 and not vision else 0, 10, 10)
    assert state.obs_stack.shape == (
        3, fs if fs > 1 and vision else 0, 2) + shape[1:3] + (
            cfg.frame_channels,)
    # a fresh env's history is its own grid, its stack its first frame
    for i in range(state.hist_grid.shape[1]):
        assert torch.equal(state.hist_grid[:, i], state.grid)
    for f in range(state.obs_stack.shape[1]):
        assert torch.equal(state.obs_stack[:, f], state.obs_stack[:, 0])
    c = cfg.frame_channels
    for f in range(1, fs):
        assert torch.equal(obs[..., f * c:(f + 1) * c], obs[..., :c])
