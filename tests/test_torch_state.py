"""The 2-bit ring ops of marlsnake_torch.core.state are bit-exact against
marlsnake_tpu.core.state on random rings (words using all 32 bits, heads
including 0, random lengths and masks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.core import state as JS
from marlsnake_torch.core import state as TS

CAPS = [16, 64, 324]


def _random_ring(rng, rows, cap):
    cw = JS.ring_num_words(cap)
    ring = rng.integers(-2**31, 2**31, size=(rows, cw), dtype=np.int64
                        ).astype(np.int32)
    head = rng.integers(0, cap, size=rows).astype(np.int32)
    head[:3] = 0
    length = rng.integers(1, cap, size=rows).astype(np.int32)
    mask = rng.random(rows) < 0.6
    direction = rng.integers(0, 4, size=rows).astype(np.int32)
    return ring, head, length, mask, direction


def _eq(a, b, what):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize('cap', CAPS)
def test_ring_num_words_and_pack_prefix(cap):
    assert TS.ring_num_words(cap) == JS.ring_num_words(cap)
    rng = np.random.default_rng(cap)
    for length in (1, 2, 15, 16, 17, min(cap, 40)):
        dirs = rng.integers(0, 4, size=(5, 3, length)).astype(np.int32)
        _eq(JS.ring_pack_prefix(jnp.asarray(dirs), cap),
            TS.ring_pack_prefix(torch.as_tensor(dirs), cap),
            f'pack L={length}')


@pytest.mark.parametrize('cap', CAPS)
def test_ring_push_bit_exact(cap):
    rng = np.random.default_rng(1000 + cap)
    ring, head, length, mask, direction = _random_ring(rng, 64, cap)
    j = JS.ring_push(jnp.asarray(ring), jnp.asarray(head),
                     jnp.asarray(length), jnp.asarray(direction),
                     jnp.asarray(mask), cap)
    t = TS.ring_push(*(torch.as_tensor(x) for x in
                       (ring, head, length, direction, mask)), cap)
    for what, a, b in zip(('ring', 'ring_head', 'ring_len'), j, t):
        _eq(a, b, what)
    # batched (B, N, CW) layout gives the same words
    t3 = TS.ring_push(*(torch.as_tensor(x).view((8, 8) + x.shape[1:])
                        for x in (ring, head, length, direction, mask)),
                      cap)
    _eq(j[0], t3[0].reshape(64, -1), 'ring (B, N, CW)')


@pytest.mark.parametrize('cap', CAPS)
def test_ring_pop_tail_bit_exact(cap):
    rng = np.random.default_rng(2000 + cap)
    ring, head, length, mask, _ = _random_ring(rng, 64, cap)
    length[:4] = 0   # (head - 1) wraps below zero: floor-modulo
    j = JS.ring_pop_tail(jnp.asarray(ring), jnp.asarray(head),
                         jnp.asarray(length), jnp.asarray(mask), cap)
    t = TS.ring_pop_tail(*(torch.as_tensor(x) for x in
                           (ring, head, length, mask)), cap)
    _eq(j[0], t[0], 'popped')
    _eq(j[1], t[1], 'ring_len')


@pytest.mark.parametrize('cap', CAPS)
def test_ring_slots_and_tail_direction_bit_exact(cap):
    rng = np.random.default_rng(3000 + cap)
    ring, head, length, _, _ = _random_ring(rng, 64, cap)
    length[:4] = 0
    _eq(JS.ring_slots(jnp.asarray(ring), cap),
        TS.ring_slots(torch.as_tensor(ring), cap), 'slots')
    _eq(JS.tail_direction(jnp.asarray(ring), jnp.asarray(head),
                          jnp.asarray(length), cap),
        TS.tail_direction(*(torch.as_tensor(x) for x in
                            (ring, head, length)), cap), 'tail direction')
    # (B, N, CW) layout
    got = TS.tail_direction(*(torch.as_tensor(x).view((8, 8) + x.shape[1:])
                              for x in (ring, head, length)), cap)
    assert got.shape == (8, 8)


def test_body_masks_lengths_cells_and_rewards_match_jax():
    """``body_coords_mask`` and ``body_length`` of envs after random
    steps (some snakes dead), ``pack_cell`` and ``EnvConfig.reward``:
    EQUAL to JAX's."""
    import jax
    from marlsnake_tpu.core import types as JT
    from marlsnake_tpu.envs.vector import build_vector_fns
    from marlsnake_torch.core import types as TT
    from test_torch_engine import configs, state_from_jax
    jcfg, cfg = configs(height=10, width=10, num_snakes=3, snake_length=3,
                        rewards=(2.0, 3.0, -4.0, 5.0, -0.25))
    reset_fn, step_fn = build_vector_fns(jcfg, autoreset=False)
    jstates, _ = jax.jit(reset_fn)(jax.random.split(jax.random.key(0), 4))
    rng = np.random.default_rng(0)
    step = jax.jit(step_fn)
    for _ in range(8):
        jstates, _ = step(jstates, jnp.asarray(rng.integers(0, 3, (4, 3)),
                                               dtype=jnp.int32))
    states = state_from_jax(jstates)
    assert not np.asarray(jstates.alive).all()
    _eq(jstates.body_length, states.body_length, 'body_length')
    for i in range(3):
        want = jax.vmap(lambda s: JS.body_coords_mask(s, i))(jstates)
        _eq(want, TS.body_coords_mask(states, i), f'body of snake {i}')
    for ctype in range(6):
        for owner in (0, 1, 7):
            assert TT.pack_cell(ctype, owner) == JT.pack_cell(ctype, owner)
    cells = np.arange(6)[:, None] + 0 * np.arange(4)
    _eq(JT.pack_cell(jnp.asarray(cells), jnp.arange(4)),
        TT.pack_cell(torch.as_tensor(cells, dtype=torch.int32),
                     torch.arange(4, dtype=torch.int32)), 'pack_cell')
    for name in TT.REWARD_KEYS:
        assert cfg.reward(name) == jcfg.reward(name)
    with pytest.raises(ValueError):
        cfg.reward('bonus')
