"""marlsnake_torch.algo.replay against marlsnake_tpu.algo.replay.

The same transitions, masks and random numbers (made with numpy, or drawn
from the JAX side's own keys) go through both rings. Tolerance: none.
Every field of the ring, ``ptr``, ``size`` and every sampled row must be
EQUAL: a push is a scatter and a sample a gather of the same bytes. The
port's ring has one spare row behind its ``capacity`` rows, which takes
the masked-out writes and is left out of the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo import replay as JR
from marlsnake_torch.algo import replay as TR

OBS_SHAPE = (4, 3, 8)


def _t(x):
    return torch.as_tensor(np.array(x))


def assert_rings_equal(jbuf, buf, where=''):
    cap = jbuf.capacity
    assert buf.capacity == cap and buf.obs_shape == jbuf.obs_shape
    for name, t in buf.fields():
        want = np.asarray(getattr(jbuf, name))
        got = t.numpy() if t.dim() == 0 else t.numpy()[:cap]
        assert got.dtype == want.dtype, (where, name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f'{name} {where}')


def transitions(rng, n):
    obs = (rng.random((n,) + OBS_SHAPE) < 0.3).astype(np.uint8)
    nxt = (rng.random((n,) + OBS_SHAPE) < 0.3).astype(np.uint8)
    return (obs, rng.integers(0, 3, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32), nxt, rng.random(n) < 0.3)


def push_both(jbuf, buf, rows, mask):
    jbuf = JR.push(jbuf, *map(jnp.asarray, rows),
                   mask=None if mask is None else jnp.asarray(mask))
    buf = TR.push(buf, *map(_t, rows),
                  mask=None if mask is None else _t(mask))
    return jbuf, buf


def filled(cap, pushes, seed):
    """Both rings after ``pushes`` masked pushes of 6 rows."""
    rng = np.random.default_rng(seed)
    jbuf, buf = JR.create(cap, OBS_SHAPE), TR.create(cap, OBS_SHAPE, 'cpu')
    for _ in range(pushes):
        jbuf, buf = push_both(jbuf, buf, transitions(rng, 6),
                              rng.random(6) < 0.7)
    return jbuf, buf


def test_create_matches_jax():
    jbuf, buf = JR.create(10, OBS_SHAPE), TR.create(10, OBS_SHAPE, 'cpu')
    assert buf.obs.shape == (11, 4 * 3 * 8) and buf.next_obs.shape == (11, 96)
    assert_rings_equal(jbuf, buf, 'create')


@pytest.mark.parametrize('masked', [False, True], ids=['all', 'masked'])
def test_push_wraps_like_jax(masked):
    """Pushes of 6 rows into a ring of 16: the ring wraps twice; with a
    mask, only the active rows take slots and the rest are dropped."""
    rng = np.random.default_rng(int(masked))
    jbuf, buf = JR.create(16, OBS_SHAPE), TR.create(16, OBS_SHAPE, 'cpu')
    for i in range(7):
        mask = rng.random(6) < 0.6 if masked else None
        if masked and i == 3:
            mask = np.zeros(6, bool)            # a push of nothing
        jbuf, buf = push_both(jbuf, buf, transitions(rng, 6), mask)
        assert_rings_equal(jbuf, buf, f'push {i}')
    assert int(buf.size) == 16 and 0 <= int(buf.ptr) < 16


def test_push_is_in_place_and_spares_the_last_row_for_dropped_writes():
    rng = np.random.default_rng(3)
    buf = TR.create(8, OBS_SHAPE, 'cpu')
    rows = transitions(rng, 5)
    mask = np.array([True, False, True, False, False])
    same = TR.push(buf, *map(_t, rows), mask=_t(mask))
    assert same is buf and int(buf.size) == 2 and int(buf.ptr) == 2
    np.testing.assert_array_equal(buf.action[:2].numpy(), rows[1][mask])
    assert not buf.obs[2:8].any()               # untouched slots
    assert buf.ptr.dtype == torch.int32 and buf.size.dtype == torch.int32


@pytest.mark.parametrize('pushes,batch', [(1, 8), (2, 8), (6, 8), (6, 16)],
                         ids=['size<batch', 'partly-filled', 'full',
                              'batch=cap'])
def test_sample_without_replacement_matches_jax(pushes, batch):
    """The JAX sample's own sort keys, ``uniform(key, (cap,))``, handed to
    the port: the same rows come out in the same order, also while fewer
    slots than ``batch`` are filled (the indices wrap by ``% size``)."""
    jbuf, buf = filled(16, pushes, seed=pushes)
    for k in range(3):
        key = jax.random.key(100 + k)
        want = JR.sample(jbuf, key, batch)
        got = TR.sample(buf, batch, _t(jax.random.uniform(key, (16,))))
        for name, w, g in zip(('obs', 'action', 'reward', 'next_obs',
                               'done'), want, got):
            assert g.shape == w.shape and g.numpy().dtype == w.dtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    if int(buf.size) >= batch:
        idx = TR.sample_indices(buf, batch, torch.rand(16))
        assert len(set(idx.tolist())) == batch  # distinct slots


@pytest.mark.parametrize('pushes,batch', [(1, 8), (6, 8), (6, 40)],
                         ids=['size<batch', 'full', 'batch>cap'])
def test_sample_with_replacement_matches_jax(pushes, batch):
    """With replacement (and always when the batch exceeds the ring) JAX
    draws ``randint(key, (batch,), 0, max(size, 1))``; given those indices
    the port gathers the same rows."""
    jbuf, buf = filled(16, pushes, seed=10 + pushes)
    key = jax.random.key(7)
    want = JR.sample(jbuf, key, batch, replace=True)
    idx = jax.random.randint(key, (batch,), 0,
                             jnp.maximum(jbuf.size, 1))
    got = TR.sample(buf, batch, idx=_t(idx))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('pushes', [0, 1, 6], ids=['empty', 'partly',
                                                   'full'])
def test_own_draws_with_replacement_stay_inside_the_filled_slots(pushes):
    _, buf = filled(16, pushes, seed=20 + pushes)
    u = torch.cat([torch.rand(38), torch.tensor([0.0, 0.99999994])])
    for replace, batch in ((True, 8), (False, 40)):
        idx = TR.sample_indices(buf, batch, u, replace=replace)
        assert idx.shape == (batch,)
        assert int(idx.min()) >= 0
        assert int(idx.max()) < max(int(buf.size), 1)
    rows = TR.sample(buf, 40, u)
    assert rows[0].shape == (40,) + OBS_SHAPE and rows[0].dtype == torch.uint8
