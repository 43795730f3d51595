"""marlsnake_torch.core.engine against marlsnake_tpu.core.engine, for
every option of ``EnvConfig``: pool and procedural spawn, uint8 and packed
obs, the frame stack (raw-grid history and stored window frames) and the
vision window.

Both sides get the same random numbers: the JAX side derives them from
its keys, and the port takes exactly those draws (the numbers the Pallas
launcher precomputes, pallas_step.py:378-395). Int, bool and uint8 fields
must be equal; float fields within atol 1e-5 (both sides do the same
IEEE float32 operations in the same order; the tolerance is that of
tests/test_pallas_step.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.core import engine as JE
from marlsnake_tpu.core.spawn import SpawnData, spawn_data
from marlsnake_tpu.core.types import EnvConfig as JConfig
from marlsnake_torch.core import engine as TE
from marlsnake_torch.core.state import EnvState
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.rng import ResetDraws, StepDraws

RESET_SALT = 0x5EED


# --- helpers shared with test_torch_slice.py -------------------------------

def configs(**kwargs):
    """The same config in both packages."""
    return JConfig(**kwargs), EnvConfig(**kwargs)


def jax_spawn(jcfg):
    if jcfg.spawn_mode == 'procedural':
        return None
    sd = spawn_data(jcfg.height, jcfg.width, jcfg.snake_length,
                    jcfg.num_snakes, pool_size=jcfg.spawn_pool_size)
    return SpawnData(jnp.asarray(sd.cells),
                     None if sd.blob is None else jnp.asarray(sd.blob))


def _t(x):
    return torch.as_tensor(np.array(x))


@functools.lru_cache(maxsize=None)
def _reset_draw_fn(nf, spawn_shape=()):
    """``spawn_shape`` is () for the pool row and (N, 4) for the
    procedural spawn (engine.py:460,580)."""
    def draws(keys):
        spawn_u = jax.vmap(lambda k: jax.random.uniform(
            jax.random.fold_in(k, 0), spawn_shape))(keys)
        fruit_u = jax.vmap(lambda k: jax.random.uniform(
            jax.random.fold_in(k, 1), (nf,)))(keys)
        return spawn_u, fruit_u
    return jax.jit(draws)


def _spawn_shape(cfg):
    return (cfg.num_snakes, 4) if cfg.spawn_mode == 'procedural' else ()


@functools.lru_cache(maxsize=None)
def _step_draw_fn(n, nf, spawn_shape=()):
    def draws(keys):
        split = jax.vmap(jax.random.split)(keys)
        new_keys, k_fruit = split[:, 0], split[:, 1]
        fruit_u = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(k_fruit)
        rkey = jax.vmap(lambda k: jax.random.fold_in(k, RESET_SALT))(
            new_keys)
        spawn_u, rfruit_u = _reset_draw_fn(nf, spawn_shape)(rkey)
        return fruit_u, spawn_u, rfruit_u
    return jax.jit(draws)


def reset_draws_from_keys(cfg, keys) -> ResetDraws:
    """The draws JAX's reset takes from ``keys`` (engine.py:575-586,637)."""
    return ResetDraws(*map(_t, _reset_draw_fn(
        cfg.resolved_num_fruits, _spawn_shape(cfg))(keys)))


def step_draws_from_keys(cfg, keys) -> StepDraws:
    """The draws JAX's step_autoreset takes from the state keys."""
    return StepDraws(*map(_t, _step_draw_fn(
        cfg.num_snakes, cfg.resolved_num_fruits, _spawn_shape(cfg))(keys)))


def state_from_jax(jstate) -> EnvState:
    """A (batched) JAX ``EnvState`` as the port's: every field the port
    has, ``hist_grid`` and ``obs_stack`` included, through numpy. The JAX
    state's ``key`` has no counterpart (the port takes draws)."""
    return EnvState(**{f.name: _t(getattr(jstate, f.name))
                       for f in dataclasses.fields(EnvState)})


def assert_fields_equal(jobj, tobj, where):
    for name, t in tobj.fields():
        a, b = np.asarray(getattr(jobj, name)), t.numpy()
        assert a.dtype == b.dtype, (where, name, a.dtype, b.dtype)
        assert a.shape == b.shape, (where, name, a.shape, b.shape)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                       err_msg=f'{name} {where}')
        else:
            np.testing.assert_array_equal(a, b, err_msg=f'{name} {where}')


def jax_reset(jcfg, spawn, keys):
    return jax.jit(jax.vmap(functools.partial(JE.reset, jcfg, spawn)))(keys)


@functools.lru_cache(maxsize=None)
def jax_step_autoreset(jcfg):
    return jax.jit(jax.vmap(functools.partial(
        JE.step_autoreset, jcfg, jax_spawn(jcfg), reset_salt=RESET_SALT)))


# --- unit parity -----------------------------------------------------------

def _random_grid(rng, b, h, w, n):
    """Boards with walls, fruits, empties and snake cells of owners < n."""
    t = rng.choice([0, 0, 0, 1, 2, 3, 4, 5], size=(b, h, w))
    owner = rng.integers(0, n, size=(b, h, w))
    return np.where(t >= 3, t | (owner << 4), t).astype(np.int32)


@pytest.mark.parametrize('h,w', [(10, 10), (20, 20), (40, 40)])
def test_place_fruits_parity(h, w):
    """All three prefix-sum forms of the JAX engine (bf16 / f32 matmul and
    cumsum, by board size) against the port's exact int32 count."""
    rng = np.random.default_rng(h)
    b, k = 16, 5
    grid = _random_grid(rng, b, h, w, 4)
    grid[0] = 1                                   # no empty cell
    u = rng.random((b, k), dtype=np.float32)
    u[1] = np.float32(1.0) - np.finfo(np.float32).epsneg
    count = rng.integers(0, k + 1, size=b).astype(np.int32)
    want = jax.jit(jax.vmap(JE.place_fruits))(
        jnp.asarray(grid), jnp.asarray(u), jnp.asarray(count))
    got = TE.place_fruits(_t(grid), _t(u), _t(count))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_make_empty_grid_parity():
    layout = ('#######', '#.....#', '#..#..#', '#.....#', '#######')
    for kwargs in (dict(height=9, width=12), dict(map_layout=layout)):
        jcfg, cfg = configs(**kwargs)
        got = TE.make_empty_grid(cfg, 'cpu')
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(JE.make_empty_grid(jcfg)),
                                      got.numpy())


@pytest.mark.parametrize('n', [2, 4])
def test_encode_frame_parity(n):
    jcfg, cfg = configs(height=12, width=9, num_snakes=n)
    grid = _random_grid(np.random.default_rng(n), 6, 12, 9, n)
    want = jax.vmap(functools.partial(JE.encode_frame, jcfg))(
        jnp.asarray(grid))
    got = TE.encode_frame(cfg, _t(grid))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize('h,w,n', [(10, 10, 2), (20, 20, 4)])
def test_reset_parity(h, w, n):
    jcfg, cfg = configs(height=h, width=w, num_snakes=n, snake_length=3)
    keys = jax.random.split(jax.random.key(h + n), 16)
    jstate, jobs = jax_reset(jcfg, jax_spawn(jcfg), keys)
    state, obs = TE.reset(cfg, TE.spawn_tables(cfg, 'cpu'),
                          reset_draws_from_keys(cfg, keys))
    assert_fields_equal(jstate, state, 'reset')
    np.testing.assert_array_equal(np.asarray(jobs), obs.numpy())


# --- multi-step step_autoreset parity ---------------------------------------

def run_autoreset_parity(seed, steps, b=8, **cfg_kwargs):
    """Step both engines ``steps`` times with the same actions and draws,
    comparing every state field (``hist_grid`` and ``obs_stack`` too) and
    output each step; returns the number of auto-resets seen."""
    jcfg, cfg = configs(**cfg_kwargs)
    keys = jax.random.split(jax.random.key(seed), b)
    jstate, jobs = jax_reset(jcfg, jax_spawn(jcfg), keys)
    tables = TE.spawn_tables(cfg, 'cpu')
    state, obs = TE.reset(cfg, tables, reset_draws_from_keys(cfg, keys))
    assert_fields_equal(jstate, state, 'reset')
    np.testing.assert_array_equal(np.asarray(jobs), obs.numpy())
    jstep = jax_step_autoreset(jcfg)
    rng = np.random.default_rng(seed)
    resets = 0
    for t in range(steps):
        actions = rng.integers(0, cfg.num_actions,
                               size=(b, cfg.num_snakes)).astype(np.int32)
        draws = step_draws_from_keys(cfg, jstate.key)
        jstate, jout = jstep(jstate, jnp.asarray(actions))
        state, out = TE.step_autoreset(cfg, tables, state, _t(actions),
                                       draws)
        assert_fields_equal(jstate, state, f'state t={t}')
        assert_fields_equal(jout, out, f'out t={t}')
        resets += int(out.done_all.sum())
    return resets


@pytest.mark.parametrize('case', [
    dict(seed=0, steps=30, height=10, width=10, num_snakes=2,
         snake_length=3),
    dict(seed=1, steps=30, height=10, width=10, num_snakes=2,
         snake_length=3, done_mode='any'),
    dict(seed=2, steps=12, height=20, width=20, num_snakes=4,
         snake_length=3, max_episode_steps=6),
], ids=['10x10x2', '10x10x2-any', '20x20x4'])
def test_step_autoreset_multistep_parity(case):
    assert run_autoreset_parity(**case) > 0, 'no auto-reset happened'


SMALL = dict(height=10, width=10, num_snakes=2, snake_length=3)
# one case an option, and combinations; episodes are cut short so that
# every run resets often
OPTIONS = {
    'procedural': dict(spawn_mode='procedural'),
    'procedural-both': dict(spawn_mode='procedural',
                            spawn_orientations='both'),
    'packed': dict(obs_format='packed'),
    'stack2': dict(frame_stack=2),
    'stack4-packed': dict(frame_stack=4, obs_format='packed'),
    'vision3': dict(vision_range=3),
    'vision5-stack2': dict(vision_range=5, frame_stack=2),
    'all': dict(vision_range=2, frame_stack=3, obs_format='packed',
                spawn_mode='procedural', spawn_orientations='both',
                done_mode='any'),
}


@pytest.mark.parametrize('name', list(OPTIONS))
def test_step_autoreset_options_multistep_parity(name):
    resets = run_autoreset_parity(seed=3, steps=25, max_episode_steps=9,
                                  **SMALL, **OPTIONS[name])
    assert resets > 8, 'too few auto-resets'


def run_step_parity(seed, steps, b=8, **cfg_kwargs):
    """engine.step (no auto-reset) with JAX's own fruit draws, from a JAX
    reset state carried over with ``state_from_jax``; finished envs go on
    being stepped. Returns the number of env steps taken after the end."""
    jcfg, cfg = configs(**cfg_kwargs)
    keys = jax.random.split(jax.random.key(seed), b)
    jstate, _ = jax_reset(jcfg, jax_spawn(jcfg), keys)
    state = state_from_jax(jstate)
    jstep = jax.jit(jax.vmap(functools.partial(JE.step, jcfg)))
    rng = np.random.default_rng(seed)
    after = 0
    for t in range(steps):
        actions = rng.integers(0, cfg.num_actions,
                               size=(b, cfg.num_snakes)).astype(np.int32)
        fruit_u = step_draws_from_keys(cfg, jstate.key).fruit_u
        after += int((~state.alive.any(1)).sum())
        jstate, jout = jstep(jstate, jnp.asarray(actions))
        state, out = TE.step(cfg, state, _t(actions), fruit_u)
        assert_fields_equal(jstate, state, f'state t={t}')
        assert_fields_equal(jout, out, f'out t={t}')
    return after


def test_plain_step_parity():
    """engine.step (no auto-reset) with JAX's own fruit draws."""
    run_step_parity(seed=5, steps=12, **SMALL)


@pytest.mark.parametrize('name', list(OPTIONS))
def test_plain_step_options_multistep_parity(name):
    assert run_step_parity(seed=6, steps=30, **SMALL, **OPTIONS[name]) > 0


def test_state_from_jax_carries_every_field():
    jcfg, cfg = configs(**SMALL, frame_stack=3)
    keys = jax.random.split(jax.random.key(1), 4)
    jstate, _ = jax_reset(jcfg, jax_spawn(jcfg), keys)
    state = state_from_jax(jstate)
    assert_fields_equal(jstate, state, 'carried')
    assert state.hist_grid.shape == (4, 2, 10, 10)
    assert state.obs_stack.shape == (4, 0, 2, 10, 10, 8)
    assert [n for n, _ in state.fields()][-2:] == ['hist_grid', 'obs_stack']
    assert {f.name for f in dataclasses.fields(jstate)} - {
        n for n, _ in state.fields()} == {'key'}


@pytest.mark.parametrize('name', ['stack4-packed', 'vision5-stack2'])
def test_held_envs_keep_their_history(name):
    """``step`` with ``hold``: a held env's ``hist_grid``, ``obs_stack``
    and obs stay as they were while the others roll on."""
    cfg = EnvConfig(**SMALL, **OPTIONS[name])
    gen = torch.Generator().manual_seed(2)
    from marlsnake_torch.rng import reset_draws
    state, _ = TE.reset(cfg, TE.spawn_tables(cfg, 'cpu'),
                        reset_draws(cfg, 6, gen, 'cpu'))
    out = None
    keep = torch.tensor([True, False, True, False, False, True])
    for t in range(4):
        actions = torch.randint(0, 3, (6, 2), generator=gen)
        fruit_u = torch.rand((6, 2), generator=gen)
        hold = (keep, out) if t > 0 else None
        new_state, new_out = step_kernel.step(cfg, state, actions, fruit_u,
                                              hold)
        if t > 0:
            for a, b in ((new_state.hist_grid, state.hist_grid),
                         (new_state.obs_stack, state.obs_stack),
                         (new_out.obs, out.obs)):
                assert torch.equal(a[keep], b[keep])
            moved = (new_state.hist_grid if cfg.hist_mode
                     else new_state.obs_stack)
            before = state.hist_grid if cfg.hist_mode else state.obs_stack
            assert not torch.equal(moved[~keep], before[~keep])
        state, out = new_state, new_out


# --- the kernel wrapper ------------------------------------------------------

def test_step_kernel_wrapper_on_cpu_is_the_plain_version():
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3)
    tables = TE.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(0)
    env = VectorSnakeEnv(cfg, 6, device='cpu', seed=0)
    state, _ = env.reset()
    before = step_kernel.step_autoreset.launches
    for _ in range(10):
        actions = torch.randint(0, 3, (6, 2), generator=gen)
        draws = StepDraws(torch.rand((6, 2), generator=gen),
                          torch.rand((6,), generator=gen),
                          torch.rand((6, 2), generator=gen))
        got = step_kernel.step_autoreset(cfg, tables, state, actions, draws)
        want = TE.step_autoreset(cfg, tables, state, actions, draws)
        for g, w in zip(got, want):
            for (name, a), (_, b) in zip(g.fields(), w.fields()):
                assert torch.equal(a, b), name
        state = got[0]
    assert step_kernel.step_autoreset.launches == before


@pytest.mark.parametrize('kwargs', [
    dict(frame_stack=2), dict(frame_stack=4), dict(vision_range=3),
    dict(vision_range=5), dict(obs_format='packed'),
    dict(spawn_mode='procedural'),
    dict(spawn_mode='procedural', spawn_orientations='both'),
    dict(vision_range=3, frame_stack=4, obs_format='packed',
         spawn_mode='procedural')])
def test_every_option_constructs_and_runs_on_the_cpu(kwargs):
    """What ``check_port_scope`` used to refuse: each option runs through
    the wrapper (the plain version, on CPU tensors) without a launch."""
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3,
                    **kwargs)
    env = VectorSnakeEnv(cfg, 3, device='cpu', seed=1)
    assert env.obs_shape == (3,) + cfg.obs_shape
    state, obs = env.reset()
    before = step_kernel.step_autoreset.launches
    for _ in range(3):
        state, out = env.step(state, torch.zeros((3, 2), dtype=torch.int32))
    assert out.obs.shape == obs.shape == env.obs_shape
    assert out.obs.dtype == torch.uint8
    assert step_kernel.step_autoreset.launches == before
    tables = TE.spawn_tables(cfg, 'cpu')
    assert (tables is None) == (cfg.spawn_mode == 'procedural')


def test_kernel_limits_and_pool_size_checks():
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3)
    small_pool = TE.spawn_tables(
        EnvConfig(height=10, width=10, num_snakes=2, snake_length=3,
                  spawn_pool_size=64), 'cpu')
    with pytest.raises(ValueError):
        step_kernel.step_autoreset(cfg, small_pool, None, None, None)
    with pytest.raises(ValueError, match='no spawn tables'):
        step_kernel.step_autoreset(
            EnvConfig(height=10, width=10, num_snakes=2, snake_length=3,
                      spawn_mode='procedural'), small_pool, None, None, None)
    # the history lives in global memory: a frame stack asks for no more
    # shared memory than the single frame
    assert step_kernel.smem_per_env(EnvConfig(frame_stack=4)) \
        == step_kernel.smem_per_env(EnvConfig())
    step_kernel._check_kernel_limits(
        EnvConfig(height=80, width=80, frame_stack=4, vision_range=5))
    step_kernel._check_kernel_limits(EnvConfig())
    # one warp per env: an 80x80 board's grid and rings (31,696 bytes)
    # fit one block's shared memory
    step_kernel._check_kernel_limits(EnvConfig(height=80, width=80))
    with pytest.raises(NotImplementedError):
        step_kernel._check_kernel_limits(
            EnvConfig(height=40, width=40, num_snakes=33))
    with pytest.raises(NotImplementedError):
        step_kernel._check_kernel_limits(
            EnvConfig(height=40, width=40, num_snakes=8, num_fruits=33))
    with pytest.raises(NotImplementedError):
        step_kernel._check_kernel_limits(EnvConfig(height=240, width=240))
