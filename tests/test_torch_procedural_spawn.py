"""The procedural spawn of marlsnake_torch against marlsnake_tpu's.

The JAX reset draws ``uniform(fold_in(key, 0), (N, 4))`` a snake
(engine.py:460,580); the port takes exactly those numbers. Cells, grid and
every state field must be EQUAL (integer work; tolerance 0).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from marlsnake_tpu.core import engine as JE
from marlsnake_tpu.core.types import EnvConfig as JConfig
from marlsnake_torch.core import engine as TE
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.env import SnakeEnv
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.rng import reset_draws, step_draws
from test_torch_engine import (_t, assert_fields_equal, configs, jax_reset,
                               reset_draws_from_keys)

# 20x20x2 length 3: bands of 9 rows, so 'both' has its vertical family;
# 20x20x8: bands of 2 rows, too low for a vertical segment of 3;
# 12x9x3 length 5: an odd board with long snakes
BOARDS = [dict(height=20, width=20, num_snakes=2, snake_length=3),
          dict(height=20, width=20, num_snakes=8, snake_length=3),
          dict(height=12, width=9, num_snakes=3, snake_length=5)]


@pytest.mark.parametrize('orient', ['horizontal', 'both'])
@pytest.mark.parametrize('board', BOARDS, ids=['20x20x2', '20x20x8',
                                               '12x9x3'])
def test_procedural_cells_and_grid_equal(board, orient):
    jcfg, cfg = configs(spawn_mode='procedural', spawn_orientations=orient,
                        **board)
    keys = jax.random.split(jax.random.key(7), 64)
    jcells, jgrid = jax.jit(jax.vmap(
        functools.partial(JE._procedural_spawn, jcfg)))(keys)
    u = _t(jax.vmap(lambda k: jax.random.uniform(
        k, (cfg.num_snakes, 4)))(keys))
    cells = TE._procedural_spawn(cfg, u)
    assert cells.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jcells), cells.numpy())
    state = TE._reset_core(cfg, None, u)
    np.testing.assert_array_equal(np.asarray(jgrid), state.grid.numpy())
    vertical = (cells[:, :, 0] - cells[:, :, 1]).abs() == cfg.width
    assert cfg.spawn_vertical == (orient == 'both'
                                  and board['num_snakes'] == 2)
    assert bool(vertical.any()) == cfg.spawn_vertical
    if cfg.spawn_vertical:
        assert not bool(vertical.all())


def test_procedural_edge_draws_stay_on_the_board():
    """u = 0 and the largest float32 below 1 pick the first and the last
    choice of every family."""
    cfg = EnvConfig(height=20, width=20, num_snakes=2, snake_length=3,
                    spawn_mode='procedural', spawn_orientations='both')
    top = float(np.float32(1.0) - np.finfo(np.float32).epsneg)
    u = torch.tensor([[[0.0, 0.0, 0.0, 0.0], [top, top, top, top]],
                      [[top, top, 0.0, 0.0], [0.0, 0.0, top, top]]])
    cells = TE._procedural_spawn(cfg, u)
    rows, cols = cells // 20, cells % 20
    assert int(rows.min()) >= 1 and int(rows.max()) <= 18
    assert int(cols.min()) >= 1 and int(cols.max()) <= 18
    # snake 0 stays in rows 1..9 and snake 1 in rows 10..18
    assert int(rows[:, 0].max()) <= 9 and int(rows[:, 1].min()) >= 10
    grid = TE._reset_core(cfg, None, u).grid
    assert int((grid > 1).sum()) == 2 * 2 * 3
    assert TE.spawn_tables(cfg, 'cpu') is None


@pytest.mark.parametrize('orient', ['horizontal', 'both'])
def test_procedural_reset_parity(orient):
    jcfg, cfg = configs(height=12, width=12, num_snakes=2, snake_length=3,
                        spawn_mode='procedural', spawn_orientations=orient)
    keys = jax.random.split(jax.random.key(3), 16)
    jstate, jobs = jax_reset(jcfg, None, keys)
    state, obs = TE.reset(cfg, None, reset_draws_from_keys(cfg, keys))
    assert_fields_equal(jstate, state, 'reset')
    np.testing.assert_array_equal(np.asarray(jobs), obs.numpy())


@pytest.mark.parametrize('kwargs,message', [
    (dict(map_layout=('#####', '#...#', '#...#', '#...#', '#####'),
          num_snakes=1), 'no map_layout'),
    (dict(height=5, width=10, num_snakes=4), 'interior row per snake'),
    (dict(height=10, width=6, num_snakes=2, snake_length=5),
     'snake_length <= width-2')], ids=['layout', 'rows', 'length'])
def test_both_packages_reject_the_same_procedural_configs(kwargs, message):
    errors = []
    for cls in (JConfig, EnvConfig):
        with pytest.raises(ValueError, match=message) as info:
            cls(spawn_mode='procedural', **kwargs)
        errors.append(str(info.value))
        cls(spawn_mode='pool', **kwargs)       # the pool takes them
    assert errors[0] == errors[1]


@pytest.mark.parametrize('orient', ['horizontal', 'both'])
def test_procedural_envs_run_on_the_cpu(orient):
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3,
                    spawn_mode='procedural', spawn_orientations=orient)
    env = VectorSnakeEnv(cfg, 6, device='cpu', seed=1)
    assert reset_draws(cfg, 6, env.generator, 'cpu').spawn_u.shape == (
        6, 2, 4)
    assert step_draws(cfg, 6, env.generator, 'cpu').reset_spawn_u.shape == (
        6, 2, 4)
    state, obs = env.reset()
    resets = 0
    for _ in range(30):
        state, out = env.step(state, torch.randint(0, 3, (6, 2)))
        resets += int(out.done_all.sum())
        fresh = out.done_all
        assert bool(state.alive[fresh].all())
        assert bool((state.ring_len[fresh] == 2).all())
    assert resets > 0 and out.obs.shape == (6, 2, 10, 10, 8)
    single = SnakeEnv(cfg, device='cpu', seed=2)
    assert single.spawn is None
    s, o = single.reset()
    s, out = single.step(s, [0, 1])
    assert o.shape == out.obs.shape == (2, 10, 10, 8)
