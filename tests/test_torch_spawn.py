"""marlsnake_torch.core.{types,maps,spawn} equal the JAX package's
tables, candidate paths, spawn pools and pool cells exactly."""

import numpy as np
import pytest

from marlsnake_tpu.core import spawn as jspawn
from marlsnake_tpu.core import types as JT
from marlsnake_tpu.core.maps import parse_layout as j_parse_layout
from marlsnake_torch.core import spawn as tspawn
from marlsnake_torch.core import types as TT
from marlsnake_torch.core.maps import parse_layout as t_parse_layout

BOARDS = [(10, 10, 3, 2), (20, 20, 3, 4)]
LAYOUT = ('########',
          '#......#',
          '#..##..#',
          '#......#',
          '#.#....#',
          '#......#',
          '########')


def test_tables_and_cell_codes_equal():
    for name in ('TURN_SNAKE', 'TURN_HUMAN', 'DIR_DELTA'):
        a, b = getattr(JT, name), getattr(TT, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ('EMPTY', 'WALL', 'FRUIT', 'HEAD', 'BODY', 'TAIL',
                 'OWNER_SHIFT', 'TYPE_MASK', 'FEATURE_CHANNEL', 'UP',
                 'RIGHT', 'DOWN', 'LEFT'):
        assert getattr(JT, name) == getattr(TT, name), name
    assert JT.DEFAULT_REWARDS == TT.DEFAULT_REWARDS
    cells = np.arange(256)
    np.testing.assert_array_equal(JT.cell_type(cells), TT.cell_type(cells))
    np.testing.assert_array_equal(JT.cell_owner(cells),
                                  TT.cell_owner(cells))


@pytest.mark.parametrize('kwargs', [
    dict(), dict(height=10, width=10, num_snakes=2),
    dict(num_snakes=5, num_fruits=2, observer='human', done_mode='any'),
    dict(map_layout=LAYOUT, num_snakes=2)])
def test_env_config_properties_equal(kwargs):
    j, t = JT.EnvConfig(**kwargs), TT.EnvConfig(**kwargs)
    for name in ('height', 'width', 'resolved_num_fruits', 'num_actions',
                 'obs_shape', 'body_capacity', 'rewards', 'map_layout'):
        assert getattr(j, name) == getattr(t, name), name
    with pytest.raises(KeyError):
        TT.EnvConfig.from_reward_dict({'fruit': 1.0})


def test_parse_layout_equal():
    np.testing.assert_array_equal(j_parse_layout(LAYOUT),
                                  t_parse_layout(LAYOUT))
    with pytest.raises(ValueError):
        t_parse_layout(('###', '#.#', '#..'))


@pytest.mark.parametrize('h,w,k,n', BOARDS)
def test_spawn_candidates_equal(h, w, k, n):
    a = jspawn.spawn_candidates(h, w, k)
    b = tspawn.spawn_candidates(h, w, k)
    assert a.dtype == b.dtype and a.shape == b.shape and len(b) > 0
    np.testing.assert_array_equal(a, b)


def test_spawn_candidates_with_layout_equal():
    np.testing.assert_array_equal(
        jspawn.spawn_candidates(7, 8, 3, LAYOUT),
        tspawn.spawn_candidates(7, 8, 3, LAYOUT))
    np.testing.assert_array_equal(jspawn.base_grid_host(7, 8, LAYOUT),
                                  tspawn.base_grid_host(7, 8, LAYOUT))


@pytest.mark.parametrize('h,w,k,n', BOARDS)
def test_spawn_pool_and_cells_equal(h, w, k, n):
    a = jspawn.spawn_pool(h, w, k, n)
    b = tspawn.spawn_pool(h, w, k, n)
    assert a.shape == b.shape == (1 << 16, n)
    np.testing.assert_array_equal(a, b)
    ca = jspawn.spawn_data(h, w, k, n).cells
    cb = tspawn.spawn_data(h, w, k, n).cells
    assert ca.dtype == cb.dtype
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(jspawn.base_grid_host(h, w),
                                  tspawn.base_grid_host(h, w))
