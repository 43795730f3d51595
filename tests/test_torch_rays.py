"""The ray-feature transform of marlsnake_torch against marlsnake_tpu's.

Tolerance: 1e-6 absolute. A feature is a sum of at most ``v`` float32
weights ``1/d`` or ``1/(d*sqrt(2))``, each <= 1; XLA and ``torch.sum`` may
add them in another order, and ``inv / sqrt(2)`` may round differently by
one ulp. Within the port, ``ray_features`` of the obs and
``ray_features_from_grid`` of the state sum the same terms in the same
order and must be EQUAL.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.core import engine as JE
from marlsnake_tpu.ops import rays as JR
from marlsnake_torch.core import engine as TE
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.graph import GraphSnakeEnv
from marlsnake_torch.envs.vector import VectorSnakeEnv, build_graph_vector_fns
from marlsnake_torch.ops import rays as TR
from test_torch_engine import (_t, configs, jax_reset, jax_spawn,
                               reset_draws_from_keys, state_from_jax,
                               step_draws_from_keys)

ATOL = 1e-6
BOARD = dict(height=10, width=10, num_snakes=2, snake_length=3,
             max_episode_steps=9)
CASES = [dict(), dict(frame_stack=2), dict(vision_range=3),
         dict(vision_range=2, frame_stack=2),
         dict(obs_format='packed', frame_stack=2)]
IDS = ['full', 'full-fs2', 'vision3', 'vision2-fs2', 'packed-fs2']


def _jax_rollout(jcfg, steps, seed, b=6):
    """States and uint8 obs of a random auto-reset rollout of the JAX
    engine, dead snakes and fresh resets included."""
    keys = jax.random.split(jax.random.key(seed), b)
    step = jax.jit(jax.vmap(functools.partial(
        JE.step_autoreset, jcfg, jax_spawn(jcfg))))
    state, obs = jax_reset(jcfg, jax_spawn(jcfg), keys)
    rng = np.random.default_rng(seed)
    out = [(state, obs)]
    for _ in range(steps):
        actions = rng.integers(0, 3, size=(b, jcfg.num_snakes))
        state, o = step(state, jnp.asarray(actions, jnp.int32))
        out.append((state, o.obs))
    return out


@pytest.mark.parametrize('kwargs', CASES, ids=IDS)
def test_ray_features_parity(kwargs):
    jcfg, cfg = configs(**BOARD, **kwargs)
    packed = cfg.obs_format == 'packed'
    jrays = jax.jit(jax.vmap(functools.partial(JR.ray_features, jcfg)))
    jgrid_rays = jax.jit(jax.vmap(functools.partial(
        JR.ray_features_from_grid, jcfg)))
    assert TR.use_grid_rays(cfg) == JR.use_grid_rays(jcfg)
    dead = 0
    for t, (jstate, jobs) in enumerate(_jax_rollout(jcfg, 14, seed=5)):
        state = state_from_jax(jstate)
        obs = _t(jobs)
        dead += int((~state.alive).sum())
        if not packed:
            want = np.asarray(jrays(jobs, jstate.head, jstate.direction,
                                    jstate.alive))
            got = TR.ray_features(cfg, obs, state.head, state.direction,
                                  state.alive)
            assert got.dtype == torch.float32
            assert got.shape == (6, 2, 5, 8 * cfg.frame_stack)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL,
                                       err_msg=f't={t}')
            assert not bool(got[~state.alive].any())
        if TR.use_grid_rays(cfg):
            want_g = np.asarray(jgrid_rays(
                jstate.grid, jstate.head, jstate.direction, jstate.alive,
                jstate.hist_grid))
            got_g = TR.ray_features_from_grid(
                cfg, state.grid, state.head, state.direction, state.alive,
                state.hist_grid)
            np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                                       atol=ATOL, err_msg=f'grid t={t}')
            if not packed:
                assert torch.equal(got_g, got), t
    assert dead > 0


def test_rays_stop_at_the_first_wall_and_weigh_by_distance():
    cfg = EnvConfig(height=8, width=8, num_snakes=1, snake_length=2)
    grid = TE.make_empty_grid(cfg, 'cpu').clone()[None]
    grid[0, 3, 2] = 3                       # my head at (3, 2), facing UP
    grid[0, 1, 2] = 2                       # a fruit two cells ahead
    grid[0, 3, 5] = 2                       # and one three cells to the right
    head = torch.tensor([[[3, 2]]], dtype=torch.int32)
    rays = TR.ray_features_from_grid(
        cfg, grid, head, torch.zeros((1, 1), dtype=torch.int32),
        torch.ones((1, 1), dtype=torch.bool))[0, 0]
    # forward: fruit at d=2, wall at d=3 (included); nothing behind it
    assert rays[0].tolist() == pytest.approx([1 / 3, 1 / 2, 0, 0, 0, 0, 0, 0])
    # left: wall at d=2; right: fruit at d=3, wall at d=5
    assert rays[1].tolist() == pytest.approx([1 / 2, 0, 0, 0, 0, 0, 0, 0])
    assert rays[2].tolist() == pytest.approx([1 / 5, 1 / 3, 0, 0, 0, 0, 0, 0])
    # forward-left diagonal: wall at d=2, weight 1 / (2 * sqrt(2))
    assert rays[3, 0].item() == pytest.approx(1 / (2 * 2 ** 0.5))


@pytest.mark.parametrize('kwargs', CASES, ids=IDS)
def test_graph_vector_env_rollout_matches_jax(kwargs):
    """``VectorSnakeEnv(graph=True)`` against the JAX package's, with the
    same draws: states equal, ray obs within ATOL, over steps that reset."""
    from marlsnake_tpu.envs.vector import build_graph_vector_fns as jbuild
    from test_torch_engine import assert_fields_equal
    jcfg, cfg = configs(**BOARD, **kwargs)
    jreset, jstep = (jax.jit(f) for f in jbuild(jcfg, autoreset=True))
    reset_fn, step_fn = build_graph_vector_fns(cfg, True, 'cpu')
    keys = jax.random.split(jax.random.key(2), 5)
    jstate, jobs = jreset(keys)
    state, obs = reset_fn(reset_draws_from_keys(cfg, keys))
    rng = np.random.default_rng(2)
    resets = 0
    for t in range(14):
        assert obs.shape == (5, 2, 5, 8 * cfg.frame_stack)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0,
                                   atol=ATOL, err_msg=f't={t}')
        actions = rng.integers(0, 3, size=(5, 2)).astype(np.int32)
        draws = step_draws_from_keys(cfg, jstate.key)
        jstate, jout = jstep(jstate, jnp.asarray(actions))
        state, out = step_fn(state, torch.as_tensor(actions), draws)
        assert_fields_equal(jstate, state, f'state t={t}')
        jobs, obs = jout.obs, out.obs
        resets += int(out.done_all.sum())
    assert resets > 0


def test_graph_envs_shapes_and_checks():
    from marlsnake_tpu.envs.vector import build_graph_vector_fns as jbuild
    bad = dict(height=10, width=10, num_snakes=2, vision_range=2,
               frame_stack=2, obs_format='packed')
    jcfg, cfg = configs(**bad)
    for build, c in ((jbuild, jcfg),
                     (lambda c: build_graph_vector_fns(c, device='cpu'),
                      cfg)):
        with pytest.raises(ValueError, match='grid-rays fast path'):
            build(c)
    with pytest.raises(ValueError, match="observer='snake'"):
        GraphSnakeEnv(EnvConfig(observer='human'), device='cpu')
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3,
                    frame_stack=2)
    venv = VectorSnakeEnv(cfg, 4, device='cpu', graph=True)
    assert venv.obs_shape == (4, 2, 5, 16)
    state, obs = venv.reset()
    state, out = venv.step(state, torch.zeros((4, 2), dtype=torch.int32))
    assert obs.shape == out.obs.shape == (4, 2, 5, 16)
    assert out.obs.dtype == torch.float32
    env = GraphSnakeEnv(cfg, device='cpu', seed=1)
    assert env.obs_shape == (2, 5, 16) and env.obs_dtype is np.float32
    s, o = env.reset()
    s, out = env.step(s, [1, 2])
    assert o.shape == out.obs.shape == (2, 5, 16)
    # the single env's rays are the vector env's at a batch of one
    want = TR.ray_features_from_grid(cfg, s.grid, s.head, s.direction,
                                     s.alive, s.hist_grid)[0]
    assert torch.equal(out.obs, want)
