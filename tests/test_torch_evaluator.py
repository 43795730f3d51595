"""marlsnake_torch.ops.floodfill and marlsnake_torch.algo.evaluator against
the JAX package and a count-capped BFS, on the CPU.

The flood fill, the masked actions and the batched evaluation are integer
and boolean work on the same obs, so they must be EQUAL. The evaluation's
Q-values come from the same DQN weights in both packages (float32, TF32
off; within 1e-4), whose masked argmax is the same wherever two allowed
moves are not within that of each other, which the random weights of the
test's seed avoid; its mean reward and lifetime are float32 means of the
same numbers, which XLA and torch divide differently: within 1e-6
relative.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo import evaluator as JEV
from marlsnake_tpu.envs.vector import build_vector_fns as jax_vector_fns
from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_tpu.ops.floodfill import reachable_count as jax_reachable
from marlsnake_torch.algo import evaluator as EV
from marlsnake_torch.core import types as T
from marlsnake_torch.models.dqn import DQN, make_dqn
from marlsnake_torch.models.weights import dqn_from_flax
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.ops.floodfill import reachable_count
from test_torch_engine import _t, configs, reset_draws_from_keys

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def bfs_count(passable, start, limit=60):
    """The reference's count-capped BFS (tests/test_ops.py)."""
    q = deque([tuple(start)])
    visited = {tuple(start)}
    count = 0
    h, w = passable.shape
    while q and count < limit:
        y, x = q.popleft()
        count += 1
        for dy, dx in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
            ny, nx = y + dy, x + dx
            if (0 <= ny < h and 0 <= nx < w and (ny, nx) not in visited
                    and passable[ny, nx]):
                visited.add((ny, nx))
                q.append((ny, nx))
    return count


# --- the flood fill ---------------------------------------------------------

@pytest.mark.parametrize('limit', [60, 7])
def test_reachable_count_matches_bfs_and_jax(limit):
    """Batched over (3, 8) boards of 12x12 with a third of the cells
    blocked, some starts on blocked cells; every count equal to the BFS's
    and to JAX's ``reachable_count`` of the same board."""
    rng = np.random.default_rng(limit)
    passable = rng.random((3, 8, 12, 12)) > 0.35
    start = rng.integers(0, 12, (3, 8, 2))
    got = reachable_count(_t(passable), _t(start), limit)
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    want = np.array([[bfs_count(passable[i, j], start[i, j], limit)
                      for j in range(8)] for i in range(3)])
    np.testing.assert_array_equal(got.numpy(), want)
    jfn = jax.jit(jax.vmap(jax.vmap(lambda p, s: jax_reachable(p, s, limit))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfn(jnp.asarray(passable),
                                    jnp.asarray(start))))
    assert (want == limit).any() and (want < limit).any()


def test_reachable_count_cap_and_start_cell():
    open_board = torch.ones((1, 20, 20), dtype=torch.bool)
    assert reachable_count(open_board, torch.tensor([[10, 10]])).tolist() \
        == [60]
    walled = torch.zeros((20, 20), dtype=torch.bool)
    assert int(reachable_count(walled, torch.tensor([3, 4]))) == 1


# --- masked actions ---------------------------------------------------------

def boards(steps, seed=0, e=6, hw=12, n=3):
    """Obs (E, N, H, W, 8) and done flags of JAX envs after ``steps``
    random steps without reset, so that some snakes are dead."""
    jcfg, _ = configs(height=hw, width=hw, num_snakes=n, snake_length=3)
    reset_fn, step_fn = jax_vector_fns(jcfg, autoreset=False)
    states, obs = jax.jit(reset_fn)(jax.random.split(jax.random.key(seed),
                                                     e))
    done = np.zeros((e, n), bool)
    step = jax.jit(step_fn)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        states, out = step(states, jnp.asarray(rng.integers(0, 3, (e, n)),
                                               dtype=jnp.int32))
        obs, done = out.obs, np.asarray(out.done)
    return np.array(obs), done


def jax_masked(obs, q, dirs, active, limit=60):
    fn = jax.jit(jax.vmap(lambda o, qq, d, a: JEV.masked_actions(
        o, qq, d, a, limit)))
    acts, new_dirs = fn(jnp.asarray(obs), jnp.asarray(q), jnp.asarray(dirs),
                        jnp.asarray(active))
    return np.asarray(acts), np.asarray(new_dirs)


@pytest.mark.parametrize('steps', [0, 6, 14])
def test_masked_actions_match_jax(steps):
    """12x12, 3 snakes, 6 envs, random Q: reset boards and boards after
    random steps (dead snakes, inactive agents), directions unknown for
    about half the snakes, and one snake whose every move is vetoed."""
    obs, done = boards(steps, seed=steps)
    e, n = done.shape
    rng = np.random.default_rng(100 + steps)
    q = rng.normal(size=(e, n, 3)).astype(np.float32)
    units = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)], np.int32)
    dirs = units[rng.integers(0, 4, (e, n))]
    dirs[rng.random((e, n)) < 0.5] = 0
    active = ~done
    # box in snake 0 of env 0: walls on the four neighbours of its head
    heads = np.argwhere(obs[0, 0, :, :, T.CH_MY_HEAD] == 1)
    if len(heads):
        y, x = heads[0]
        for dy, dx in units:
            if 0 <= y + dy < 12 and 0 <= x + dx < 12:
                obs[0, 0, y + dy, x + dx, T.CH_WALL] = 1
        active[0, 0] = True
    want = jax_masked(obs, q, dirs, active)
    got = EV.masked_actions(_t(obs), _t(q), _t(dirs), _t(active))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    if len(heads):
        assert want[0][0, 0] == 0     # all three moves vetoed: action 0
    if steps:
        assert (~active).any()
    # one env alone, without the env axis
    one = EV.masked_actions(_t(obs[1]), _t(q[1]), _t(dirs[1]),
                            _t(active[1]))
    np.testing.assert_array_equal(one[0].numpy(), want[0][1])


def test_masked_action_single_matches_jax():
    """Each snake alone under a random claim set, batched over (E, N)."""
    obs, done = boards(8, seed=3)
    e, n = done.shape
    rng = np.random.default_rng(7)
    q = rng.normal(size=(e, n, 3)).astype(np.float32)
    dirs = np.zeros((e, n, 2), np.int32)
    claimed = rng.random((e, n, 12, 12)) < 0.1
    fn = jax.jit(jax.vmap(jax.vmap(
        lambda o, qq, d, c: JEV.masked_action_single(o, qq, d, c, 60))))
    want = fn(jnp.asarray(obs), jnp.asarray(q), jnp.asarray(dirs),
              jnp.asarray(claimed))
    got = EV.masked_action_single(_t(obs), _t(q), _t(dirs), _t(claimed))
    for g, w, name in zip(got, want, ('act', 'new_dir', 'next_pos',
                                      'head_exists')):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


# --- the batched evaluation -------------------------------------------------

def jax_fruit_draws(reset_keys, steps, n):
    """The fruit draws of the JAX envs' own keys over ``steps`` steps
    without reset (engine.py:576, 933); an env held still does not
    advance its key in JAX, and its draws are unused in both."""
    keys = jax.vmap(lambda k: jax.random.fold_in(k, 2))(reset_keys)
    fruit = []
    for _ in range(steps):
        split = jax.vmap(jax.random.split)(keys)
        keys = split[:, 0]
        fruit.append(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (n,)))(split[:, 1])))
    return _t(np.stack(fruit))


@pytest.mark.parametrize('n,done_mode', [(2, 'all'), (4, 'any')],
                         ids=['2-snakes', '4-snakes-coop'])
def test_evaluate_batch_matches_jax(n, done_mode, monkeypatch):
    """8x8, 4 envs, 16 steps, the flax DQN's weights in both. With 4
    snakes in coop mode envs end at different steps: the finished ones
    are held still while the others go on, and the loop stops after the
    chunk in which all are done."""
    jcfg, cfg = configs(height=8, width=8, num_snakes=n, snake_length=3,
                        done_mode=done_mode)
    hw, e, steps = (8, 8), 4, 16
    params = FlaxDQN(num_actions=3).init(
        jax.random.key(5), jnp.zeros((1,) + hw + (8,), jnp.float32))
    net = DQN(hw, 8, 3, assume_binary_obs=True, device='cpu')
    net.load_state_dict(dqn_from_flax(params, hw))
    key = jax.random.key(6)
    jrun = JEV.build_evaluate_batch(FlaxDQN(num_actions=3), jcfg, e, steps)
    jr, jt = (float(x) for x in jrun(params, key))
    reset_keys = jax.random.split(key, e)
    held, step = [], step_kernel.step

    def counting(cfg, state, actions, fruit_u, hold=None):
        held.append(0 if hold is None else int(hold[0].sum()))
        return step(cfg, state, actions, fruit_u, hold)

    monkeypatch.setattr(step_kernel, 'step', counting)
    run = EV.build_evaluate_batch(net, cfg, e, steps, device='cpu')
    before = step.launches
    got = run(reset=reset_draws_from_keys(cfg, reset_keys),
              fruit_u=jax_fruit_draws(reset_keys, steps, n))
    # the plain engine on the CPU, one step a loop iteration, in whole
    # chunks: the last one runs on after every env is done
    k = run.chunk_steps
    assert step.launches == before and k == 8
    assert len(held) == -(-got.steps // k) * k and held[0] == 0
    np.testing.assert_allclose(float(got.mean_reward), jr, rtol=1e-6)
    np.testing.assert_allclose(float(got.mean_lifetime), jt, rtol=1e-6)
    if done_mode == 'any':
        assert sum(held) > 0 and got.steps < steps
    # the same under the parameters handed in
    again = run(dict(net.state_dict()),
                reset=reset_draws_from_keys(cfg, reset_keys),
                fruit_u=jax_fruit_draws(reset_keys, steps, n))
    assert (float(again.mean_reward), float(again.mean_lifetime)) == (
        float(got.mean_reward), float(got.mean_lifetime))


def test_evaluate_batch_with_own_draws():
    """The port's own draws: reproducible from the seed, finite, stops
    when every env is done; packed obs are refused."""
    _, cfg = configs(height=8, width=8, num_snakes=2, snake_length=3)
    net = make_dqn(cfg, seed=1, device='cpu')
    a = EV.evaluate_batch(net, None, cfg, num_envs=3, max_steps=40, seed=2,
                          device='cpu')
    b = EV.evaluate_batch(net, None, cfg, num_envs=3, max_steps=40, seed=2,
                          device='cpu')
    assert a == b and all(np.isfinite(a)) and 0 < a[1] <= 40
    _, packed = configs(height=8, width=8, num_snakes=2,
                        obs_format='packed')
    with pytest.raises(ValueError, match='uint8'):
        EV.build_evaluate_batch(net, packed, device='cpu')
