"""marlsnake_torch's wrapper layer (make, make_snake, GymAdapter,
VectorAdapter, RenderGUI, gym registration), maps, rendering and
DQNEvaluator against the JAX package, on the CPU.

The single-env adapter takes the JAX adapter's draws: episode ``e``
resets from ``fold_in(key(seed), e)`` and steps on that key's fruit
draws (the JAX env's own key schedule, handed over as ``ResetDraws`` and
``fruit_u``); then every obs, reward, done flag and info entry is EQUAL.
Maps and renders are host code on the same grids: EQUAL. The evaluator's
Q-values come from the same DQN weights (float32, TF32 off); its masked
argmax is the same away from near-ties, which the seeds here avoid, and
its means are float64 means of the same rewards: within 1e-12 relative.
"""

import io
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo import evaluator as JEV
from marlsnake_tpu.core import maps as JM
from marlsnake_tpu.core import render as JR
from marlsnake_tpu.envs import env as JENV
from marlsnake_tpu.envs import wrappers as JW
from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_torch.algo.evaluator import DQNEvaluator
from marlsnake_torch.core import maps as TM
from marlsnake_torch.core import render as TR
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs import wrappers as TW
from marlsnake_torch.envs.env import SnakeEnv, make_env
from marlsnake_torch.envs.gym_compat import register_gym_envs
from marlsnake_torch.models.dqn import DQN, make_dqn
from marlsnake_torch.models.weights import dqn_to_flax
from marlsnake_torch.ops import step_kernel
from test_torch_engine import reset_draws_from_keys
from test_torch_evaluator import jax_fruit_draws

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOARD = dict(num_snakes=2, height=10, width=10, snake_length=3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test here runs many small CPU ops. When several pytest
    workers share the CPU, torch's intra-op threads spin against theirs:
    one thread a test keeps the file's time near its time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class HandedDraws(TW.Wrapper):
    """A port ``GymAdapter`` playing the JAX adapter's episodes: episode
    ``e`` takes the reset and fruit draws of ``fold_in(key(seed), e)``."""

    def __init__(self, env, seed, steps):
        super().__init__(env)
        self._key, self._steps, self._episode = jax.random.key(seed), steps, 0

    def reset(self, **kwargs):
        keys = jax.random.fold_in(self._key, self._episode)[None]
        self._episode += 1
        self._fruit = jax_fruit_draws(keys, self._steps, self.num_snakes)
        self._t = 0
        return self.env.reset(draws=reset_draws_from_keys(self.cfg, keys))

    def step(self, actions, **kwargs):
        self._t += 1
        return self.env.step(actions, fruit_u=self._fruit[self._t - 1])


def assert_step_equal(got, want, where):
    (o, r, d, i), (jo, jr, jd, ji) = got, want
    assert o.dtype == jo.dtype and o.shape == jo.shape, where
    np.testing.assert_array_equal(o, jo, err_msg=where)
    assert r == jr and d == jd, where
    assert i.keys() == ji.keys(), where
    for k in ji:
        np.testing.assert_array_equal(i[k], ji[k], err_msg=f'{where} {k}')


@pytest.mark.parametrize('env_id', ['Snake-v1', 'SnakeCoop-v1'])
def test_gym_adapter_episodes_match_jax(env_id):
    """Two full random episodes of 10x10 with 2 snakes (3 in coop) on the
    JAX adapter's draws: every step's obs, rewards, dones and info EQUAL,
    ``info['rank']`` set at each episode's end."""
    n = 3 if env_id == 'SnakeCoop-v1' else 2
    kwargs = dict(BOARD, num_snakes=n, seed=3)
    jenv = JW.make(env_id, **kwargs)
    env = HandedDraws(TW.make(env_id, device='cpu', **kwargs), 3, 300)
    rng = np.random.default_rng(0)
    for ep in range(2):
        want, got = jenv.reset(), env.reset()
        assert got.dtype == np.uint8 and got.shape == (n, 10, 10, 8)
        np.testing.assert_array_equal(got, want)
        for t in range(300):
            acts = [int(a) for a in rng.integers(0, 3, n)]
            want, got = jenv.step(acts), env.step(acts)
            assert_step_equal(got, want, f'episode {ep} step {t}')
            if all(got[2]):
                break
        assert all(got[2]) and sorted(got[3]['rank'])[0] == 1
        np.testing.assert_array_equal(env.grid, jenv.grid)
        np.testing.assert_array_equal(env.render('rgb_array'),
                                      jenv.render('rgb_array'))


def test_snake_env_steps_through_the_step_wrapper(monkeypatch):
    """A SnakeEnv (and GraphSnakeEnv) step is one call of
    step_kernel.step at B=1, the plain engine on the CPU; on CUDA that is
    one launch of the kernel's entry."""
    calls, step = [], step_kernel.step

    def counting(cfg, state, actions, fruit_u, hold=None):
        calls.append((tuple(actions.shape), tuple(fruit_u.shape)))
        return step(cfg, state, actions, fruit_u, hold)

    monkeypatch.setattr(step_kernel, 'step', counting)
    before = step.launches
    for env_id in ('Snake-v1', 'SnakeGraph-v1'):
        env = TW.make(env_id, device='cpu', **BOARD)
        env.reset()
        for _ in range(5):
            env.step([1, 2])
    assert calls == [((1, 2), (1, 2))] * 10 and step.launches == before
    single = make_env(device='cpu', map='10x10', num_snakes=2)
    s, obs = single.reset(seed=1)
    s, out = single.step(s, [0, 0])
    assert len(calls) == 11 and out.obs.shape == obs.shape == (2, 10, 10, 8)


def test_make_snake_single_and_vectorised():
    env, obs_shape, action_shape, props = TW.make_snake(
        num_envs=1, num_snakes=4, height=12, width=12, snake_length=3,
        device='cpu')
    assert props == {'action_info': {'action_n': 3}, 'num_envs': 1,
                     'num_snakes': 4}
    assert obs_shape == (4, 12, 12, 8) and action_shape == (3,)
    obs = env.reset()
    assert obs.shape == (4, 12, 12, 8) and obs.dtype == np.uint8
    obs, rews, dones, info = env.step([0, 1, 2, 0])
    assert len(rews) == 4 and len(dones) == 4

    env, *_ = TW.make_snake(num_envs=1, num_snakes=1, height=10, width=10,
                            snake_length=3, device='cpu')
    assert isinstance(env, TW.SingleAgent)
    assert env.reset().shape == (10, 10, 8)
    obs, r, d, _ = env.step(0)
    assert isinstance(r, float) and isinstance(d, bool)

    env, obs_shape, _, props = TW.make_snake(
        num_envs=4, num_snakes=2, height=10, width=10, snake_length=3,
        device='cpu')
    assert isinstance(env, TW.VectorAdapter) and props['num_envs'] == 4
    assert env.reset().shape == obs_shape == (4, 2, 10, 10, 8)
    for _ in range(30):
        obs, rews, dones, info = env.step(np.zeros((4, 2), np.int32))
    assert rews.shape == (4, 2) and info['done_all'].shape == (4,)
    assert len(env.render()) == 4

    env, obs_shape, *_ = TW.make_snake(
        num_envs=1, num_snakes=2, height=20, width=20, snake_length=3,
        vision_range=5, frame_stack=2, device='cpu')
    assert obs_shape == env.reset().shape == (2, 11, 11, 16)
    with pytest.raises(AssertionError):
        env.step([0])  # one action for two snakes
    for num_envs in (1, 4):
        with pytest.raises(KeyError):
            TW.make_snake(num_envs=num_envs, env_id='Snake-v9',
                          device='cpu')
    with pytest.raises(KeyError):
        TW.make('Snake-v1', num_snakes=2, reward_dict={'fruit': 1.0},
                device='cpu')
    with pytest.raises(ValueError):
        TW.make('Snake-v1', num_snakes=4, height=4, width=4,
                snake_length=3, device='cpu')


def test_coop_done_is_broadcast_and_graph_obs_shapes():
    env = TW.make('SnakeCoop-v1', num_snakes=3, height=10, width=10,
                  num_fruits=2, seed=0, device='cpu')
    env.reset()
    for _ in range(200):
        obs, rews, dones, info = env.step(
            [env.action_space.sample() % 3 for _ in range(3)])
        assert len(set(dones)) == 1
        if all(dones):
            break
    assert all(dones) and 'rank' in info

    env = TW.make('SnakeGraph-v1', num_snakes=2, height=12, width=12,
                  device='cpu')
    assert env.reset().shape == (2, 5, 8)
    obs, *_ = env.step([0, 0])
    assert obs.shape == (2, 5, 8) and obs.dtype == np.float32
    env, obs_shape, _, _ = TW.make_snake(num_envs=3, num_snakes=2,
                                         env_id='SnakeGraph-v1', height=12,
                                         width=12, snake_length=3,
                                         device='cpu')
    assert env.reset().shape == obs_shape == (3, 2, 5, 8)
    obs, *_ = env.step(np.zeros((3, 2), np.int32))
    assert obs.shape == (3, 2, 5, 8) and obs.dtype == np.float32


def test_vector_adapter_split_call_protocol():
    cfg = EnvConfig(**BOARD)
    va = TW.VectorAdapter(cfg, num_envs=4, device='cpu')
    va.reset_async()
    obs = va.reset_wait()
    assert obs.shape == (4, 2, 10, 10, 8)
    sync = TW.VectorAdapter(cfg, num_envs=4, device='cpu')
    np.testing.assert_array_equal(sync.reset(), obs)
    acts = np.zeros((4, 2), np.int32)
    for _ in range(3):
        va.step_async(acts)
        got, want = va.step_wait(), sync.step(acts)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[3]['done_all'],
                                      want[3]['done_all'])


def test_bundled_maps_match_jax():
    names = TM.bundled_maps()
    assert names == JM.bundled_maps() and len(names) == 7
    for name in names:
        layout = TM.load_layout(name)
        assert layout == JM.load_layout(name)
        np.testing.assert_array_equal(TM.parse_layout(layout),
                                      JM.parse_layout(layout))
    path = os.path.join(TM.ASSET_DIR, '12x12.txt')
    assert TM.load_layout(path) == TM.load_layout('12x12')
    with pytest.raises(FileNotFoundError):
        TM.load_layout('no-such-map')
    env = TW.make('Snake-v1', map='20x20_pillars', num_snakes=2,
                  device='cpu')
    assert env.reset().shape == (2, 20, 20, 8)
    assert (env.grid == 1).sum() > 4 * 19


def test_renders_match_jax(tmp_path):
    """render_ascii, rgb_from_grid and render_fancy of the same grids
    (with dead snakes): EQUAL; a gif of ten frames saves."""
    jenv = JW.make('Snake-v1', num_snakes=4, height=12, width=12, seed=1)
    jenv.reset()
    rng = np.random.default_rng(1)
    for t in range(12):
        grid = np.asarray(jenv.grid)
        state = jenv.state
        assert TR.render_ascii(grid) == JR.render_ascii(grid)
        np.testing.assert_array_equal(TR.rgb_from_grid(grid),
                                      JR.rgb_from_grid(grid))
        if t % 4 == 0:
            kw = dict(directions=np.asarray(state.direction),
                      alive=np.asarray(state.alive), cell_size=8)
            np.testing.assert_array_equal(TR.render_fancy(grid, **kw),
                                          JR.render_fancy(grid, **kw))
        jenv.step([int(a) for a in rng.integers(0, 3, 4)])
    assert not np.asarray(jenv.state.alive).all()

    env = TW.make('Snake-v1', num_snakes=1, height=10, width=10,
                  num_fruits=4, seed=1, device='cpu')
    env.reset()
    frame = env.render_fancy(cell_size=12)
    assert frame.shape == (120, 120, 3) and frame.dtype == np.uint8
    for _ in range(10):
        env.render('gif')
        env.step([env.action_space.sample() % 3])
    out = env.save_gif(str(tmp_path / 'out.gif'))
    from PIL import Image
    Image.open(out).seek(1)
    with io.BytesIO() as fileobj:
        env.save_gif(fileobj)
        assert fileobj.getbuffer().nbytes > 0


def test_gym_registration_with_fake_gym():
    registry = {}
    fake = types.ModuleType('fakegym')

    class Env:
        pass

    def register(id, entry_point, **kw):
        if id in registry:
            raise ValueError('already registered')
        registry[id] = entry_point

    fake.Env, fake.register = Env, register
    fake.make = lambda id, **kwargs: registry[id](**kwargs)
    assert register_gym_envs(fake)
    assert set(registry) == {'Snake-v1', 'SnakeCoop-v1', 'SnakeGraph-v1'}
    env = fake.make('Snake-v1', num_snakes=2, height=10, width=10,
                    snake_length=3, device='cpu')
    assert isinstance(env, Env) and env.unwrapped.env.device.type == 'cpu'
    assert env.reset().shape == (2, 10, 10, 8)
    o, r, d, info = env.step([0, 0])
    assert len(r) == 2 and len(d) == 2
    assert register_gym_envs(fake)  # twice is a no-op


def test_render_gui_headless_writes_mp4(tmp_path):
    cv2 = pytest.importorskip('cv2')
    path = str(tmp_path / 'out.mp4')
    gui = TW.RenderGUI(TW.make('Snake-v1', device='cpu', **BOARD),
                       save_video=True, video_path=path, fps=10,
                       headless=True)
    gui.reset()
    rng = np.random.default_rng(0)
    for _ in range(8):
        frame = gui.render()
        assert frame is not None and frame.dtype == np.uint8
        _, _, dones, _ = gui.step(list(rng.integers(0, 3, 2)))
        if all(dones):
            break
    gui.close()
    cap = cv2.VideoCapture(path)
    ok, first = cap.read()
    cap.release()
    assert ok and first is not None


def test_dqn_evaluator_matches_jax():
    """Two masked episodes of 10x10 with 2 snakes, up to 40 steps each,
    one DQN's weights in both (the port's seeded init, carried to flax)
    and the JAX adapter's draws; an evaluator handed the weights as
    ``params`` decides as the one whose net holds them."""
    cfg = EnvConfig(**BOARD)
    net = make_dqn(cfg, seed=2, device='cpu')
    state = net.state_dict()
    params = dqn_to_flax(state, (10, 10))
    jev = JEV.DQNEvaluator(
        JW.GymAdapter(JENV.SnakeEnv(JENV.EnvConfig(**BOARD)), seed=4),
        FlaxDQN(num_actions=3), params)
    want = jev.evaluate(num_episodes=2, max_steps=40, verbose=False)
    env = HandedDraws(TW.GymAdapter(SnakeEnv(cfg, device='cpu')), 4, 40)
    own = DQNEvaluator(env, net)
    got = own.evaluate(num_episodes=2, max_steps=40, verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert 0 < got[1] <= 40
    handed = DQNEvaluator(env, DQN((10, 10), 8, 3, device='cpu'),
                          params=state)
    obs = torch.as_tensor(np.stack([env.reset() for _ in range(4)]))
    dirs = torch.zeros((2, 2), dtype=torch.int32)
    active = torch.tensor([True, False])
    for o in obs:
        a, d = own._policy(o, dirs, active)
        b, e = handed._policy(o, dirs, active)
        assert torch.equal(a, b) and torch.equal(d, e)


def test_new_modules_import_no_jax_and_no_optional_package():
    """The wrapper layer, the evolution trainers, the battle arenas, the
    CLI, the distillation and the two rollout demos and their helpers
    import neither JAX nor the JAX package, and leave msgpack, PIL, cv2
    and gym to the functions that use them."""
    code = ('import marlsnake_torch.algo.neat_hybrid, '
            'marlsnake_torch.algo.neat, marlsnake_torch.envs.wrappers, '
            'marlsnake_torch.envs.gym_compat, marlsnake_torch.core.render, '
            'marlsnake_torch.core.maps, marlsnake_torch.utils.spaces, '
            'marlsnake_torch.algo.evaluator, marlsnake_torch.envs.env, '
            'marlsnake_torch.cli, marlsnake_torch.algo.battle, '
            'marlsnake_torch.algo.battle_batch, '
            'marlsnake_torch.algo.opponents, '
            'marlsnake_torch.utils.profiling, '
            'marlsnake_torch.utils.checkpoint, '
            'marlsnake_torch.tools.distill_acting, '
            'marlsnake_torch.examples.demo, '
            'marlsnake_torch.examples.vector_rollout; '
            'import sys; bad = [m for m in sys.modules if m.split(".")[0] '
            'in ("jax", "jaxlib", "flax", "optax", "orbax", "marlsnake_tpu", '
            '"msgpack", "PIL", "cv2", "gym", "gymnasium")]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)
