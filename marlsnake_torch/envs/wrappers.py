"""Reference-compatible wrapper / factory layer.

The port of the JAX package's ``envs/wrappers.py``: the public API
surface of the reference ``marlenv.wrappers`` (wrappers.py:84-223) on
top of the port's envs.

* ``make_snake(num_envs, num_snakes, env_id, **kwargs)`` — same signature
  and return arity as wrappers.py:203-223, with the obs/action shape
  slots filled in.
* ``SingleAgent`` / ``SingleMultiAgent`` — per-agent space views
  (wrappers.py:84-124).
* ``GymAdapter`` and ``VectorAdapter`` keep the classic ``reset()`` /
  ``step(actions)`` protocol (numpy in, numpy out) over state on the
  device. A ``GymAdapter`` step is one launch of the step kernel's entry
  without auto-reset at B=1 (``SnakeEnv``); a ``VectorAdapter`` step is
  one launch of the auto-reset entry for the whole batch
  (``VectorSnakeEnv``). On the CPU both are the plain engine.

Every entry point takes ``device`` (default ``'cuda'``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from marlsnake_torch.core import render as R
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.env import SnakeEnv
from marlsnake_torch.envs.graph import GraphSnakeEnv
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.rng import ResetDraws, derive_seed
from marlsnake_torch.utils import spaces

ENV_IDS = {
    'Snake-v1': dict(done_mode='all', graph=False),
    'SnakeCoop-v1': dict(done_mode='any', graph=False),
    'SnakeGraph-v1': dict(done_mode='all', graph=True),
}


def _config(env_id: str, kwargs: dict) -> EnvConfig:
    """The EnvConfig of ``env_id`` from reference-style kwargs (consumed:
    ``reward_dict``, ``map`` and the EnvConfig fields)."""
    if env_id not in ENV_IDS:
        raise KeyError(f'unknown env id {env_id!r}; '
                       f'choose from {sorted(ENV_IDS)}')
    reward_dict = kwargs.pop('reward_dict', None)
    kwargs.setdefault('num_fruits', -1)
    if 'map' in kwargs:
        from marlsnake_torch.core.maps import load_layout
        kwargs['map_layout'] = load_layout(kwargs.pop('map'))
    return EnvConfig.from_reward_dict(
        reward_dict, done_mode=ENV_IDS[env_id]['done_mode'], **kwargs)


def make(env_id: str = 'Snake-v1', device='cuda', **kwargs) -> 'GymAdapter':
    """Registry-style constructor mirroring the reference's gym IDs
    (envs/__init__.py:1-16)."""
    kwargs.pop('disable_env_checker', None)
    seed = kwargs.pop('seed', 0)
    cfg = _config(env_id, kwargs)
    env_cls = GraphSnakeEnv if ENV_IDS[env_id]['graph'] else SnakeEnv
    return GymAdapter(env_cls(cfg, device=device), seed=seed)


class GymAdapter:
    """Stateful single-env adapter with the reference step protocol.

    ``step`` returns ``(obs ndarray, rews list, dones list, info dict)``
    exactly like ``SnakeEnv.step`` (snake_env.py:414). Episode ``e`` after
    ``seed`` resets from the env's generator seeded with
    ``derive_seed(seed, e)``, and its steps draw from that generator (the
    JAX adapter folds ``e`` into its key); ``reset(draws=)`` and
    ``step(actions, fruit_u=)`` take the draws instead.
    """

    def __init__(self, env: SnakeEnv, seed: int = 0):
        self.env = env
        self.cfg = env.cfg
        self.num_snakes = self.cfg.num_snakes
        self._seed = seed
        self._episode = 0
        self._state = None
        self._recorder = R.GifRecorder()
        self.action_space = spaces.Discrete(
            self.cfg.num_actions * self.num_snakes, seed=seed)
        self.observation_space = spaces.Box(
            0, 1, shape=env.obs_shape, dtype=env.obs_dtype, seed=seed)

    # --- protocol ---------------------------------------------------------
    def seed(self, seed: int = 42):
        self._seed = seed
        self._episode = 0
        return [seed]

    def reset(self, draws: Optional[ResetDraws] = None,
              **kwargs) -> np.ndarray:
        self.env.generator.manual_seed(derive_seed(self._seed,
                                                   self._episode))
        self._episode += 1
        self._state, obs = self.env.reset(draws=draws)
        return obs.cpu().numpy()

    def step(self, actions, fruit_u: Optional[torch.Tensor] = None):
        if isinstance(actions, (int, np.integer)):
            actions = [actions]
        if len(actions) != self.num_snakes:
            # the reference's AssertionError, raised under -O as well
            raise AssertionError(f'{len(actions)} actions for '
                                 f'{self.num_snakes} snakes')
        acts = torch.tensor([int(a) for a in actions], dtype=torch.int32)
        self._state, out = self.env.step(self._state, acts, fruit_u)
        info = {}
        if bool(out.done_all):
            info['rank'] = [int(x) for x in out.rank.tolist()]
            info['episode_scores'] = out.episode_scores.cpu().numpy()
            info['episode_steps'] = out.episode_steps.cpu().numpy()
            info['episode_fruits'] = out.episode_fruits.cpu().numpy()
            info['episode_kills'] = out.episode_kills.cpu().numpy()
        return (out.obs.cpu().numpy(),
                [float(r) for r in out.reward.tolist()],
                [bool(d) for d in out.done.tolist()],
                info)

    def close(self):
        pass

    # --- state access -----------------------------------------------------
    @property
    def state(self):
        return self._state

    @property
    def grid(self) -> np.ndarray:
        return self._state.grid[0].cpu().numpy()

    # --- rendering (host-side; reference snake_env.py:165-299) ------------
    def render(self, mode: str = 'ascii', **kwargs):
        if mode == 'ascii':
            print(R.render_ascii(self.grid))
        elif mode == 'gif':
            self._recorder.capture(self.grid)
        elif mode == 'rgb_array':
            return R.rgb_from_grid(self.grid)
        elif mode == 'human':
            pass

    def render_fancy(self, cell_size: int = 40, save_path=None):
        return R.render_fancy(
            self.grid, directions=self._state.direction[0].cpu().numpy(),
            alive=self._state.alive[0].cpu().numpy(),
            cell_size=cell_size, save_path=save_path)

    def save_gif(self, fp=None):
        return self._recorder.save(fp)

    # attribute passthrough sugar for wrapper stacking
    @property
    def unwrapped(self):
        return self


class Wrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, actions, **kwargs):
        return self.env.step(actions, **kwargs)

    def close(self):
        return self.env.close()


class SingleAgent(Wrapper):
    """Unwraps the snake dim for 1-snake envs (wrappers.py:84-105)."""

    def __init__(self, env):
        super().__init__(env)
        if env.num_snakes != 1:
            raise AssertionError('Number of player must be one')
        self.action_space = spaces.Discrete(env.cfg.num_actions)
        self.observation_space = spaces.Box(
            0, 255, shape=env.observation_space.shape[1:],
            dtype=env.observation_space.dtype)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)[0]

    def step(self, action, **kwargs):
        obs, rews, dones, infos = self.env.step([action], **kwargs)
        return obs[0], rews[0], dones[0], {}


class SingleMultiAgent(Wrapper):
    """Per-agent space declaration (wrappers.py:107-124); passthrough step."""

    def __init__(self, env):
        super().__init__(env)
        self.action_space = spaces.Discrete(env.cfg.num_actions)
        self.observation_space = spaces.Box(
            0, 255, shape=env.observation_space.shape,
            dtype=env.observation_space.dtype)


class VectorAdapter:
    """Stateful batched adapter over the auto-reset vector env.

    Replaces ``AsyncVectorMultiEnv`` (wrappers.py:161-194): obs arrive as a
    (num_envs, num_snakes, ...) batch with no worker pipes or shared-memory
    transport. Each reset continues the env's generator, seeded once with
    ``seed``.
    """

    def __init__(self, cfg: EnvConfig, num_envs: int, seed: int = 0,
                 graph: bool = False, device='cuda'):
        self.cfg = cfg
        self.num_envs = num_envs
        self.num_snakes = cfg.num_snakes
        self.venv = VectorSnakeEnv(cfg, num_envs, autoreset=True,
                                   device=device, seed=seed, graph=graph)
        self._states = None
        self._pending_obs = self._pending_out = None
        self.action_space = spaces.Discrete(cfg.num_actions)
        self.observation_space = spaces.Box(
            0, 255, shape=self.venv.obs_shape,
            dtype=np.float32 if graph else np.uint8)

    def _actions(self, actions) -> torch.Tensor:
        return torch.as_tensor(np.asarray(actions).reshape(
            self.num_envs, self.num_snakes), device=self.venv.device)

    @staticmethod
    def _host(out):
        return (out.obs.cpu().numpy(), out.reward.cpu().numpy(),
                out.done.cpu().numpy(),
                {'done_all': out.done_all.cpu().numpy()})

    def reset(self, **kwargs) -> np.ndarray:
        self._states, obs = self.venv.reset()
        return obs.cpu().numpy()

    def step(self, actions):
        self._states, out = self.venv.step(self._states,
                                           self._actions(actions))
        return self._host(out)

    # --- gym.vector-shaped split-call protocol ------------------------
    # API parity with AsyncVectorEnv's step_async/step_wait (reference
    # wrappers.py:126-194). Dispatch IS asynchronous on CUDA: the step is
    # enqueued on the device at step_async, and the host waits only when
    # step_wait copies the results to numpy.
    def reset_async(self, **kwargs):
        self._states, self._pending_obs = self.venv.reset()

    def reset_wait(self, **kwargs) -> np.ndarray:
        obs = self._pending_obs.cpu().numpy()
        self._pending_obs = None
        return obs

    def step_async(self, actions):
        self._states, self._pending_out = self.venv.step(
            self._states, self._actions(actions))

    def step_wait(self, **kwargs):
        out = self._pending_out
        self._pending_out = None
        return self._host(out)

    def render(self, mode: str = 'rgb_array'):
        grids = self._states.grid.cpu().numpy()
        return [R.rgb_from_grid(g) for g in grids]

    def close(self):
        pass

    @property
    def states(self):
        return self._states


class RenderGUI(Wrapper):
    """cv2 window + optional mp4 capture.

    A close port of the reference's GUI shim (wrappers.py:20-82): named
    window, BGR convert, lazily-opened mp4v writer, with the field names
    ``window_initialized`` and ``render_size`` kept. Frames come from the
    grid renderer ``render_fancy``, and a ``headless`` mode (auto-detected
    from DISPLAY) skips the window. cv2 is imported where a frame is
    drawn.
    """

    def __init__(self, env, window_name: str = 'Snake AI',
                 save_video: bool = False, video_path: str = 'output.mp4',
                 fps: int = 20, headless: Optional[bool] = None):
        super().__init__(env)
        self.window_name = window_name
        self.render_size = 30
        self.save_video = save_video
        self.video_path = video_path
        self.fps = fps
        self.video_writer = None
        self.window_initialized = False
        self.headless = (headless if headless is not None
                         else not os.environ.get('DISPLAY'))

    def render(self, *args, **kwargs):
        img_rgb = self.env.render_fancy(cell_size=self.render_size)
        if img_rgb is None:
            return None
        import cv2
        img_bgr = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR)
        if not self.headless:
            if not self.window_initialized:
                cv2.namedWindow(self.window_name, cv2.WINDOW_NORMAL)
                cv2.resizeWindow(self.window_name, img_bgr.shape[1],
                                 img_bgr.shape[0])
                self.window_initialized = True
            cv2.imshow(self.window_name, img_bgr)
            cv2.waitKey(1)
        if self.save_video and self.video_writer is None:
            h, w, _ = img_bgr.shape
            fourcc = cv2.VideoWriter_fourcc(*'mp4v')
            self.video_writer = cv2.VideoWriter(
                self.video_path, fourcc, self.fps, (w, h))
        if self.save_video and self.video_writer is not None:
            self.video_writer.write(img_bgr)
        return img_rgb

    def close(self):
        if self.video_writer is not None or self.window_initialized:
            import cv2
            if self.video_writer is not None:
                self.video_writer.release()
            if self.window_initialized:
                cv2.destroyWindow(self.window_name)
        super().close()


def make_snake(num_envs: int = 1, num_snakes: int = 4,
               env_id: str = 'Snake-v1', seed: int = 0, device='cuda',
               **kwargs):
    """Main public factory — reference ``make_snake`` (wrappers.py:203-223).

    Returns ``(env, obs_shape, action_shape, properties)``. Unlike the
    reference (which returns ``None`` shapes — wrappers.py:223, a documented
    bug), the shape slots are populated.
    """
    kwargs.pop('render_mode', None)  # accepted & ignored, like gym.make
    if num_envs > 1:
        cfg = _config(env_id, dict(kwargs, num_snakes=num_snakes))
        env = VectorAdapter(cfg, num_envs, seed=seed,
                            graph=ENV_IDS[env_id]['graph'], device=device)
        obs_shape = env.observation_space.shape
        action_n = cfg.num_actions
    else:
        adapter = make(env_id, device=device, num_snakes=num_snakes,
                       seed=seed, **kwargs)
        env = (SingleMultiAgent(adapter) if num_snakes > 1
               else SingleAgent(adapter))
        obs_shape = env.observation_space.shape
        action_n = env.action_space.n

    properties = {
        'action_info': {'action_n': action_n},
        'num_envs': num_envs,
        'num_snakes': num_snakes,
    }
    return env, obs_shape, (action_n,), properties
