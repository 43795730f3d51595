"""Optional real-gym registration, the port of the JAX package's
``envs/gym_compat.py``.

The port's own registry (``envs.wrappers.make``) is gym-free but keeps
the reference's env ids. When an actual ``gym`` (or ``gymnasium``) is
importable, :func:`register_gym_envs` additionally registers
``Snake-v1``, ``SnakeCoop-v1`` and ``SnakeGraph-v1`` with it — wrapping
:class:`~marlsnake_torch.envs.wrappers.GymAdapter` in a ``gym.Env``
subclass — so ``gym.make('Snake-v1', num_snakes=4, ...)`` works like the
reference's registration (marlenv/envs/__init__.py:1-16). The env runs on
``device`` (a keyword of ``gym.make``, default ``'cuda'``). gym is
imported only by ``register_gym_envs``; the tests use a minimal
in-process stand-in.
"""

from __future__ import annotations

from marlsnake_torch.envs.wrappers import ENV_IDS, make


def _find_gym():
    for name in ('gym', 'gymnasium'):
        try:
            return __import__(name)
        except ImportError:
            continue
    return None


def _make_env_class(gym, env_id: str):
    class GymSnake(gym.Env):
        """gym.Env facade over the port's GymAdapter."""
        metadata = {'render_modes': ['ascii', 'gif', 'rgb_array',
                                     'human']}

        def __init__(self, **kwargs):
            self._adapter = make(env_id, **kwargs)
            self.action_space = self._adapter.action_space
            self.observation_space = self._adapter.observation_space
            self.num_snakes = self._adapter.num_snakes

        def reset(self, **kwargs):
            return self._adapter.reset()

        def step(self, actions):
            return self._adapter.step(actions)

        def render(self, mode='ascii', **kwargs):
            return self._adapter.render(mode, **kwargs)

        def seed(self, seed=42):
            return self._adapter.seed(seed)

        def close(self):
            self._adapter.close()

        @property
        def unwrapped(self):
            return self._adapter

    GymSnake.__name__ = GymSnake.__qualname__ = \
        f'GymSnake_{env_id.replace("-", "_")}'
    return GymSnake


def register_gym_envs(gym_module=None) -> bool:
    """Register the three env ids with ``gym_module`` (auto-detected
    when None). Returns False when no gym flavor is importable; True
    after registering. Safe to call twice (already-registered ids are
    skipped)."""
    gym = gym_module if gym_module is not None else _find_gym()
    if gym is None:
        return False
    # gym >= 0.22 and gymnasium expose top-level register; older gyms
    # only gym.envs.registration.register
    reg = getattr(gym, 'register', None)
    if reg is None:
        reg = gym.envs.registration.register
    for env_id in ENV_IDS:
        try:
            reg(id=env_id, entry_point=_make_env_class(gym, env_id))
        except Exception:  # already registered — keep going
            continue
    return True
