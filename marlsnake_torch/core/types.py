"""Constants and the static environment configuration.

The port's own copy of ``marlsnake_tpu/core/types.py`` (numpy only): the
same cell codes, direction model, turn tables, rewards and
:class:`EnvConfig`, so that a config means the same game in both
packages.

* A grid cell stores ``cell_type | (snake_idx << OWNER_SHIFT)``.
* Directions index ``DIR_DELTA`` in the order UP, RIGHT, DOWN, LEFT, so a
  relative left turn is ``(d - 1) % 4`` and a right turn ``(d + 1) % 4``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# --- cell model ---
EMPTY = 0
WALL = 1
FRUIT = 2
HEAD = 3
BODY = 4
TAIL = 5

OWNER_SHIFT = 4
TYPE_MASK = (1 << OWNER_SHIFT) - 1


def cell_type(cell):
    """Cell-type field (EMPTY..TAIL) of packed cell value(s)."""
    return cell & TYPE_MASK


def cell_owner(cell):
    """Owning snake index of packed cell value(s) (0 for env cells)."""
    return cell >> OWNER_SHIFT


def pack_cell(ctype, owner):
    """Pack type + owner into a cell value."""
    return ctype + (owner << OWNER_SHIFT)


# Observation: 8 one-hot channels per cell: wall, fruit, other
# head/body/tail, my head/body/tail.
FEATURE_CHANNEL = 8
CH_WALL = 0
CH_FRUIT = 1
CH_OTHER_HEAD = 2
CH_OTHER_BODY = 3
CH_OTHER_TAIL = 4
CH_MY_HEAD = 5
CH_MY_BODY = 6
CH_MY_TAIL = 7

# --- direction model ---
UP, RIGHT, DOWN, LEFT = 0, 1, 2, 3
DIR_DELTA = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)], dtype=np.int32)

# observer='snake': actions 0=noop, 1=left, 2=right; 3 and 4 are no-ops.
TURN_SNAKE = np.zeros((4, 5), dtype=np.int32)
for _d in range(4):
    TURN_SNAKE[_d] = (_d, (_d - 1) % 4, (_d + 1) % 4, _d, _d)

# observer='human': actions 0=noop, 1=left, 2=right, 3=down, 4=up; only
# moves that switch axis are honoured.
TURN_HUMAN = np.zeros((4, 5), dtype=np.int32)
for _d in range(4):
    for _a in range(5):
        _nd = _d
        _dr, _dc = DIR_DELTA[_d]
        if _dr == 0:
            if _a == 3:
                _nd = DOWN
            elif _a == 4:
                _nd = UP
        elif _dc == 0:
            if _a == 1:
                _nd = LEFT
            elif _a == 2:
                _nd = RIGHT
        TURN_HUMAN[_d, _a] = _nd

DEFAULT_REWARDS = {
    'fruit': 10.0,
    'kill': 0.0,
    'lose': -0.5,
    'win': 0.0,
    'time': -0.001,
}
REWARD_KEYS = ('fruit', 'kill', 'lose', 'win', 'time')


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (hashable).

    Field names, defaults and checks are those of the JAX package's
    ``EnvConfig``; every option runs in the plain engine and in the CUDA
    step kernel.
    """

    height: int = 20
    width: int = 20
    num_snakes: int = 4
    snake_length: int = 3
    vision_range: Optional[int] = None
    frame_stack: int = 1
    observer: str = 'snake'
    # (fruit, kill, lose, win, time)
    rewards: Tuple[float, float, float, float, float] = (
        DEFAULT_REWARDS['fruit'], DEFAULT_REWARDS['kill'],
        DEFAULT_REWARDS['lose'], DEFAULT_REWARDS['win'],
        DEFAULT_REWARDS['time'],
    )
    num_fruits: int = -1  # -1 -> round(0.8 * num_snakes)
    max_episode_steps: int = 10_000
    # 'all': the episode ends when every snake is done; 'any' (coop): it
    # ends when any snake is done, and done is broadcast to all.
    done_mode: str = 'all'
    # Optional ASCII wall layout ('#' = wall); overrides height/width.
    map_layout: Optional[Tuple[str, ...]] = None
    # Rows of the host-precomputed pool of disjoint spawn combinations.
    spawn_pool_size: int = 1 << 16
    spawn_mode: str = 'pool'
    spawn_orientations: str = 'horizontal'
    obs_format: str = 'uint8'

    def __post_init__(self):
        if self.map_layout is not None:
            from marlsnake_torch.core.maps import parse_layout
            mask = parse_layout(self.map_layout)
            object.__setattr__(self, 'map_layout', tuple(self.map_layout))
            object.__setattr__(self, 'height', mask.shape[0])
            object.__setattr__(self, 'width', mask.shape[1])
        if self.observer not in ('snake', 'human'):
            raise ValueError(f'unknown observer {self.observer!r}')
        if self.done_mode not in ('all', 'any'):
            raise ValueError(f'unknown done_mode {self.done_mode!r}')
        if self.snake_length < 2:
            raise ValueError('snake_length must be >= 2')
        if self.spawn_mode not in ('pool', 'procedural'):
            raise ValueError(f'unknown spawn_mode {self.spawn_mode!r}')
        if self.spawn_orientations not in ('horizontal', 'both'):
            raise ValueError(
                f'unknown spawn_orientations {self.spawn_orientations!r}')
        if self.obs_format not in ('uint8', 'packed'):
            raise ValueError(f'unknown obs_format {self.obs_format!r}')
        if self.spawn_mode == 'procedural':
            if self.map_layout is not None:
                raise ValueError('procedural spawn supports plain '
                                 'bordered boards only (no map_layout)')
            if self.height - 2 < self.num_snakes:
                raise ValueError(
                    f'procedural spawn needs >= 1 interior row per '
                    f'snake: height={self.height} num_snakes='
                    f'{self.num_snakes}')
            if self.width - 2 < self.snake_length:
                raise ValueError(
                    f'procedural spawn needs snake_length <= width-2: '
                    f'snake_length={self.snake_length} '
                    f'width={self.width}')
        if len(self.rewards) != 5:
            raise ValueError('rewards must be a 5-tuple '
                             '(fruit, kill, lose, win, time)')

    @staticmethod
    def from_reward_dict(reward_dict=None, **kwargs) -> 'EnvConfig':
        """Build a config from a reference-style ``reward_dict`` whose keys
        must be exactly ``REWARD_KEYS``."""
        if reward_dict is None:
            reward_dict = DEFAULT_REWARDS
        if set(reward_dict.keys()) != set(REWARD_KEYS):
            raise KeyError(
                f'reward dict keys must correspond to {REWARD_KEYS}')
        rewards = tuple(float(reward_dict[k]) for k in REWARD_KEYS)
        return EnvConfig(rewards=rewards, **kwargs)

    @property
    def resolved_num_fruits(self) -> int:
        if self.num_fruits >= 0:
            return self.num_fruits
        return int(round(self.num_snakes * 0.8))

    @property
    def num_actions(self) -> int:
        return 5 if self.observer == 'human' else 3

    @property
    def obs_height(self) -> int:
        return (2 * self.vision_range + 1) if self.vision_range \
            else self.height

    @property
    def obs_width(self) -> int:
        return (2 * self.vision_range + 1) if self.vision_range \
            else self.width

    @property
    def frame_channels(self) -> int:
        return 1 if self.obs_format == 'packed' else FEATURE_CHANNEL

    @property
    def obs_channels(self) -> int:
        return self.frame_channels * self.frame_stack

    @property
    def obs_shape(self) -> Tuple[int, int, int, int]:
        """(num_snakes, H, W, C)."""
        return (self.num_snakes, self.obs_height, self.obs_width,
                self.obs_channels)

    @property
    def hist_mode(self) -> bool:
        """True when the frame stack is carried as ``frame_stack - 1`` raw
        grids that are re-encoded for every obs (full-obs configs). Vision
        configs carry their encoded window frames instead."""
        return self.frame_stack > 1 and not self.vision_range

    @property
    def spawn_vertical(self) -> bool:
        """True when the procedural spawn also draws vertical segments:
        asked for, and a band of rows is tall enough for one."""
        return (self.spawn_orientations == 'both'
                and (self.height - 2) // self.num_snakes
                >= self.snake_length)

    @property
    def body_capacity(self) -> int:
        """Max body length: a snake can never exceed the interior area."""
        return (self.height - 2) * (self.width - 2)

    def reward(self, name: str) -> float:
        """The reward of ``name``, one of ``REWARD_KEYS``."""
        return self.rewards[REWARD_KEYS.index(name)]
