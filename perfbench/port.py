"""The program's view of a configuration file."""

from __future__ import annotations

from marlsnake_torch.core.types import EnvConfig


def env_config(config: dict) -> EnvConfig:
    """The program's ``EnvConfig`` of a configuration file's env."""
    e = config['env']
    return EnvConfig.from_reward_dict(
        e['rewards'], height=e['height'], width=e['width'],
        num_snakes=e['num_snakes'], snake_length=e['snake_length'],
        spawn_mode=e['spawn_mode'], spawn_pool_size=e['spawn_pool_size'],
        max_episode_steps=e['max_episode_steps'],
        num_fruits=e['num_fruits'])


def check_env(got: EnvConfig, config: dict) -> None:
    """Raise where a program object's env is not the configuration's."""
    want = env_config(config)
    if got != want:
        raise ValueError(f'the program runs {got}, the configuration '
                         f'states {want}')
