"""The PPO trainer's nets by the name ``PPOConfig.net`` gives them.

``NETS`` maps each name to a function ``make(config, env_cfg, device)``
that reads what it needs of the ``PPOConfig`` and returns the net. A net
the trainer takes is an ``nn.Module`` that it applies to parameters it
holds itself (``torch.func.functional_call``), with:

* ``forward(obs, phases=False)``: (logits (M, A), value (M,)), both
  float32, of per-agent obs rows (M, H, W, C) as ``ingress`` gives them;
  ``phases``, which the rollout sets, places the net's tracer marks where
  it has any.
* ``ingress(obs)``: the obs as the envs emit them (the rollout buffer's
  bytes) -> what ``forward`` takes; fixed when the net is built.
* ``initial_state()``: the ``state_dict`` that training starts from.
* ``step_buffers(buffers)``, only where that state holds buffers (tensors
  no gradient moves): their values after an optimizer step, from what the
  last forward saw. Nothing all-reduces them, so the trainer refuses a
  mesh for such a net.

A further net is its own model file and one entry here.
"""

from __future__ import annotations

from typing import Callable, Dict

from torch import nn

from marlsnake_torch.models.moonlight import make_moonlight_agent
from marlsnake_torch.models.ppo import make_actor_critic


def _actor_critic(config, env_cfg, device) -> nn.Module:
    return make_actor_critic(env_cfg, config.seed, device,
                             config.assume_binary_obs, config.compute_dtype)


def _moonlight_agent(config, env_cfg, device) -> nn.Module:
    # no weights: initial_state draws them from the seed when asked
    return make_moonlight_agent(config.moonlight, env_cfg.obs_shape[1:],
                                config.seed, device, config.compute_dtype,
                                weights=False)


NETS: Dict[str, Callable[..., nn.Module]] = {
    'actor_critic': _actor_critic,
    'moonlight_agent': _moonlight_agent,
}


def make_policy(config, env_cfg, device) -> nn.Module:
    """The net ``config.net`` names, for ``env_cfg``'s obs on ``device``."""
    if config.net not in NETS:
        raise ValueError(f'unknown net {config.net!r}')
    return NETS[config.net](config, env_cfg, device)
