"""marlsnake_torch.examples.demo and examples.vector_rollout against the
JAX repository's ``examples/demo.py`` and ``examples/vector_rollout.py``,
on the CPU, each JAX script run as it is (its argument parser and its
module constants narrowed to 8 envs x 16 steps) and its draws handed to
the port. Tolerances: the demo's fruit and death counts, and every field
of the env states after the rollout (env 0's grid, drawn, among them),
EQUAL; the vector rollout's mean reward within 1e-6 (float32 sums in
another order). The three programs run on the card unless the CPU is
asked for, and import no JAX (``test_torch_wrappers.py``).
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.core.render import render_ascii as jax_render_ascii
from marlsnake_torch.core.render import render_ascii
from marlsnake_torch.envs.vector import VectorSnakeEnv, build_vector_fns
from marlsnake_torch.examples import demo
from marlsnake_torch.examples import vector_rollout as V
from marlsnake_torch.rng import StepDraws
from marlsnake_torch.tools import distill_acting
from test_torch_engine import (assert_fields_equal, reset_draws_from_keys,
                               state_from_jax, step_draws_from_keys)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS, STEPS = 8, 16


def jax_example(name: str, argv, monkeypatch):
    """Run the JAX repository's ``examples/NAME.py`` as a module (not as
    ``__main__``) with ``argv``."""
    monkeypatch.setattr(sys, 'argv', [f'{name}.py'] + argv)
    monkeypatch.setattr(sys, 'path', list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'examples', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_draws(cfg, step_fn, states, actions):
    """The step draws JAX's rollout takes from its state keys, step by
    step with ``actions`` (T, B, N); and its end states."""
    step = jax.jit(step_fn)
    draws = []
    for a in actions:
        draws.append(step_draws_from_keys(cfg, states.key))
        states, _ = step(states, jnp.asarray(a))
    return StepDraws(*(torch.stack(f) for f in zip(*draws))), states


def port_start(cfg, keys):
    env = VectorSnakeEnv(cfg, len(keys), device='cpu')
    reset_fn, _ = build_vector_fns(cfg, device='cpu')
    return env, reset_fn(reset_draws_from_keys(cfg, keys))[0]


def test_demo_matches_jax(monkeypatch, capsys):
    """JAX's demo at 8 envs x 16 steps; its rollout of key 0 against the
    port's ``rollout`` with the same actions and draws."""
    mod = jax_example('demo', ['--envs', str(ENVS), '--steps', str(STEPS)],
                      monkeypatch)
    assert 'env 0 of the batch' in capsys.readouterr().out
    key = jax.random.key(0)
    k_reset, k_act = jax.random.split(key)
    keys = jax.random.split(k_reset, ENVS)
    actions = np.stack([np.asarray(jax.random.randint(
        k, (ENVS, mod.cfg.num_snakes), 0, mod.cfg.num_actions))
        for k in jax.random.split(k_act, STEPS)])
    cfg = demo.demo_config()
    draws, replayed = jax_draws(cfg, mod.step_fn,
                                jax.jit(mod.reset_fn)(keys)[0], actions)
    jstates, fruits, deaths = mod.rollout(key)
    assert_fields_equal(jstates, state_from_jax(replayed), 'replay')

    env, states = port_start(cfg, keys)
    states, got_fruits, got_deaths = demo.rollout(
        env, states, torch.as_tensor(actions), draws)
    assert got_fruits.dtype == got_deaths.dtype == torch.int32
    assert (int(got_fruits), int(got_deaths)) == (int(fruits), int(deaths))
    assert int(fruits) > 0 and int(deaths) > 0
    assert_fields_equal(jstates, states, 'after the rollout')
    assert render_ascii(states.grid[0].numpy()) == jax_render_ascii(
        np.asarray(jstates.grid[0]))


def test_vector_rollout_mean_reward_matches_jax(monkeypatch):
    """JAX's vector rollout with its constants narrowed to 8 envs x 16
    steps, key 0, against the port's ``mean_reward`` with its actions and
    draws."""
    mod = jax_example('vector_rollout', [], monkeypatch)
    monkeypatch.setattr(mod, 'NUM_ENVS', ENVS)
    monkeypatch.setattr(mod, 'STEPS', STEPS)
    key = jax.random.key(0)
    want = float(mod.rollout(key))
    keys = jax.random.split(key, ENVS)
    actions = []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        actions.append(np.asarray(jax.random.randint(
            k, (ENVS, mod.cfg.num_snakes), 0, 3)))
    cfg = V.rollout_config()
    draws, _ = jax_draws(cfg, mod.step_fn, jax.jit(mod.reset_fn)(keys)[0],
                         actions)
    env, states = port_start(cfg, keys)
    got = V.mean_reward(env, states, torch.as_tensor(np.stack(actions)),
                        draws)
    assert abs(float(got) - want) <= 1e-6, (float(got), want)


@pytest.mark.parametrize('program', ['demo', 'vector_rollout',
                                     'distill_acting'])
def test_programs_run_on_the_card_unless_asked(program, tmp_path, capsys):
    """Without a card each program raises at its default device; asked
    for the CPU, the demos run and end with their JSON line."""
    main = {'demo': demo.main, 'vector_rollout': V.main,
            'distill_acting': distill_acting.main}[program]
    args = ['--out', str(tmp_path)] if program == 'distill_acting' else []
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        main(args)
    if program == 'demo':
        summary = demo.main(['--cpu', '--envs', '4', '--steps', '8'])
    elif program == 'vector_rollout':
        summary = V.main(['--device', 'cpu'], num_envs=4, steps=8)
    else:
        return
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == summary and summary['card'] == 'cpu'
    assert summary['env_steps_per_s'] > 0
