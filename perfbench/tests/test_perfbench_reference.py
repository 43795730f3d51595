"""The plain reference against the program's plain versions, at tiny
sizes on the CPU: the engine field by field, the nets, clipped Adam."""

import dataclasses

import pytest
import torch

from marlsnake_torch.algo import optim
from marlsnake_torch.core import engine
from marlsnake_torch.models.dqn import make_dqn
from marlsnake_torch.models.ppo import make_actor_critic
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.rng import ResetDraws, StepDraws
from perfbench import port
from perfbench.reference import engine as ref
from perfbench.reference import nets
from perfbench.tests import tiny

GAME = dict(rewards={'fruit': 10.0, 'kill': 2.0, 'lose': -0.5, 'win': 3.0,
                     'time': -0.01}, spawn_pool_size=4096,
            max_episode_steps=40, num_fruits=-1)


def _config(spawn_mode: str, snakes: int = 3, length: int = 4) -> dict:
    return {'env': dict(GAME, height=9, width=10, num_snakes=snakes,
                        snake_length=length, spawn_mode=spawn_mode)}


def _assert_equal(prog, want) -> None:
    for name, value in ref.fields(want).items():
        assert torch.equal(getattr(prog, name), value), name


@pytest.mark.parametrize('spawn_mode', ['pool', 'procedural'])
def test_engine_autoreset_equals_program(spawn_mode):
    config = _config(spawn_mode)
    cfg = port.env_config(config)
    eng = ref.Engine(ref.game_from_config(config['env']), 'cpu')
    tables = engine.spawn_tables(cfg, 'cpu')
    g = torch.Generator().manual_seed(3)
    b, n, nf = 16, cfg.num_snakes, cfg.resolved_num_fruits
    spawn = (b, n, 4) if spawn_mode == 'procedural' else (b,)
    reset = ResetDraws(torch.rand(spawn, generator=g),
                       torch.rand((b, nf), generator=g))
    p_state, p_obs = engine.reset(cfg, tables, reset)
    r_state, r_obs = eng.reset(*reset)
    _assert_equal(p_state, r_state)
    assert torch.equal(p_obs, r_obs)
    ends = 0
    for _ in range(60):
        acts = torch.randint(0, 3, (b, n), generator=g, dtype=torch.int32)
        d = StepDraws(torch.rand((b, n), generator=g),
                      torch.rand(spawn, generator=g),
                      torch.rand((b, nf), generator=g))
        p_state, p_out = engine.step_autoreset(cfg, tables, p_state, acts, d)
        r_state, r_out = eng.step_autoreset(r_state, acts, *d)
        _assert_equal(p_state, r_state)
        _assert_equal(p_out, r_out)
        ends += int(r_out.done_all.sum())
    assert ends > 0


def test_engine_step_with_hold_equals_program():
    config = _config('pool', snakes=2, length=5)
    cfg = port.env_config(config)
    eng = ref.Engine(ref.game_from_config(config['env']), 'cpu')
    g = torch.Generator().manual_seed(5)
    b, n, nf = 12, cfg.num_snakes, cfg.resolved_num_fruits
    reset = ResetDraws(torch.rand((b,), generator=g),
                       torch.rand((b, nf), generator=g))
    p_state, _ = engine.reset(cfg, engine.spawn_tables(cfg, 'cpu'), reset)
    r_state, _ = eng.reset(*reset)
    keep = torch.zeros(b, dtype=torch.bool)
    p_out = r_out = None
    for _ in range(30):
        acts = torch.randint(0, 3, (b, n), generator=g, dtype=torch.int32)
        fruit = torch.rand((b, n), generator=g)
        p_state, p_out = step_kernel.step(
            cfg, p_state, acts, fruit,
            None if p_out is None else (keep, p_out))
        r_state, r_out = eng.step(r_state, acts, fruit,
                                  None if r_out is None else (keep, r_out))
        _assert_equal(p_state, r_state)
        _assert_equal(p_out, r_out)
        keep = keep | r_out.done_all
    assert keep.any()


def test_nets_equal_program():
    config = _config('pool')
    cfg = port.env_config(config)
    g = torch.Generator().manual_seed(1)
    obs = (torch.rand((6,) + cfg.obs_shape[1:], generator=g) < 0.2).to(
        torch.uint8)
    for make, layout, fwd in (
            (make_dqn, nets.dqn_layout, nets.dqn),
            (make_actor_critic, nets.actor_critic_layout,
             nets.actor_critic)):
        net = make(cfg, 0, 'cpu')
        shapes = layout(cfg.height, cfg.width, 8, cfg.num_actions)
        assert [(k, tuple(v.shape)) for k, v in net.state_dict().items()] \
            == shapes
        p = nets.init_params(shapes, g, 'cpu')
        got = torch.func.functional_call(net, p, (obs,))
        want = fwd(p, obs)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize('max_norm', [0.5, 1e3])
def test_adam_equals_program(max_norm):
    g = torch.Generator().manual_seed(2)
    params = {'a': torch.randn(7, 3, generator=g),
              'b': torch.randn(5, generator=g)}
    adam = nets.Adam(params, 1e-3, 1e-8, max_norm)
    p_ref = dict(params)
    p_prog, state = list(params.values()), optim.adam_init(
        list(params.values()))
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in
                 params.items()}
        p_ref = adam.step(p_ref, grads)
        clipped = optim.clip_by_global_norm(list(grads.values()), max_norm)
        updates, state = optim.adam_update(clipped, state, 1e-3)
        p_prog = optim.apply_updates(p_prog, updates)
        for got, want in zip(p_prog, p_ref.values()):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-7)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ('import sys; import perfbench.reference.engine, '
            'perfbench.reference.nets, perfbench.reference.learners; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"marlsnake_torch", "marlsnake_tpu", "jax"}))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd=tiny.harness.ROOT)
    assert out.stdout.strip() == '[]'


def test_fields_cover_the_programs_state():
    """Every field the reference compares is a field of the program's
    state and step output."""
    from marlsnake_torch.core.state import EnvState
    prog = {f.name for f in dataclasses.fields(EnvState)} | {
        f.name for f in dataclasses.fields(engine.StepOutput)}
    mine = {f.name for f in dataclasses.fields(ref.State)} | {
        f.name for f in dataclasses.fields(ref.Out)}
    assert mine <= prog
    assert prog - mine == {'hist_grid', 'obs_stack'}
