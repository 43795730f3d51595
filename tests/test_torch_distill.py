"""marlsnake_torch.tools.distill_acting against the JAX repository's
``tools/distill_acting.py``, and the DistilledDQN's weights in both
directions, on the CPU.

JAX's tool is one ``main()`` of closures. The tests run it with a
stand-in for its checkpoint loader (the trained pickle's parameters, as
the port's teacher) and with ``jax.jit`` and ``range`` stood in for, so
that it stops before its first iteration and hands over its ``init`` and
``outer`` functions; those are JAX's own code, rebuilt here at small
sizes by replacing the values they close over. Tolerances, each where it
is used:

* the constants: every count, rate and weight EQUAL to JAX's;
* two chained outer iterations at 4 envs, 4 rollout steps, 3 SGD steps
  of 32, float32 students on both sides (XLA's and torch's bfloat16
  round differently, and a near-tie in a greedy action would part the
  trajectories): the env states, the obs and the buffer of visited obs
  EQUAL, the agreement EQUAL, the labels EQUAL wherever the teacher's
  top-2 Q gap exceeds 1e-4 (the repo's argmax rule), the parameters and
  Adam moments within 1e-5 absolute and the mean loss within 1e-5;
* the student through flax's msgpack, both ways: the bytes EQUAL to
  flax's ``to_bytes``, Q-values within 1e-5 at float32, argmax EQUAL
  where the top-2 gap exceeds 1e-2.
"""

import importlib.util
import json
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from marlsnake_tpu.models.dqn import DistilledDQN as FlaxDistilled
from marlsnake_torch.algo import optim
from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.models.dqn import DistilledDQN
from marlsnake_torch.models.weights import (distilled_dqn_from_flax,
                                            distilled_dqn_to_flax)
from marlsnake_torch.rng import DistillDraws, StepDraws, distill_draws
from marlsnake_torch.tools import distill_acting as D
from marlsnake_torch.algo.neat_hybrid import msgpack_pack, msgpack_unpack
from test_torch_engine import (assert_fields_equal, state_from_jax,
                               step_draws_from_keys)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYBRID = os.path.join(REPO, D.HYBRID)
REAL_JIT = jax.jit
SMALL = dict(rollout_steps=4, sgd_steps=3, batch=32)


class _Stop(Exception):
    pass


def jax_tool(monkeypatch, argv):
    """Run JAX's ``main`` with ``argv`` up to its loop: {'init', 'outer'
    (unjitted), 'free' (what ``outer`` closes over), 'config' (the
    trainer config it loads its teacher with), 'checkpoint', 'lr',
    'vector' (build_vector_fns' arguments), 'iters'}. Nothing is
    written."""
    from marlsnake_tpu.algo import dqn_trainer as JD
    spec = importlib.util.spec_from_file_location(
        'jax_distill_acting', os.path.join(REPO, 'tools',
                                           'distill_acting.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}
    teacher = load_hybrid_raw(HYBRID)['dqn_params']

    class Trainer:
        def __init__(self, config):
            got['config'] = config

        def init_state(self):
            return None

        def load_checkpoint(self, name, ts):
            got['checkpoint'] = name
            return types.SimpleNamespace(params=teacher), None

    def jit(fn, *args, **kwargs):
        if getattr(fn, '__name__', None) not in ('init', 'outer'):
            return REAL_JIT(fn, *args, **kwargs)
        got[fn.__name__] = fn
        return (lambda key: (None,) * 4) if fn.__name__ == 'init' else fn

    def loop_range(n):
        got['iters'] = n
        raise _Stop

    real_adam, real_fns = optax.adam, mod.build_vector_fns

    def adam(lr, *args, **kwargs):
        got['lr'] = lr
        return real_adam(lr, *args, **kwargs)

    def build_vector_fns(cfg, **kwargs):
        got['vector'] = (cfg, kwargs)
        return real_fns(cfg, **kwargs)

    monkeypatch.setattr(JD, 'DQNTrainer', Trainer)
    monkeypatch.setattr(jax, 'jit', jit)
    monkeypatch.setattr(optax, 'adam', adam)
    monkeypatch.setattr(mod, 'build_vector_fns', build_vector_fns)
    monkeypatch.setattr(mod, 'range', loop_range, raising=False)
    monkeypatch.setattr(sys, 'argv', ['distill_acting.py'] + argv)
    with pytest.raises(_Stop):
        mod.main()
    outer = got['outer']
    got['free'] = dict(zip(outer.__code__.co_freevars,
                           (c.cell_contents for c in outer.__closure__)))
    return got


def rebind(fn, **values):
    """``fn`` with the values it closes over replaced where named."""
    cells = tuple(types.CellType(values[name]) if name in values else cell
                  for name, cell in zip(fn.__code__.co_freevars,
                                        fn.__closure__))
    return types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                              fn.__defaults__, cells)


def float_consts(code) -> list:
    out = []
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            out += float_consts(c)
        elif isinstance(c, float):
            out.append(c)
    return out


def test_constants_are_the_jax_tool_s(monkeypatch):
    """Every constant of JAX's tool, field for field: the rollout, SGD and
    batch sizes, the learning rate, the soft term's weight, the default
    counts (iterations, envs, student widths), the env, the teacher and
    the student as JAX builds them."""
    got = jax_tool(monkeypatch, [])
    free = got['free']
    assert (free['rollout_steps'], free['sgd_steps'], free['batch']) == (
        D.ROLLOUT_STEPS, D.SGD_STEPS, D.BATCH)
    assert got['lr'] == D.LR
    assert float_consts(got['outer'].__code__) == [D.SOFT_WEIGHT]
    student = free['student']
    assert dict(outer_iters=got['iters'], num_envs=free['e'],
                conv=student.conv_channels,
                fc=student.fc_features) == D.DEFAULTS
    assert student.compute_dtype == jnp.bfloat16 and student.num_actions == 3
    port = D.make_student(D.env_config(), D.DEFAULTS['conv'],
                          D.DEFAULTS['fc'], 'cpu')
    assert port.compute_dtype == torch.bfloat16 and port.assume_binary_obs
    assert student.assume_binary_obs
    teacher = free['teacher']
    assert teacher.assume_binary_obs and teacher.num_actions == 3
    assert teacher.compute_dtype == jnp.float32
    cfg, kwargs = got['vector']
    assert kwargs == {'autoreset': True}
    mine = D.env_config()
    for name in type(cfg).__dataclass_fields__:
        assert getattr(mine, name) == getattr(cfg, name), name
    c = got['config']
    assert (c.height, c.width, c.num_snakes, c.snake_length) == (
        mine.height, mine.width, mine.num_snakes, mine.snake_length)
    assert got['checkpoint'] == 'showcase20'


def jax_indices(key, sgd_steps: int, batch: int, rows: int) -> torch.Tensor:
    """The rows JAX's SGD scan draws (tools/distill_acting.py:96, :108)."""
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.randint(k, (batch,), 0, rows))
        for k in jax.random.split(key, sgd_steps)]).astype(np.int64))


def jax_rollout(free, fstudent, s_params, states, obs, steps: int):
    """JAX's rollout step by step, as ``outer`` scans it: (the step draws
    its state keys give, the visited obs (T*E*N, H, W, C), the end)."""
    cfg = D.env_config()
    apply, step = REAL_JIT(fstudent.apply), REAL_JIT(free['step_fn'])
    draws, traj = [], []
    for _ in range(steps):
        traj.append(np.asarray(obs))
        acts = apply(s_params, obs.reshape((-1,) + obs.shape[2:])).argmax(-1)
        draws.append(step_draws_from_keys(cfg, states.key))
        states, out = step(states, acts.astype(jnp.int32).reshape(
            obs.shape[:2]))
        obs = out.obs
    step_draws = StepDraws(*(torch.stack(f) for f in zip(*draws)))
    traj = np.stack(traj)
    return step_draws, traj.reshape((-1,) + traj.shape[3:]), states, obs


def assert_tree_close(port: dict, flax_tree, where: str) -> None:
    want = jax.tree.leaves_with_path(flax_tree)
    got = dict(jax.tree.leaves_with_path(distilled_dqn_to_flax(port)))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=f'{where} {path}')


def test_two_outer_iterations_match_jax(monkeypatch):
    """JAX's own ``init`` and ``outer`` at 4 envs, 4 rollout steps and 3
    SGD steps of 32, float32 students, the trained teacher; the port's
    ``outer_iteration`` from the same start with JAX's draws, twice in a
    chain."""
    got = jax_tool(monkeypatch, ['1', '4'])
    free = got['free']
    fstudent = FlaxDistilled(num_actions=3, conv_channels=(16, 32),
                             fc_features=(64,), compute_dtype=jnp.float32)
    init = REAL_JIT(rebind(got['init'], student=fstudent))
    outer = REAL_JIT(rebind(got['outer'], student=fstudent, **SMALL))
    teacher_apply = REAL_JIT(free['teacher'].apply)
    states, obs, s_params, opt_state = init(jax.random.key(0))

    cfg = D.env_config()
    env = VectorSnakeEnv(cfg, 4, device='cpu')
    student = DistilledDQN((20, 20), conv_channels=(16, 32),
                           fc_features=(64,), compute_dtype=torch.float32,
                           device='cpu')
    teacher = D.make_teacher(free['t_params'], cfg, 'cpu')
    params = distilled_dqn_from_flax(s_params)
    topt = optim.adam_init(list(params.values()))
    tstates = state_from_jax(states)
    tobs = torch.as_tensor(np.array(obs))
    rows = SMALL['rollout_steps'] * 4 * cfg.num_snakes
    clear_labels = 0
    for it in range(2):
        key = jax.random.key(100 + it)
        step_draws, data, end_states, end_obs = jax_rollout(
            free, fstudent, s_params, states, obs, SMALL['rollout_steps'])
        idx = jax_indices(key, SMALL['sgd_steps'], SMALL['batch'], rows)
        res = D.outer_iteration(env, teacher, student, params, topt,
                                tstates, tobs, DistillDraws(step_draws, idx))
        states, obs, s_params, opt_state, loss, agree = outer(
            states, obs, s_params, opt_state, key)
        where = f'iteration {it}'
        assert_fields_equal(end_states, state_from_jax(states), where)
        assert_fields_equal(states, res.states, where)
        np.testing.assert_array_equal(np.asarray(obs), res.obs.numpy())
        np.testing.assert_array_equal(data, res.data.numpy())
        assert np.array_equal(np.asarray(end_obs), np.asarray(obs))

        t_q = np.asarray(teacher_apply(free['t_params'], data))
        top2 = np.sort(t_q, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(res.labels.numpy()[clear],
                                      t_q.argmax(-1)[clear], err_msg=where)
        clear_labels += int(clear.sum())
        assert float(res.agreement) == float(agree), where
        assert abs(float(res.loss) - float(loss)) <= 1e-5, where
        assert_tree_close(res.params, s_params, f'{where} params')
        adam = opt_state[0]
        assert int(res.opt_state.count) == int(adam.count) \
            == SMALL['sgd_steps'] * (it + 1)
        names = list(res.params)
        assert_tree_close(dict(zip(names, res.opt_state.mu)), adam.mu,
                          f'{where} mu')
        assert_tree_close(dict(zip(names, res.opt_state.nu)), adam.nu,
                          f'{where} nu')
        tstates, tobs, params, topt = res[:4]
    assert clear_labels > rows


def test_distill_draws_are_one_iteration_s():
    cfg = D.env_config()
    gen = torch.Generator().manual_seed(0)
    d = distill_draws(cfg, 3, 5, 7, 11, gen, 'cpu')
    assert d.step.fruit_u.shape == (5, 3, 4)
    assert d.step_at(2).reset_fruit_u.shape == (3, cfg.resolved_num_fruits)
    assert d.idx.shape == (7, 11) and d.idx.dtype == torch.int64
    assert int(d.idx.min()) >= 0 and int(d.idx.max()) < 5 * 3 * 4


def test_port_student_reads_in_jax():
    """A port student through ``distilled_dqn_to_flax`` and the msgpack
    writer: flax's ``from_bytes`` reads it, ``to_bytes`` writes the same
    bytes back once the tree is rebuilt as the JAX tool's trained
    parameters are (``jax.tree.map`` sorts a dict's keys), and JAX's
    DistilledDQN gives its Q-values."""
    cfg = D.env_config()
    student = D.make_student(cfg, (16, 32), (64,), 'cpu', torch.float32,
                             seed=3)
    sd = student.state_dict()
    blob = msgpack_pack(distilled_dqn_to_flax(sd))
    fnet = FlaxDistilled(num_actions=3, conv_channels=(16, 32),
                         fc_features=(64,), compute_dtype=jnp.float32)
    target = fnet.init(jax.random.key(0), jnp.zeros((1, 20, 20, 8)))
    params = serialization.from_bytes(target, blob)
    assert serialization.to_bytes(jax.tree.map(np.asarray, params)) == blob
    back = distilled_dqn_from_flax(msgpack_unpack(blob))
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    obs = (np.random.default_rng(5).random((16, 20, 20, 8)) < 0.2).astype(
        np.uint8)
    with torch.no_grad():
        q = student(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(q, np.asarray(fnet.apply(params, obs)),
                               rtol=0, atol=1e-5)


def test_committed_jax_student_reads_in_the_port():
    """JAX's committed student (artifacts/distilled_acting.msgpack, conv
    32,64, fc 128) through the port's reader (and back through its
    writer, byte for byte): its Q-values on env obs match JAX's at
    float32."""
    path = os.path.join(REPO, 'artifacts', 'distilled_acting.msgpack')
    with open(path + '.meta.json') as f:
        meta = json.load(f)
    with open(path, 'rb') as f:
        blob = f.read()
    tree = msgpack_unpack(blob)
    assert msgpack_pack(tree) == blob
    cfg = D.env_config()
    student = DistilledDQN((20, 20), conv_channels=meta['conv_channels'],
                           fc_features=meta['fc_features'],
                           compute_dtype=torch.float32, device='cpu')
    student.load_state_dict(distilled_dqn_from_flax(tree))
    env = VectorSnakeEnv(cfg, 8, device='cpu', seed=1)
    states, obs = env.reset()
    gen = torch.Generator().manual_seed(2)
    for _ in range(6):
        acts = torch.randint(0, 3, (8, 4), generator=gen, dtype=torch.int32)
        states, out = env.step(states, acts)
    flat = out.obs.flatten(0, 1)
    with torch.no_grad():
        q = student(flat).numpy()
    fnet = FlaxDistilled(num_actions=3,
                         conv_channels=tuple(meta['conv_channels']),
                         fc_features=tuple(meta['fc_features']),
                         compute_dtype=jnp.float32)
    qj = np.asarray(REAL_JIT(fnet.apply)(serialization.msgpack_restore(blob),
                                         flat.numpy()))
    np.testing.assert_allclose(q, qj, rtol=0, atol=1e-5)
    top2 = np.sort(qj, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    assert clear.sum() > len(qj) // 2
    np.testing.assert_array_equal(q.argmax(-1)[clear], qj.argmax(-1)[clear])


def test_command_line_takes_jax_s_positional_counts(monkeypatch):
    calls = []
    monkeypatch.setattr(D, 'run', lambda *a, **k: calls.append((a, k)))
    D.main([])
    D.main(['200', '256', '32,64', '128', '--device', 'cpu'])
    assert calls[0][0][:4] == tuple(D.DEFAULTS.values())
    assert calls[1][0][:4] == tuple(D.COMMITTED.values())
    assert calls[0][1] == {'device': 'cuda'} \
        and calls[1][1] == {'device': 'cpu'}


def test_run_writes_student_and_meta(tmp_path, capsys):
    """A short run on the CPU: JAX's print lines, the meta's keys (JAX's
    and the card), a student that flax reads, and a narrowed run refused
    into the committed directory before anything is written."""
    summary = D.run(3, 2, (4,), (8,), out=str(tmp_path), device='cpu',
                    rollout_steps=2, sgd_steps=2, batch=8)
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:9] for ln in lines[:2]] == ['iter   0 ', 'iter   2 ']
    assert all(re.fullmatch(r'iter +\d+ \| loss \d+\.\d{4} \| agreement '
                            r'\d+\.\d{2}% \| \d+s', ln) for ln in lines[:2])
    assert json.loads(lines[-1]) == json.loads(json.dumps(summary))
    with open(tmp_path / 'distilled_acting.msgpack.meta.json') as f:
        meta = json.load(f)
    assert list(meta) == ['agreement_pct', 'conv_channels', 'fc_features',
                          'teacher', 'outer_iters', 'num_envs', 'card']
    assert meta['card'] == 'cpu' and meta['conv_channels'] == [4]
    assert meta['agreement_pct'] == round(summary['agreement'] * 100, 2)
    with open(tmp_path / 'ckpt' / 'distilled_acting.msgpack', 'rb') as f:
        blob = f.read()
    fnet = FlaxDistilled(num_actions=3, conv_channels=(4,), fc_features=(8,))
    target = fnet.init(jax.random.key(0), jnp.zeros((1, 20, 20, 8)))
    assert serialization.to_bytes(jax.tree.map(
        np.asarray, serialization.from_bytes(target, blob))) == blob
    with pytest.raises(ValueError, match='give it another out'):
        D.main(['3', '2', '--device', 'cpu', '--out',
                os.path.join(REPO, D.OUT_DIR)])
