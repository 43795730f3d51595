"""marlsnake_torch.bench_table against the JAX repository's
``bench_table.py``, on the CPU.

* the table: the JAX program is run with its ``measure`` and
  ``measure_acting`` replaced by stand-ins that record what they were
  given, in a temporary directory; every row's tag, env count, scan
  length, kind and ``EnvConfig`` (every field) EQUAL to the port's;
* the configs the CUDA step kernel had not met before this table (both
  8-snake maps with a frame stack of 4, uint8 and packed; 40x40_ml2;
  10x10x1): 2 envs x 8 steps of the port's vector env with auto-reset on
  the CPU EQUAL, field for field, to JAX's ``build_vector_fns`` on JAX's
  draws;
* the acting rows' policy: the float32 net within 1e-5 of JAX's forward
  with the same (trained) weights (``weights.dqn_from_flax``); the
  ``_opt`` row's
  input EQUAL to JAX's re-encoded, padded frame, and its bfloat16 greedy
  actions equal to JAX's wherever JAX's top two Q-values are more than
  1e-2 apart;
* the file: JAX's keys, and ``card``.
"""

import dataclasses
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_torch import bench
from marlsnake_torch import bench_table as BT
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.models.weights import dqn_from_flax
from test_torch_engine import (_t, assert_fields_equal,
                               reset_draws_from_keys, state_from_jax,
                               step_draws_from_keys)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_bench_table():
    spec = importlib.util.spec_from_file_location(
        'jax_bench_table', os.path.join(REPO, 'bench_table.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_rows_are_jax_s(monkeypatch, tmp_path):
    """The 17 rows in JAX's order: tag, env count, scan length, kind and
    config field for field; the committed JAX table has the same tags,
    env counts and scan lengths."""
    jb = jax_bench_table()
    calls = []

    def measure(cfg, num_envs, num_steps=256, graph=False, **kw):
        calls.append(('graph' if graph else 'rollout', cfg, num_envs,
                      num_steps, False))
        return {'steps_per_sec': 1.0}

    def measure_acting(cfg, num_envs, num_steps=64, optimized=False, **kw):
        calls.append(('acting', cfg, num_envs, num_steps, optimized))
        return {'steps_per_sec': 1.0}

    monkeypatch.setattr(jb, 'measure', measure)
    monkeypatch.setattr(jb, 'measure_acting', measure_acting)
    monkeypatch.chdir(tmp_path)
    jb.main()
    tags = [r['config'] for r in json.load(
        open(tmp_path / 'artifacts' / 'BENCH_TABLE.json'))['rows']]
    rows = list(BT.table())
    assert len(rows) == len(calls) == len(tags) == 17
    for row, (kind, cfg, n, steps, opt), tag in zip(rows, calls, tags):
        assert (row.tag, row.kind, row.num_envs, row.scan_steps,
                row.optimized) == (tag, kind, n, steps, opt)
        assert fields(row.cfg) == fields(cfg), tag
    refs = {tag: ref for tag, _, _, ref in jb.CONFIGS}
    assert {r.tag: r.reference for r in rows if r.kind == 'rollout'} == refs
    assert BT.LONG_SCAN == jb.LONG_SCAN
    committed = json.load(open(os.path.join(REPO, 'artifacts',
                                            'BENCH_TABLE.json')))['rows']
    assert [(r['config'], r['num_envs'], r['scan_steps']) for r in committed] \
        == [(r.tag, r.num_envs, r.scan_steps) for r in rows]


NEW_K1 = ['20x20cross_x8_framestack4', '20x20cross_x8_framestack4_packedobs',
          '30x30walls_x8_framestack4', '30x30walls_x8_framestack4_packedobs',
          '40x40ml2_x4', '10x10x1']


@pytest.mark.parametrize('tag', NEW_K1)
def test_new_kernel_configs_match_jax(tag):
    """2 envs x 8 random-action steps with auto-reset: every state field
    and output EQUAL to JAX's vector env on JAX's draws."""
    from marlsnake_tpu.envs.vector import build_vector_fns as jax_fns
    jb = jax_bench_table()
    jcfg = next(c for t, _, c, _ in jb.CONFIGS if t == tag)
    cfg = next(r.cfg for r in BT.table() if r.tag == tag)
    jreset, jstep = (jax.jit(f) for f in jax_fns(jcfg, autoreset=True))
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=True, device='cpu')
    keys = jax.random.split(jax.random.key(13), 2)
    jstate, jobs = jreset(keys)
    state, obs = reset_fn(reset_draws_from_keys(cfg, keys))
    assert_fields_equal(jstate, state, 'reset')
    np.testing.assert_array_equal(np.asarray(jobs), obs.numpy())
    rng = np.random.default_rng(len(tag))
    for t in range(8):
        actions = rng.integers(0, 3, size=(2, cfg.num_snakes)).astype(
            np.int32)
        draws = step_draws_from_keys(cfg, jstate.key)
        jstate, jout = jstep(jstate, jnp.asarray(actions))
        state, out = step_fn(state, _t(actions), draws)
        assert_fields_equal(jstate, state, f'state t={t}')
        assert_fields_equal(jout, out, f'out t={t}')


@functools.lru_cache(maxsize=None)
def acting_reset():
    """JAX's reset of 2 envs of the acting config: (config, state, obs)."""
    from marlsnake_tpu.envs.vector import build_vector_fns as jax_fns
    jcfg = jax_bench_table().EnvConfig(**fields(BT.ACTING_CONFIG))
    reset_fn, _ = jax_fns(jcfg, autoreset=True)
    return (jcfg,) + tuple(jax.jit(reset_fn)(
        jax.random.split(jax.random.key(3), 2)))


def trained_params(pad: int) -> dict:
    """The trained DQN's flax parameters (the hybrid pickle's), with
    ``pad`` zero input channels behind conv1's 8: the same function of
    an obs whose extra channels are zero."""
    from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw
    raw = load_hybrid_raw(os.path.join(REPO, 'artifacts',
                                       'hybrid_neat_20x20.pkl'))
    p = {k: dict(v) for k, v in raw['dqn_params']['params'].items()}
    p['conv1']['kernel'] = np.pad(np.asarray(p['conv1']['kernel']),
                                  [(0, 0), (0, 0), (0, pad), (0, 0)])
    return {'params': p}


@pytest.mark.parametrize('optimized', [False, True], ids=['f32', 'opt'])
def test_acting_policy_matches_jax(optimized):
    """The acting rows' net on 2 envs of the acting config from JAX's
    reset, with the trained DQN's weights in both packages (random
    weights leave every decision within 1e-2 of a tie)."""
    from marlsnake_tpu.core import engine as JE
    from marlsnake_tpu.models.dqn import DQN as FlaxDQN
    cfg, e = BT.ACTING_CONFIG, 2
    n = cfg.num_snakes
    jcfg, jstate, jobs = acting_reset()
    if optimized:
        jnet = FlaxDQN(num_actions=3, compute_dtype=jnp.bfloat16,
                       assume_binary_obs=True)
        frame = jax.vmap(lambda g: JE.encode_frame(jcfg, g))(jstate.grid)
        jin = jnp.pad(frame.reshape((e * n,) + frame.shape[2:]),
                      [(0, 0)] * 3 + [(0, bench.ACTING_PAD)])
    else:
        jnet = FlaxDQN(num_actions=3)
        jin = jobs.reshape((e * n,) + jobs.shape[2:])
    params = trained_params(bench.ACTING_PAD if optimized else 0)
    jq = np.asarray(jnet.apply(params, jin), np.float32)

    net = bench.acting_net(cfg, optimized, 'cpu')
    net.load_state_dict(dqn_from_flax(params, (cfg.height, cfg.width)))
    state = state_from_jax(jstate)
    inp = bench.acting_input(cfg, state, _t(jobs), optimized)
    np.testing.assert_array_equal(inp.numpy(), np.asarray(jin))
    with torch.no_grad():
        q = net(inp).numpy()
    if not optimized:
        np.testing.assert_allclose(q, jq, rtol=0, atol=1e-5)
        return
    top2 = np.sort(jq, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    assert clear.any()
    np.testing.assert_array_equal(q.argmax(-1)[clear], jq.argmax(-1)[clear])


def test_table_file_has_jax_s_keys(tmp_path):
    """Every row at 2 envs and 2 steps on the CPU: JAX's row keys in
    JAX's order, the file's top level JAX's with ``card``; a narrowed
    table is refused into the committed path; the command line asks for
    CUDA unless told otherwise."""
    out = tmp_path / 'table.json'
    result = BT.run(str(out), 'cpu', num_envs=2, max_steps=2, iters=1,
                    blocks=1)
    written = json.load(open(out))
    assert written == result
    jax_table = json.load(open(os.path.join(REPO, 'artifacts',
                                            'BENCH_TABLE.json')))
    assert list(written) == list(jax_table) + ['card']
    assert written['unit'] == jax_table['unit'] and written['card'] == 'cpu'
    assert len(written['rows']) == 17
    for row, model in zip(written['rows'], jax_table['rows']):
        assert list(row) == list(model)
        assert row['config'] == model['config'] and row['num_envs'] == 2
        assert row['steps_per_sec'] > 0
    with pytest.raises(ValueError, match='would overwrite'):
        BT.run(device='cpu', num_envs=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            BT.main(['--out', str(out)])
