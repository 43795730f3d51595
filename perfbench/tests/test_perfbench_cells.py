"""Each cell's driver at a tiny size on the CPU: a sound run is correct;
a run whose timed path is broken underneath is not; nothing imports JAX
or the JAX package; a new cell, configuration and per-layer metric need
new files only."""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from marlsnake_torch.algo import dqn_trainer, optim
from marlsnake_torch.algo.ppo_trainer import Minibatch, PPOTrainer
from marlsnake_torch.ops import step_kernel
from perfbench import compare, harness
from perfbench.tests import tiny


@pytest.mark.parametrize('name', tiny.CELLS)
def test_sound_run_is_correct(name):
    c = tiny.cell(name)
    assert tiny.over(c, tiny.run(c).compared()) == {}


# --- faults, planted in the program's plain path -----------------------------

def _unchanged_params(monkeypatch):
    monkeypatch.setattr(optim, 'apply_updates',
                        lambda params, updates: list(params))


def _half_td_batch(monkeypatch):
    full = dqn_trainer.huber_loss
    monkeypatch.setattr(dqn_trainer, 'huber_loss', lambda p, t: full(
        p[:p.shape[0] // 2], t[:t.shape[0] // 2]))


def _half_minibatch(monkeypatch):
    full = PPOTrainer.minibatches

    def half(self, perm):
        for mb in full(self, perm):
            yield Minibatch(*(x[:x.shape[0] // 2] for x in mb))
    monkeypatch.setattr(PPOTrainer, 'minibatches', half)


def _wrap_steps(monkeypatch, change):
    """Both step entries, their output passed through ``change(state_in,
    state, out)``."""
    for name, at in (('step', 0), ('step_autoreset', 1)):
        full = getattr(step_kernel, name)

        def stepped(cfg, *args, _full=full, _at=at, **kw):
            state, out = _full(cfg, *args, **kw)
            return change(args[_at], state, out)
        monkeypatch.setattr(step_kernel, name, stepped)


def _state_unchanged(monkeypatch):
    _wrap_steps(monkeypatch, lambda s_in, s, out: (s_in, out))


def _half_envs(monkeypatch):
    def change(s_in, s, out):
        keep = torch.arange(s.grid.shape[0]) >= s.grid.shape[0] // 2
        return step_kernel.select_envs(keep, (s_in, out), (s, out))[0], out
    _wrap_steps(monkeypatch, change)


def _altered_answer(monkeypatch):
    def change(s_in, s, out):
        reward = out.reward.clone()
        reward[0, 0] += 1.0
        obs = out.obs.clone()
        obs[0, 0, 1, 1, 0] ^= 1
        return s, out.replace(reward=reward, obs=obs)
    _wrap_steps(monkeypatch, change)


FAULTS = {
    'dqn_20x20x4.train-256': [_unchanged_params, _half_td_batch,
                              _altered_answer],
    'ppo_20x20x4.train-256': [_unchanged_params, _half_minibatch,
                              _altered_answer],
    'dqn_20x20x4.rollout-4096': [_state_unchanged, _half_envs,
                                 _altered_answer],
}


@pytest.mark.parametrize('name,fault', [
    (name, fault) for name, faults in FAULTS.items() for fault in faults],
    ids=lambda x: getattr(x, '__name__', x))
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    c = tiny.cell(name)
    assert tiny.over(c, tiny.run(c).compared())


def _nan_params(monkeypatch):
    monkeypatch.setattr(optim, 'apply_updates', lambda params, updates: [
        torch.full_like(p, math.nan) for p in params])


@pytest.mark.parametrize('name', tiny.CELLS[:2])
def test_nan_parameters_are_not_correct(name, monkeypatch):
    """A learner whose parameters turn NaN is not correct: a NaN number
    compared fails its limit, and the result's line stays strict JSON."""
    _nan_params(monkeypatch)
    c = tiny.cell(name)
    result = harness.run_cell(c, tiny.SEED, 0.3, False, 'cpu',
                              time.perf_counter())
    assert result['correct'] is False and result['failed'] > 0
    assert any(v['value'] == 'nan' for v in result['checks'].values())
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize('value,limit,over', [
    (0.0, 0.0, False), (1e-6, 1e-5, False), (2e-5, 1e-5, True),
    (math.nan, 1.0, True), (math.inf, 1.0, True), (1, 0, True)])
def test_over_limit(value, limit, over):
    assert harness.over_limit(value, limit) is over


def test_leaf_gap_is_nan_where_any_leaf_is_nan():
    ref = {'a': torch.ones(3), 'b': torch.full((3,), 2.0),
           'c': torch.full((3,), 3.0)}
    for bad in ref:
        prog = dict(ref, **{bad: torch.full((3,), math.nan)})
        for worst in (True, False):
            assert math.isnan(compare.leaf_gap(prog, ref, worst=worst))


# --- imports -----------------------------------------------------------------

def test_drivers_import_no_jax():
    """Every driver, run at the tiny size in a fresh process, leaves no
    module of JAX or of the JAX package in ``sys.modules``."""
    code = (
        'import sys, torch\n'
        'from perfbench import harness\n'
        'from perfbench.tests import tiny\n'
        'for name in tiny.CELLS:\n'
        '    tiny.run(tiny.cell(name), seconds=0.1).compared()\n'
        'print(harness.forbidden_modules())\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'marlsnake_tpu_lookalike', sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert harness.forbidden_modules() == ['jax']


# --- a cell added by new files alone -----------------------------------------

def test_new_cell_config_and_metric_need_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a cell that uses it
    with an existing driver, and a per-layer metric, by new files and new
    entries in BENCHMARK.json (the cell's name added to the list of an
    end-to-end metric it reports among them); the copy's harness runs the
    cell (on the CPU) with no edit to any file under ``perfbench``."""
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(harness.ROOT, 'perfbench'),
                    root / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in root.rglob('*') if p.is_file()}
    bench = json.loads(open(os.path.join(harness.ROOT,
                                         'BENCHMARK.json')).read())
    config = json.loads((root / 'perfbench/configs/dqn_20x20x4.json')
                        .read_text())
    config['name'] = 'tiny_8x8x2'
    config['env'].update(tiny.TINY_ENV)
    (root / 'perfbench/configs/tiny_8x8x2.json').write_text(
        json.dumps(config))
    (root / 'perfbench/workloads/tiny_8x8x2.rollout-4.json').write_text(
        json.dumps({'config': 'tiny_8x8x2', 'traffic': 'rollout-4',
                    'chips': 1, 'driver': 'rollout', 'why': 'a test',
                    'params': {'num_envs': 4, 'steps': 8,
                               'followed_calls': 2, 'sampled_from': 3,
                               'sampled_calls': 1},
                    'limits': {'mismatches': 0}}))
    (root / 'perfbench/metrics/calls_per_s.py').write_text(
        'def read(ctx):\n'
        '    return ctx.window.calls / ctx.window.seconds\n')
    bench['configs'].append({'name': 'tiny_8x8x2', 'source': 'a test',
                             'file': 'perfbench/configs/tiny_8x8x2.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'tiny_8x8x2.rollout-4',
                               'config': 'tiny_8x8x2',
                               'traffic': 'rollout-4', 'chips': 1,
                               'why': 'a test'})
    for m in bench['end_to_end']:
        if m['name'] == 'rollout_env_steps_per_s':
            m['workloads'].append('tiny_8x8x2.rollout-4')
    bench['per_layer'].append({'name': 'calls_per_s', 'unit': 'calls/s',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'harness',
                               'moves': 'rollout_env_steps_per_s',
                               'workloads': ['tiny_8x8x2.rollout-4']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    code = (
        'import sys, json, time\n'
        f'sys.path.insert(0, {str(root)!r})\n'
        f'sys.path.insert(1, {harness.ROOT!r})\n'
        'from perfbench import harness\n'
        'cell = harness.Cell.find("tiny_8x8x2.rollout-4")\n'
        'out = [harness.run_cell(cell, 7, 0.2, t, "cpu", time.perf_counter())'
        ' for t in (False, True)]\n'
        'print(json.dumps([o["metrics"] for o in out] + '
        '[o["correct"] for o in out]))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    plain, traced, ok0, ok1 = json.loads(out.stdout.strip().splitlines()[-1])
    assert ok0 and ok1
    assert set(plain) == {'rollout_env_steps_per_s', 'setup_s'}
    assert set(traced) == {'calls_per_s'}
    assert all(p.read_bytes() == b for p, b in before.items())
