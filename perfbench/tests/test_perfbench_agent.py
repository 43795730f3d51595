"""The agent's cell (``moonlight_agent_20x20x4.ppo-16``) at a tiny size on
the CPU: a sound run is correct; a run whose program carries one of the
planted faults is not; its per-layer metrics read the program's marks
and device counts; its reference and driver load neither JAX nor (the
reference) the program."""

import copy
import subprocess
import sys
import time

import pytest
import torch

from marlsnake_torch.algo.ppo_trainer import Minibatch, PPOTrainer
from marlsnake_torch.models import moonlight
from perfbench import harness
from perfbench.tests import tiny

NAME = 'moonlight_agent_20x20x4.ppo-16'
# every width tiny; 16 router outputs, the first 8 held
TINY_MODEL = dict(hidden_size=64, num_attention_heads=2, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  intermediate_size=128, moe_intermediate_size=32,
                  num_experts_per_tok=3, vocab_size=512, layers=3,
                  n_routed_experts=8)
TINY_PROMPT = {'prefix': list(range(100, 110)),
               'cells': list(range(200, 209)), 'newline': 300,
               'actions': [301, 302, 303]}
PER_LAYER = {'agent.attn_ms', 'agent.moe_ms', 'agent.held_share',
             'agent.expert_load_max'}


def cell() -> harness.Cell:
    c = tiny.cell(NAME)
    c.config = copy.deepcopy(c.config)
    # weights_std: the published model's unit-scale activations at d=64
    c.config.update(TINY_MODEL, prompt=TINY_PROMPT, precision='float32',
                    weights_std=0.11)
    c.config['deployment'] = dict(c.config['deployment'], router_experts=16,
                                  held_experts=[0, 8])
    c.workload['params'].update(num_envs=4, rollout_steps=8,
                                reference_block=8)
    return c


def test_sound_run_is_correct():
    c = cell()
    assert tiny.over(c, tiny.run(c).compared()) == {}


# --- faults, planted in the program's path -----------------------------------

def _fp8_experts(monkeypatch):
    full = moonlight.routed_experts

    def rounded(x, *args):
        return full(x.to(torch.float8_e4m3fn).to(x.dtype), *args)
    monkeypatch.setattr(moonlight, 'routed_experts', rounded)


def _zero_expert(monkeypatch):
    full = moonlight.routed_experts

    def zeroed(x, idx, w, first, gate_up, down):
        keep = torch.ones(gate_up.shape[0], 1, 1, dtype=gate_up.dtype)
        keep[0] = 0
        return full(x, idx, w, first, gate_up, down * keep)
    monkeypatch.setattr(moonlight, 'routed_experts', zeroed)


def _router(k_less: int, scale: bool):
    def forward(self, x):
        cfg = self.cfg
        scores = torch.nn.functional.linear(x.float(), self.weight).sigmoid()
        idx = (scores + self.e_score_correction_bias).topk(
            cfg.num_experts_per_tok - k_less, -1).indices
        w = scores.gather(-1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * (cfg.routed_scaling_factor if scale else 1.0)
    return forward


def _top5(monkeypatch):
    monkeypatch.setattr(moonlight.Router, 'forward', _router(1, True))


def _no_scale(monkeypatch):
    monkeypatch.setattr(moonlight.Router, 'forward', _router(0, False))


def _half_batch(monkeypatch):
    full = PPOTrainer.minibatches

    def half(self, perm):
        for mb in full(self, perm):
            yield Minibatch(*(x[:x.shape[0] // 2] for x in mb))
    monkeypatch.setattr(PPOTrainer, 'minibatches', half)


@pytest.mark.parametrize('fault', [_fp8_experts, _zero_expert, _top5,
                                   _no_scale, _half_batch],
                         ids=lambda f: f.__name__.strip('_'))
def test_broken_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    c = cell()
    assert tiny.over(c, tiny.run(c).compared())


# --- per-layer metrics -------------------------------------------------------

def test_a_traced_run_reads_every_per_layer_metric():
    c = cell()
    result = harness.run_cell(c, tiny.SEED, 0.2, True, 'cpu',
                              time.perf_counter())
    assert result['correct']
    got = {k: v['value'] for k, v in result['metrics'].items()}
    assert set(got) == PER_LAYER   # mfu.agent_train: a card's peak only
    assert got['agent.attn_ms'] > 0 and got['agent.moe_ms'] > 0
    assert 0 < got['agent.held_share'] <= 100
    assert 1 <= got['agent.expert_load_max'] <= 8


def _read(name, got):
    ctx = harness.Context(cell(), object(), 0.0, harness.Window(), None,
                          None, {}, 'cpu')
    ctx.program_trace = got
    return harness.load_module('metrics', name).read(ctx)


def test_the_readers_of_a_synthetic_pass():
    stamps, t = [], 0
    for name, dt in [('ppo.collect.start', 5), ('agent.embed', 1),
                     ('agent.attn', 3), ('agent.dense', 7), ('agent.attn', 3),
                     ('agent.moe', 11), ('ppo.collect.end', 2)] * 2:
        t += dt * 1_000_000
        stamps.append({'name': name, 'id': 1, 't_ns': t})
    got = {'stamps': stamps, 'spans': [],
           'counts': {'agent.routed': 400, 'agent.held': 100,
                      'agent.held_load': [[25, 25, 25, 25], [70, 10, 10, 10]]}}
    assert _read('agent.attn_ms', got) == 6.0
    assert _read('agent.moe_ms', got) == 11.0
    assert _read('agent.held_share', got) == 25.0
    assert _read('agent.expert_load_max', got) == 2.8
    for name in PER_LAYER:
        assert _read(name, None) is None


def test_the_reference_and_driver_load_no_jax():
    code = ('import sys\n'
            'import perfbench.reference.moonlight\n'
            'assert not [m for m in sys.modules\n'
            '            if m.startswith("marlsnake")]\n'
            'from perfbench import harness\n'
            'harness.load_module("drivers", "ppo_agent_train")\n'
            'print(harness.forbidden_modules())\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'
