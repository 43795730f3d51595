"""The frozen counts: FLOPs of both nets and K1's needed bytes, pinned,
and the byte formulas against the program's own tensors."""

import json
import os

import torch

from marlsnake_torch.core import engine
from marlsnake_torch.rng import ResetDraws, StepDraws
from perfbench import harness, port
from perfbench.counts import formulas as f


def _config(name):
    return json.load(open(os.path.join(harness.HERE, 'configs',
                                       f'{name}.json')))


def test_net_flops_pinned():
    # conv 2*8*32*9*400 + 2*32*64*9*400 + 2*64*64*9*400, fc 2*25600*256
    # + 2*256*128 + 2*128*3
    assert f.dqn_forward(20, 20, 8, 3) == 59_253_504
    assert f.actor_critic_forward(20, 20, 8, 3) == 3_819_520
    dqn = harness.load_module('counts', 'dqn_20x20x4')
    per_step = dqn.train_flops_per_env_step(
        _config('dqn_20x20x4'), {'num_envs': 256, 'update_every': 1}) * 256
    assert round(per_step) == 181_083_045_888
    ppo = harness.load_module('counts', 'ppo_20x20x4')
    per_update = ppo.train_flops_per_env_step(
        _config('ppo_20x20x4'), {'num_envs': 256, 'rollout_steps': 128,
                                 'update_epochs': 4}) * 256 * 128
    assert round(per_update) == 5_545_761_177_600


def test_k1_bytes_pinned():
    """chip_smoke.py's case: 20x20x4, 4096 envs, procedural spawn, 256
    envs resetting in the measured step."""
    assert (f.k1_bytes(20, 20, 4, 21, 3, 4096, pool_spawn=False)
            + f.procedural_reset_bytes(4, 256)) == 70_438_912
    dqn = harness.load_module('counts', 'dqn_20x20x4')
    assert dqn.k1_bytes_per_env_step(_config('dqn_20x20x4'),
                                     {'num_envs': 4096}) * 4096 == 70_438_912


def test_byte_formulas_match_the_programs_tensors():
    config = _config('dqn_20x20x4')
    cfg = port.env_config(config)
    g = torch.Generator().manual_seed(0)
    b, n = 3, cfg.num_snakes
    state, _ = engine.reset(cfg, engine.spawn_tables(cfg, 'cpu'), ResetDraws(
        torch.rand((b,), generator=g), torch.rand((b, 3), generator=g)))
    draws = StepDraws(torch.rand((b, n), generator=g),
                      torch.rand((b,), generator=g),
                      torch.rand((b, 3), generator=g))
    _, out = engine.step_autoreset(cfg, engine.spawn_tables(cfg, 'cpu'),
                                   state, torch.zeros((b, n), dtype=torch.int32),
                                   draws)

    def nbytes(obj):
        return sum(t.numel() * t.element_size() for _, t in obj.fields())

    words = state.ring.shape[-1]
    assert nbytes(state) == b * f.env_state_bytes(20, 20, n, words)
    assert nbytes(out) == b * f.step_output_bytes(20, 20, n)
    assert f.k1_bytes(20, 20, n, words, 3, b, True) == (
        2 * nbytes(state) + b * n * 4 + sum(t.numel() * 4 for t in draws)
        + nbytes(out))
