"""marlsnake_torch.tools.battle_batch_run against the JAX package's
``algo/battle_batch.py`` with the trained checkpoint, on the CPU.

The program's lineup is built from ``artifacts/hybrid_neat_20x20.pkl``
(the trained DQN in seat 0, Random in seat 1 where the JAX table had the
reference PPO, the Hybrid NEAT in seat 2, Greedy in seat 3) and battles
at 20x20 with 4 snakes of length 3 on JAX's draws, as
``test_battle_batch_matches_jax`` runs it: every episode's and seat's
reward and lifetime EQUAL to JAX's ``build_battle_batch`` with the same
pickle (the nets agree within 1e-4 in float32 with TF32 off, and the
trained Q-values have no near-ties on these episodes), and the table
the same string.
"""

import os

import jax
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo import battle_batch as JBB
from marlsnake_tpu.algo import neat_hybrid as JH
from marlsnake_tpu.core.types import EnvConfig as JConfig
from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_torch.algo import battle_batch as BB
from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw
from marlsnake_torch.tools import battle_batch_run as R
from test_torch_battle import battle_draws_from_key

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYBRID = os.path.join(REPO, R.HYBRID)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trained_battle_matches_jax():
    """4 envs, up to 64 steps, JAX's draws from key 0: the lineup's
    names and kinds, every reward and lifetime EQUAL, the table the same
    string."""
    cfg = R.battle_config()
    e, steps = 4, 64
    net, topp, names = R.lineup(load_hybrid_raw(HYBRID), cfg, 'cpu')
    assert names == ['DQN (Main)', 'Random Bot', 'Hybrid NEAT',
                     'Greedy Bot']
    assert [type(op) for op in topp] == [BB.BatchedRandom, BB.BatchedNEAT,
                                         BB.BatchedGreedy]
    raw = JH.load_hybrid_raw(HYBRID)
    jopp = [JBB.BatchedRandom(),
            JBB.BatchedNEAT(raw['dqn_params'], raw['neat_genome'],
                            raw['neat_config']),
            JBB.BatchedGreedy()]
    jcfg = JConfig(height=20, width=20, num_snakes=4, snake_length=3)
    key = jax.random.key(0)
    jrun = JBB.build_battle_batch(FlaxDQN(num_actions=3), jcfg, jopp,
                                  num_envs=e, max_steps=steps)
    jr, jl = (np.asarray(x) for x in jrun(raw['dqn_params'], key))

    run = BB.build_battle_batch(net, cfg, topp, num_envs=e,
                                max_steps=steps, device='cpu')
    draws = battle_draws_from_key(cfg, key, [op.draws for op in topp], e,
                                  steps)
    rew, life = run(draws=draws)
    np.testing.assert_array_equal(rew.numpy(), jr)
    np.testing.assert_array_equal(life.numpy(), jl)
    # the trained seats outlive the random one
    assert life[:, 0].mean() > life[:, 1].mean()
    assert BB.summarize(rew, life, names) == JBB.summarize(jr, jl, names)


def test_program_writes_the_table(tmp_path, capsys):
    """The program on the CPU, 4 episodes of up to 16 steps: the table
    and a header that names the device and the Random Bot's seat; a run
    cut short is refused into the committed table's directory; without
    ``--device`` the command line asks for CUDA."""
    summary = R.record(HYBRID, 4, str(tmp_path), 'cpu', max_steps=16)
    text = (tmp_path / 'battle_results_20x20_batched.txt').read_text()
    assert 'on cpu.' in text and 'Random Bot replaces the reference PPO' \
        in text
    for name in R.NAMES:
        assert f'\n{name:<20} |' in text
    assert summary['episodes'] == 4 and 1 <= summary['steps'] <= 16
    assert len(summary['mean_reward']) == 4
    with pytest.raises(ValueError, match='overwrite the table'):
        R.record(HYBRID, 4, device='cpu', max_steps=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            R.main(['--hybrid', HYBRID, '--out', str(tmp_path)])
