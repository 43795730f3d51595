"""marlsnake_torch.cli and marlsnake_torch.utils.profiling, on the CPU.

The parser is held against the JAX CLI's: the same subcommands, and for
each the same options with the same defaults, types and actions, apart
from the port's ``--device`` and the reference PPO checkpoint's default,
which the port names relative to a checkout of the reference repository.
``_cap_seats`` takes the cases of the JAX package's own test and gives
JAX's results. Then every subcommand runs with ``--device cpu`` at 8x8:
``train`` writes the checkpoint that ``eval``, ``battle`` (on the host
and batched), ``neat`` and ``es`` read, and each prints what the JAX CLI
prints: the lineup's names and the table's header.
"""

import argparse
import contextlib
import functools
import io
import os

import numpy as np
import pytest
import torch

from marlsnake_tpu import cli as JCLI
from marlsnake_torch import cli as TCLI
from marlsnake_torch.algo import battle as TB
from marlsnake_torch.algo import battle_batch as TBB
from marlsnake_torch.algo import evaluator as TEV
from marlsnake_torch.algo import neat as TN
from marlsnake_torch.algo import neat_hybrid as TH
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.models.ppo import ActorCritic
from marlsnake_torch.models.weights import (actor_critic_from_reference,
                                            actor_critic_to_reference,
                                            dqn_to_flax)
from marlsnake_torch.utils import profiling

BOARD = ['--height', '8', '--width', '8', '--device', 'cpu']
HOST_HEADER = (f'{"ALGORITHM":<20} | {"MEAN REWARD":<18} | '
               f'{"MEAN LIFETIME":<15}')


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test here runs many small CPU ops. When several pytest
    workers share the CPU, torch's intra-op threads spin against theirs:
    one thread a test keeps the file's time near its time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def short_episodes(monkeypatch):
    """The evaluation and battle episodes of ``eval`` and ``battle`` cut
    from the CLI's 1,000 and 512 steps (the JAX defaults) to 48: the
    masked DQN outlives them at 8x8."""
    for cls, name in ((TEV.DQNEvaluator, 'evaluate'),
                      (TB.BattleArena, 'run_battle')):
        monkeypatch.setattr(cls, name, functools.partialmethod(
            getattr(cls, name), max_steps=48))
    build = TBB.build_battle_batch
    monkeypatch.setattr(TBB, 'build_battle_batch', lambda *a, **k: build(
        *a, **dict(k, max_steps=48)))


def run_cli(*argv) -> str:
    """``main(argv)``'s standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        TCLI.main(list(argv))
    return out.getvalue()


# --- the parser --------------------------------------------------------------

def options(parser):
    """{subcommand: {dest: (flags, default, type, action, nargs)}}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {mode: {a.dest: (tuple(a.option_strings), a.default, a.type,
                            type(a).__name__, a.nargs)
                   for a in p._actions
                   if not isinstance(a, argparse._HelpAction)}
            for mode, p in sub.choices.items()}


def test_parser_matches_jax():
    want, got = options(JCLI.build_parser()), options(TCLI.build_parser())
    assert set(got) == set(want) == {'train', 'train-ppo', 'eval', 'battle',
                                     'neat', 'es', 'demo'}
    for mode in want:
        mine, theirs = dict(got[mode]), dict(want[mode])
        assert mine.pop('device')[:2] == (('--device',), 'cuda')
        if mode == 'battle':
            flags, default = mine.pop('ppo_checkpoint')[:2]
            jflags, jdefault = theirs.pop('ppo_checkpoint')[:2]
            assert flags == jflags
            assert jdefault.endswith('/reference/' + default)
        assert mine == theirs, mode
    args = TCLI.build_parser().parse_args(['battle', '--batched'])
    assert args.batched and args.device == 'cuda' and args.episodes == 10


@pytest.mark.parametrize('opponents,names,num_snakes', [
    (['ppo', 'neat'], ['DQN (Main)', 'PPO', 'Hybrid NEAT'], 3),
    (['ppo'], ['DQN (Main)', 'PPO'], 2),
    (['ppo', 'neat'], ['DQN (Main)', 'PPO', 'Hybrid NEAT'], 4)],
    ids=['3-snakes', '2-snakes', '4-snakes'])
def test_cap_seats_matches_jax(opponents, names, num_snakes, capsys):
    """The cases of tests/test_battle_batch.py::test_cli_seat_cap: the
    same lineups, seats and warnings as JAX's."""
    want = JCLI._cap_seats(list(opponents), list(names), num_snakes)
    want_out = capsys.readouterr().out
    got = TCLI._cap_seats(list(opponents), list(names), num_snakes)
    assert got == want and capsys.readouterr().out == want_out
    opp, kept, seats = got
    assert seats == num_snakes - 1 and len(opp) <= max(seats - 1, 0)
    assert kept == names[:1 + len(opp)]
    if len(opponents) > len(opp):
        assert 'warning: no seat for' in want_out


# --- every subcommand on the CPU ---------------------------------------------

@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    """A directory where ``train`` (one episode, 2 snakes) wrote
    ``checkpoints/shared_model_final.pt``, beside a hybrid NEAT pickle of
    that DQN (``hybrid_neat_best.pkl``, the battle's default) and a PPO
    checkpoint in the reference's layout (``ppo_ref.pt``). Returns (the
    directory, train's output)."""
    d = tmp_path_factory.mktemp('cli')
    cwd, threads = os.getcwd(), torch.get_num_threads()
    os.chdir(d)
    torch.set_num_threads(1)
    try:
        out = run_cli('train', '--episodes', '1', '--no-log',
                      '--num-snakes', '2', *BOARD)
        state = torch.load('checkpoints/shared_model_final.pt',
                           weights_only=True)['params']
        neat_cfg = TN.NeatConfig(num_inputs=128, num_outputs=3)
        TH.save_checkpoint_safe(
            {'dqn_params': dqn_to_flax(state, (8, 8)),
             'neat_genome': TH.fc3_to_genome(state, neat_cfg),
             'neat_config': neat_cfg}, 'hybrid_neat_best.pkl')
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            ppo = ActorCritic((8, 8), device='cpu').state_dict()
        ref = actor_critic_to_reference(ppo)
        back = actor_critic_from_reference(ref)
        assert all(torch.equal(back[k], v) for k, v in ppo.items())
        torch.save({'model_state_dict': ref}, 'ppo_ref.pt')
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    return d, out


def test_cli_train_writes_the_checkpoint(workdir):
    d, out = workdir
    assert 'Ep     1 | Mean Reward:' in out
    assert (d / 'checkpoints' / 'shared_model_final.pt').exists()
    assert (d / 'checkpoints' / 'shared_model_final.meta.json').exists()


def test_cli_eval(workdir, monkeypatch, short_episodes):
    monkeypatch.chdir(workdir[0])
    out = run_cli('eval', '--no-render', '--episodes', '2',
                  '--num-snakes', '2', *BOARD)
    assert out.startswith('Loaded checkpoint: final\n')
    assert 'FINAL RESULTS OVER 2 EPISODES:' in out
    # a tag that cannot be read: random weights, with JAX's warning
    out = run_cli('eval', '--no-render', '--episodes', '1',
                  '--checkpoint', 'nope', '--num-snakes', '2', *BOARD)
    assert out.startswith("Warning: evaluating with random weights "
                          "(checkpoint 'nope' not loadable:")


@pytest.mark.parametrize('num_snakes,lineup', [
    (2, ['DQN (Main)', 'Greedy Bot']),
    (4, ['DQN (Main)', 'PPO', 'Hybrid NEAT', 'Greedy Bot'])])
def test_cli_battle_on_the_host(workdir, monkeypatch, short_episodes,
                                num_snakes, lineup):
    """The reference lineup where it fits: two snakes leave no seat for
    the hybrid NEAT (dropped with JAX's warning), four seat the PPO
    checkpoint and the pickle before Greedy."""
    monkeypatch.chdir(workdir[0])
    out = run_cli('battle', '--no-render', '--episodes', '2',
                  '--snake-length', '3', '--num-snakes', str(num_snakes),
                  '--ppo-checkpoint', 'ppo_ref.pt', *BOARD)
    lines = out.splitlines()
    assert lines[0] == 'Loaded checkpoint: final'
    assert 'Episode  1 Done. Steps: ' in out and 'Episode  2 Done.' in out
    table = lines[lines.index(HOST_HEADER) + 2:][:num_snakes]
    assert [row.split(' | ')[0].rstrip() for row in table] == lineup
    if num_snakes == 2:
        assert ('warning: no seat for PPO (num_snakes=2), dropping'
                in lines)


def jax_summary_header(names):
    """The first three lines of the JAX package's ``summarize`` table
    over 4 episodes."""
    from marlsnake_tpu.algo.battle_batch import summarize
    z = np.zeros((4, len(names)), np.float32)
    return summarize(z, z, names).splitlines()[:3]


@pytest.mark.parametrize('num_snakes,lineup', [
    (2, ['DQN (Main)', 'Greedy Bot']),
    (3, ['DQN (Main)', 'Random Bot', 'Greedy Bot']),
    (4, ['DQN (Main)', 'PPO', 'Hybrid NEAT', 'Greedy Bot'])])
def test_cli_battle_batched(workdir, monkeypatch, short_episodes,
                            num_snakes, lineup):
    """``battle --batched --episodes 4``: the table of ``summarize`` over
    4 episodes with JAX's header; three snakes without a PPO checkpoint
    and NEAT pickle fill the seat with Random."""
    monkeypatch.chdir(workdir[0])
    extra = (['--ppo-checkpoint', 'ppo_ref.pt'] if num_snakes == 4 else
             ['--hybrid-pickle', 'absent.pkl'] if num_snakes == 3 else [])
    out = run_cli('battle', '--batched', '--episodes', '4',
                  '--snake-length', '3', '--num-snakes', str(num_snakes),
                  *extra, *BOARD)
    lines = out.splitlines()
    header = jax_summary_header(lineup)
    start = lines.index(header[1])
    assert lines[start - 1:start + 2] == header
    rows = lines[start + 2:start + 2 + num_snakes]
    assert [row.split(' | ')[0].rstrip() for row in rows] == lineup
    assert lines[start + 2 + num_snakes] == '=' * 78


def test_cli_neat_and_es(workdir, monkeypatch):
    monkeypatch.chdir(workdir[0])
    out = run_cli('neat', '--generations', '1', '--pop-size', '8',
                  '--result-file', 'neat_cli.pkl', '--num-snakes', '2',
                  *BOARD)
    assert out.startswith('Loaded checkpoint: final\n')
    data = TH.load_hybrid_raw('neat_cli.pkl')
    assert data['neat_config'].pop_size == 8
    out = run_cli('es', '--generations', '1', '--pop-size', '4',
                  '--holdout-episodes', '4', '--num-snakes', '2', *BOARD)
    assert 'gen   0 | train' in out
    assert 'holdout (4 fresh paired episodes): seed ' in out
    assert os.path.exists('hybrid_es_best.msgpack')


def test_cli_train_ppo_and_demo(workdir, monkeypatch):
    monkeypatch.chdir(workdir[0])
    out = run_cli('train-ppo', '--updates', '1', '--num-envs', '4',
                  '--rollout-steps', '8', '--no-log', '--num-snakes', '2',
                  *BOARD)
    assert out.startswith('update    1 | return')
    assert os.path.exists(os.path.join('checkpoints_ppo', 'ppo_final'))
    out = run_cli('demo', '--num-snakes', '2', *BOARD)
    assert out.splitlines()[-1].startswith('demo: ')
    assert 'final rank' in out and '#' in out
    out = run_cli('demo', '--num-snakes', '2', '--map', '10x10',
                  '--steps', '3', '--device', 'cpu')
    assert out.splitlines()[-1].startswith('demo: 3 steps')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        run_cli('demo', '--num-snakes', '2', '--height', '8',
                '--width', '8')


# --- profiling ---------------------------------------------------------------

def test_profiling_helpers(tmp_path):
    cfg = EnvConfig(height=8, width=8, num_snakes=2, snake_length=3)
    env = VectorSnakeEnv(cfg, 4, device='cpu', seed=0)
    states, _ = env.reset()
    actions = torch.zeros((4, 2), dtype=torch.int32)
    rate = profiling.env_steps_per_sec(env.step, states, actions, 4,
                                       iters=3)
    assert np.isfinite(rate) and rate > 0
    calls = []
    assert profiling.timeit(lambda x: calls.append(x) or x, 1, iters=3,
                            warmup=1) >= 0 and calls == [1] * 4
    out = env.step(states, actions)
    assert profiling.block_until_ready(out) is out
    with profiling.trace(str(tmp_path / 'trace')) as prof:
        env.step(states, actions)
    assert prof is not None
    assert (tmp_path / 'trace' / 'trace.json').stat().st_size > 0
