"""marlsnake_torch's battle arenas and opponent zoo (algo/opponents.py,
algo/battle.py, algo/battle_batch.py, rng.BattleDraws) against the JAX
package, on the CPU.

Both packages get the same draws: the port takes what the JAX battle
derives from its key (each env's reset and fruit draws, the greedy seat's
tie-break uniforms and the random seat's actions), and its host agents
share one ``random.Random(s)`` where the JAX agents call the module-level
``random`` after ``random.seed(s)``. The greedy heuristic, the host agents
and seat 0's masking are integer work on the same obs: EQUAL. The nets
(the masked DQN, PPO, the NEAT head over the DQN's features) carry the
same weights (float32, TF32 off) and agree within 1e-4, so their argmax
is the same wherever two actions are not that close, which the seeded
weights here avoid; then every episode's rewards and lifetimes are EQUAL
(float32 sums of the same rewards in the same order) and the printed
tables the same strings.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo import battle as JB
from marlsnake_tpu.algo import battle_batch as JBB
from marlsnake_tpu.algo import evaluator as JEV
from marlsnake_tpu.algo import neat as JN
from marlsnake_tpu.algo import neat_hybrid as JH
from marlsnake_tpu.algo import opponents as JO
from marlsnake_tpu.envs import env as JENV
from marlsnake_tpu.envs import wrappers as JW
from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_tpu.models.torch_interop import ppo_params_from_torch
from marlsnake_torch.algo import battle_batch as BB
from marlsnake_torch.algo import neat as TN
from marlsnake_torch.algo import neat_hybrid as TH
from marlsnake_torch.algo import opponents as TO
from marlsnake_torch.algo.battle import BattleArena
from marlsnake_torch.core import types as T
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs import wrappers as TW
from marlsnake_torch.envs.env import SnakeEnv
from marlsnake_torch.models.dqn import make_dqn
from marlsnake_torch.models.ppo import ActorCritic
from marlsnake_torch.models.weights import (actor_critic_from_reference,
                                            actor_critic_to_reference,
                                            dqn_to_flax)
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.rng import BattleDraws, battle_draws
from test_torch_engine import _t, configs, reset_draws_from_keys
from test_torch_evaluator import boards, jax_fruit_draws
from test_torch_neat import mutated_population
from test_torch_wrappers import HandedDraws

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test here runs many small CPU ops. When several pytest
    workers share the CPU, torch's intra-op threads spin against theirs:
    one thread a test keeps the file's time near its time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames(steps, seed, e=6, hw=12, n=3):
    """Single-agent frames (E * N, H, W, 8) of JAX envs after ``steps``
    random steps (dead snakes have no head)."""
    obs, done = boards(steps, seed=seed, e=e, hw=hw, n=n)
    return obs.reshape((-1,) + obs.shape[2:]), done.reshape(-1)


# --- the greedy fruit-seeker -------------------------------------------------

def test_greedy_step_matches_jax():
    """Frames after 0, 6 and 14 random steps (dead snakes: no head), with
    the fruit taken off some frames, one head walled in on all four sides
    and directions unknown or given; JAX's tie-break uniforms handed in:
    actions and directions EQUAL, ties among legal moves included."""
    obs = np.concatenate([frames(s, seed=s)[0] for s in (0, 6, 14)])
    b = obs.shape[0]
    rng = np.random.default_rng(1)
    obs[rng.random(b) < 0.25, :, :, T.CH_FRUIT] = 0
    heads = np.argwhere(obs[:, :, :, T.CH_MY_HEAD] == 1)
    _, y, x = heads[0]
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        obs[heads[0][0], y + dy, x + dx, T.CH_WALL] = 1
    units = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)], np.int32)
    cur = units[rng.integers(0, 4, b)]
    cur[rng.random(b) < 0.5] = 0
    key = jax.random.key(7)
    want = jax.jit(JBB.greedy_step)(jnp.asarray(obs), jnp.asarray(cur), key)
    u = _t(jax.random.uniform(key, (b, 3)))
    got = BB.greedy_step(_t(obs), _t(cur), u)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the cases are there: no head, no fruit, the walled-in head, ties
    no_head = ~(obs[..., T.CH_MY_HEAD] == 1).reshape(b, -1).any(-1)
    no_fruit = ~(obs[..., T.CH_FRUIT] == 1).reshape(b, -1).any(-1)
    assert no_head.any() and (no_fruit & ~no_head).any()
    assert int(got[0][heads[0][0]]) == 0
    np.testing.assert_array_equal(got[1][no_head].numpy(), cur[no_head])
    # other uniforms break the ties otherwise, in both packages alike
    key2 = jax.random.key(8)
    want2 = jax.jit(JBB.greedy_step)(jnp.asarray(obs), jnp.asarray(cur),
                                     key2)
    got2 = BB.greedy_step(_t(obs), _t(cur),
                          _t(jax.random.uniform(key2, (b, 3))))
    np.testing.assert_array_equal(got2[0].numpy(), np.asarray(want2[0]))
    assert (got2[0] != got[0]).any()


def test_host_greedy_and_random_agents_match_jax():
    """Two host agents of each kind sharing one random stream play the
    frames of 24 steps; every decision EQUAL and the stream left in the
    same state as ``random`` after JAX's agents."""
    obs = np.concatenate([frames(s, seed=10 + s)[0] for s in (0, 3, 9)])

    def play(agents):
        acts = []
        for i, o in enumerate(obs):
            if i % 9 == 0:
                for a in agents:
                    a.reset()
            acts.append([a.get_action(o) for a in agents])
        return acts

    random.seed(5)
    want = play([JO.GreedyAgent(1), JO.RandomAgent(2), JO.GreedyAgent(3),
                 JO.RandomAgent(4)])
    rng = random.Random(5)
    got = play([TO.GreedyAgent(1, rng), TO.RandomAgent(2, rng),
                TO.GreedyAgent(3, rng), TO.RandomAgent(4, rng)])
    assert got == want
    assert rng.getstate() == random.getstate()
    assert TO.GreedyAgent(3, rng).name == 'Greedy_FruitSeeker_3'
    assert list(TO.DEADLY_CHANNELS) == JO.DEADLY_CHANNELS


# --- seat 0 alone ------------------------------------------------------------

@pytest.mark.parametrize('steps', [0, 6, 14])
def test_masked_seat0_matches_jax_masked_actions(steps):
    """Over the boards of the evaluator's tests, each snake in seat 0 in
    turn, seat 0 masked alone equals JAX's ``masked_actions`` of the
    whole env with ``active = [alive0, False, ...]``, seat 0's action and
    direction."""
    obs, done = boards(steps, seed=steps)
    n = done.shape[1]
    # every snake of the boards takes seat 0 once, dead ones included
    obs = np.concatenate([np.roll(obs, -k, axis=1) for k in range(n)])
    done = np.concatenate([np.roll(done, -k, axis=1) for k in range(n)])
    e = done.shape[0]
    rng = np.random.default_rng(200 + steps)
    q = rng.normal(size=(e, n, 3)).astype(np.float32)
    units = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)], np.int32)
    dirs = np.zeros((e, n, 2), np.int32)
    dirs[:, 0] = units[rng.integers(0, 4, e)]
    dirs[rng.random(e) < 0.5, 0] = 0
    alive0 = ~done[:, 0]
    active = np.zeros((e, n), bool)
    active[:, 0] = alive0
    fn = jax.jit(jax.vmap(lambda o, qq, d, a: JEV.masked_actions(
        o, qq, d, a, 60)))
    want_acts, want_dirs = fn(jnp.asarray(obs), jnp.asarray(q),
                              jnp.asarray(dirs), jnp.asarray(active))
    act, new_dir = BB.masked_seat0(_t(obs[:, 0]), _t(q[:, 0]),
                                   _t(dirs[:, 0]), _t(alive0))
    np.testing.assert_array_equal(act.numpy(), np.asarray(want_acts)[:, 0])
    np.testing.assert_array_equal(new_dir.numpy(),
                                  np.asarray(want_dirs)[:, 0])
    # the other seats are inactive: action 0, direction kept
    assert not np.asarray(want_acts)[:, 1:].any()
    np.testing.assert_array_equal(np.asarray(want_dirs)[:, 1:], dirs[:, 1:])
    if steps:
        assert (~alive0).any()


# --- the batched battle ------------------------------------------------------

def seat_draws_from_key(key, kinds, e, steps):
    """The seat draws JAX's battle derives from ``key``: step ``t``'s key
    is ``split(ks, steps)[t]``, seat ``i``'s ``fold_in`` of it with ``i``
    (algo/battle_batch.py:214-225)."""
    _, ks = jax.random.split(key)
    step_keys = jax.random.split(ks, steps)
    seats = []
    for i, kind in enumerate(kinds):
        keys = jax.vmap(lambda k: jax.random.fold_in(k, i))(step_keys)
        if kind == 'tiebreak':
            seats.append(_t(jax.vmap(
                lambda k: jax.random.uniform(k, (e, 3)))(keys)))
        elif kind == 'action':
            seats.append(_t(jax.vmap(lambda k: jax.random.randint(
                k, (e,), 0, 3, jnp.int32))(keys)))
        else:
            seats.append(None)
    return tuple(seats)


def battle_draws_from_key(cfg, key, kinds, e, steps):
    kr, _ = jax.random.split(key)
    reset_keys = jax.random.split(kr, e)
    return BattleDraws(reset_draws_from_keys(cfg, reset_keys),
                       jax_fruit_draws(reset_keys, steps, cfg.num_snakes),
                       seat_draws_from_key(key, kinds, e, steps))


def reference_ppo(cfg, seed):
    """A PPO checkpoint's state_dict in the reference's layout: torch's
    own init of the net from ``seed`` (non-zero biases, so that the
    greedy action varies over frames)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = ActorCritic((cfg.height, cfg.width), device='cpu')
    return actor_critic_to_reference(net.state_dict())


def lineups(name, cfg, dqn_state):
    """(JAX opponents, port opponents) of a lineup."""
    if name == 'greedy+random':
        return ([JBB.BatchedGreedy(), JBB.BatchedRandom()],
                [BB.BatchedGreedy(), BB.BatchedRandom()])
    sd = reference_ppo(cfg, seed=4)
    ppo = ActorCritic((cfg.height, cfg.width), assume_binary_obs=True,
                      device='cpu')
    ppo.load_state_dict(actor_critic_from_reference(sd))
    hw = (cfg.height, cfg.width)
    jcfg = JN.NeatConfig(num_inputs=128, num_outputs=3)
    tcfg = TN.NeatConfig(num_inputs=128, num_outputs=3)
    jgenome = mutated_population(
        JN, jcfg, JH.fc3_to_genome(dqn_to_flax(dqn_state, hw), jcfg), 4)[3]
    tgenome = mutated_population(
        TN, tcfg, TH.fc3_to_genome(dqn_state, tcfg), 4)[3]
    assert any(k not in tcfg.output_keys for k in tgenome.nodes)
    return ([JBB.BatchedPPO(ppo_params_from_torch(
                {k: v.numpy() for k, v in sd.items()})),
             JBB.BatchedNEAT(dqn_to_flax(dqn_state, hw), jgenome, jcfg),
             JBB.BatchedGreedy()],
            [BB.BatchedPPO(ppo),
             BB.BatchedNEAT(dqn_state, tgenome, tcfg, cfg, device='cpu'),
             BB.BatchedGreedy()])


@pytest.mark.parametrize('lineup,n,done_mode', [
    ('greedy+random', 3, 'any'), ('ppo+neat+greedy', 4, 'all')])
def test_battle_batch_matches_jax(lineup, n, done_mode, monkeypatch):
    """10x10, 8 envs, up to 48 steps, JAX's draws: every episode's and
    seat's reward and lifetime EQUAL; the port's step wrapper called once
    a loop iteration in chunks of 8, holding finished envs (in coop
    mode envs end at different steps; with 'all' the masked DQN outlives
    the 48 steps in most envs); the table the same string."""
    jcfg, cfg = configs(height=10, width=10, num_snakes=n, snake_length=3,
                        done_mode=done_mode)
    e, steps = 8, 48
    net = make_dqn(cfg, seed=2, device='cpu')
    state = net.state_dict()
    params = dqn_to_flax(state, (10, 10))
    jopp, topp = lineups(lineup, cfg, state)
    key = jax.random.key(11)
    jrun = JBB.build_battle_batch(FlaxDQN(num_actions=3), jcfg, jopp,
                                  num_envs=e, max_steps=steps)
    jr, jl = (np.asarray(x) for x in jrun(params, key))

    calls, step = [], step_kernel.step

    def counting(cfg, state, actions, fruit_u, hold=None):
        calls.append(None if hold is None else int(hold[0].sum()))
        return step(cfg, state, actions, fruit_u, hold)

    monkeypatch.setattr(step_kernel, 'step', counting)
    run = BB.build_battle_batch(net, cfg, topp, num_envs=e, max_steps=steps,
                                device='cpu')
    draws = battle_draws_from_key(cfg, key, [op.draws for op in topp], e,
                                  steps)
    rew, life = run(draws=draws)
    assert rew.dtype == life.dtype == torch.float32
    assert rew.shape == life.shape == (e, n)
    np.testing.assert_allclose(rew.numpy(), jr, rtol=1e-6, atol=0)
    np.testing.assert_allclose(life.numpy(), jl, rtol=1e-6, atol=0)
    # one step a loop iteration in whole chunks, each holding the envs
    # all done before it (none at the first); the loop stops after the
    # chunk in which every env is done
    k = run.chunk_steps
    assert calls[0] == 0 and None not in calls and k == 8
    assert len(calls) == -(-int(life.max()) // k) * k
    assert int(life.max()) <= steps
    if done_mode == 'any':
        assert sum(calls[1:]) > 0 and len(calls) < steps
    names = ['DQN (Main)'] + [op.name for op in topp]
    assert BB.summarize(rew, life, names) == JBB.summarize(jr, jl, names)
    # under the parameters handed in, the same battle
    again = run(dict(state), draws=draws)
    assert torch.equal(again[0], rew) and torch.equal(again[1], life)


def test_battle_batch_own_draws_and_checks():
    """The port's own draws: reproducible from the seed, shaped, every
    seat alive at the start; a lineup that does not fill the seats and
    packed obs are refused; unknown seat draws too."""
    _, cfg = configs(height=8, width=8, num_snakes=3, snake_length=3)
    net = make_dqn(cfg, seed=1, device='cpu')
    opp = [BB.BatchedRandom(), BB.BatchedGreedy()]
    run = BB.build_battle_batch(net, cfg, opp, num_envs=4, max_steps=24,
                                device='cpu')
    a, b = run(seed=3), run(seed=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[1] >= 1).all() and (a[1] <= 24).all()
    d = battle_draws(cfg, ('tiebreak', 'action', None), 4, 24,
                     torch.Generator().manual_seed(0), 'cpu')
    assert d.fruit_u.shape == (24, 4, 3) and d.seat[0].shape == (24, 4, 3)
    assert d.seat[1].dtype == torch.int32 and d.seat[2] is None
    assert int(d.seat[1].min()) >= 0 and int(d.seat[1].max()) <= 2
    with pytest.raises(ValueError, match='seat draw'):
        battle_draws(cfg, ('coin',), 4, 24, torch.Generator(), 'cpu')
    with pytest.raises(ValueError, match='opponents'):
        BB.build_battle_batch(net, cfg, opp[:1], device='cpu')
    _, packed = configs(height=8, width=8, num_snakes=3,
                        obs_format='packed')
    with pytest.raises(ValueError, match='uint8'):
        BB.build_battle_batch(net, packed, opp, device='cpu')


def test_summarize_matches_jax():
    rng = np.random.default_rng(3)
    r = rng.normal(size=(16, 4)).astype(np.float32) * 7
    t = rng.integers(1, 500, (16, 4)).astype(np.float32)
    names = ['DQN (Main)', 'PPO', 'Hybrid NEAT', 'Greedy Bot']
    assert BB.summarize(_t(r), _t(t), names) == JBB.summarize(r, t, names)


# --- the host arena ----------------------------------------------------------

def test_host_net_agents_match_jax():
    """DQNAgent, PPOAgent and NEATAgent decide as JAX's on the same
    frames, with the same weights."""
    _, cfg = configs(height=12, width=12, num_snakes=3, snake_length=3)
    obs = frames(6, seed=21)[0]
    net = make_dqn(cfg, seed=5, device='cpu')
    state = net.state_dict()
    params = dqn_to_flax(state, (12, 12))
    sd = reference_ppo(cfg, seed=6)
    ppo = ActorCritic((12, 12), assume_binary_obs=True, device='cpu')
    ppo.load_state_dict(actor_critic_from_reference(sd))
    jcfg = JN.NeatConfig(num_inputs=128, num_outputs=3)
    tcfg = TN.NeatConfig(num_inputs=128, num_outputs=3)
    # the fc3-seeded genome: the DQN's own head over its features
    jg = JH.fc3_to_genome(params, jcfg)
    tg = TH.fc3_to_genome(state, tcfg)
    pairs = [
        (JO.DQNAgent(1, params), TO.DQNAgent(1, net)),
        (JO.PPOAgent(2, ppo_params_from_torch(
            {k: v.numpy() for k, v in sd.items()})), TO.PPOAgent(2, ppo)),
        (JO.NEATAgent(3, params, jg, jcfg),
         TO.NEATAgent(3, params, tg, tcfg, cfg, device='cpu'))]
    for jagent, tagent in pairs:
        assert tagent.name == jagent.name
        want = [jagent.get_action(o) for o in obs]
        got = [tagent.get_action(o) for o in obs]
        assert got == want, tagent.name
        # the pooled PPO features of random weights hardly vary, nor does
        # its argmax: its logits are held against flax's instead
        assert isinstance(tagent, TO.PPOAgent) or len(set(got)) > 1
    jppo = pairs[1][0]
    with torch.no_grad():
        logits = ppo(_t(obs))[0]
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jppo.net.apply(jppo.params, obs)[0]),
        rtol=0, atol=1e-5)


def test_battle_arena_matches_jax(capsys):
    """Two episodes of 10x10 with 4 snakes, up to 60 steps: the masked
    DQN against NEAT, Random and Greedy host agents, with the JAX
    adapter's draws and one random stream; the returned means and every
    printed line EQUAL; one step wrapper call a step."""
    board = dict(height=10, width=10, num_snakes=4, snake_length=3)
    cfg = EnvConfig(**board)
    net = make_dqn(cfg, seed=3, device='cpu')
    state = net.state_dict()
    params = dqn_to_flax(state, (10, 10))
    jcfg = JN.NeatConfig(num_inputs=128, num_outputs=3)
    tcfg = TN.NeatConfig(num_inputs=128, num_outputs=3)
    jg = mutated_population(JN, jcfg, JH.fc3_to_genome(params, jcfg), 2)[1]
    tg = mutated_population(TN, tcfg, TH.fc3_to_genome(state, tcfg), 2)[1]
    names = ['DQN (Main)', 'Hybrid NEAT', 'Random Bot', 'Greedy Bot']

    random.seed(9)
    jenv = JW.GymAdapter(JENV.SnakeEnv(JENV.EnvConfig(**board)), seed=4)
    jarena = JB.BattleArena(
        jenv, FlaxDQN(num_actions=3), params,
        [JO.NEATAgent(1, params, jg, jcfg), JO.RandomAgent(2),
         JO.GreedyAgent(3)], display_names=names)
    want = jarena.run_battle(num_episodes=2, max_steps=60)
    want_out = capsys.readouterr().out

    rng = random.Random(9)
    env = HandedDraws(TW.GymAdapter(SnakeEnv(cfg, device='cpu')), 4, 60)
    arena = BattleArena(
        env, net, None,
        [TO.NEATAgent(1, params, tg, tcfg, cfg, device='cpu'),
         TO.RandomAgent(2, rng), TO.GreedyAgent(3, rng)],
        display_names=names)
    before = step_kernel.step.launches
    got = arena.run_battle(num_episodes=2, max_steps=60)
    got_out = capsys.readouterr().out
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got_out == want_out and 'ALGORITHM' in got_out
    assert step_kernel.step.launches == before   # the CPU: plain engine
    assert rng.getstate() == random.getstate()
    # the weights handed in as params decide as the net holding them
    def arena(dqn, params):
        rng = random.Random(9)
        return BattleArena(
            HandedDraws(TW.GymAdapter(SnakeEnv(cfg, device='cpu')), 4, 30),
            dqn, params, [TO.RandomAgent(1, rng), TO.RandomAgent(2, rng),
                          TO.GreedyAgent(3, rng)])

    a = arena(make_dqn(cfg, seed=8, device='cpu'), state).run_battle(
        num_episodes=1, max_steps=30, verbose=False)
    b = arena(net, None).run_battle(num_episodes=1, max_steps=30,
                                    verbose=False)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError, match='external agents'):
        BattleArena(env, net, None, [TO.RandomAgent(1, rng)])
