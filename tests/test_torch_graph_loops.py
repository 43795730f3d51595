"""The port's chunked loops against the JAX programs they replace, on
the CPU: the batched evaluation (``build_evaluate_batch``, a
``lax.scan``), the batched battle (``build_battle_batch``, a
``lax.scan``) and the fitness episode of hybrid NEAT and of head-ES (a
``lax.while_loop`` keyed by its bucket).

On CUDA each loop is a captured graph of a chunk of up to 8 steps,
replayed with one read-back a chunk; on the CPU the same chunk body runs
directly over the same buffers, so these tests pin what the card
captures. Both packages get the same draws (the JAX program's own, from
its keys). Episodes end inside a chunk, and loops run for a number of
steps that is no multiple of the chunk: the chunk's steps after the end
must add nothing. Each loop is also held against the per-step loop it
replaces, written out here as it ran before.

Tolerances: integer and boolean results (lifetimes, step counts) EQUAL;
float rewards and returns within 1e-6 relative of JAX's (the same
float32 sums in the same order; the nets carry the same weights with
TF32 off) and EQUAL to the per-step loop's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo import battle_batch as JBB
from marlsnake_tpu.algo import evaluator as JEV
from marlsnake_tpu.algo import neat as JN
from marlsnake_tpu.algo import neat_hybrid as JH
from marlsnake_tpu.core.types import EnvConfig as JConfig
from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_torch.algo import battle_batch as BB
from marlsnake_torch.algo import evaluator as EV
from marlsnake_torch.algo import neat as TN
from marlsnake_torch.algo import neat_hybrid as TH
from marlsnake_torch.core import engine
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.models.dqn import DQN
from marlsnake_torch.models.weights import dqn_from_flax, dqn_to_flax
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.rng import StepDraws, reset_draws
from marlsnake_torch.utils import cuda_graph
from test_torch_battle import battle_draws_from_key
from test_torch_engine import _t, configs, reset_draws_from_keys
from test_torch_evaluator import jax_fruit_draws
from test_torch_neat import episode_draws_from_key, mutated_population
from test_torch_step_kernel import plain_library  # noqa: F401 (fixture)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small CPU ops: one torch thread a test keeps the file's time
    near its time alone when pytest workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_dqn(seed, hw):
    """(flax DQN parameters, the port's DQN with the same weights)."""
    params = jax.device_get(FlaxDQN(num_actions=3).init(
        jax.random.key(seed), jnp.zeros((1,) + hw + (8,), jnp.float32)))
    net = DQN(hw, 8, 3, assume_binary_obs=True, device='cpu')
    net.load_state_dict(dqn_from_flax(params, hw))
    return params, net


def chunks_run(steps, k=8):
    """The steps a chunked loop runs when it ends after ``steps``."""
    return -(-steps // k) * k


# --- the chunk runner --------------------------------------------------------

def test_tail_chunks_cover_the_loop_and_stop_on_the_flag():
    assert [cuda_graph.tail_chunk_steps(s) for s in (0, 1, 5, 8, 13, 512)] \
        == [1, 1, 5, 8, 8, 8]
    assert cuda_graph.chunk_steps(256, 4) == 8   # the DQN's, moved here
    flags = torch.zeros(2, dtype=torch.int32)
    ran = []

    def body(stop_after):
        ran.append(None)
        flags.copy_(torch.tensor([len(ran) < stop_after, len(ran)]))

    # (max_steps, the chunk whose flag says the loop ended, chunks run,
    # the last read): 13 steps take two chunks of 8
    for max_steps, stop_after, chunks, last in ((13, 99, 2, [1, 2]),
                                                (40, 3, 3, [0, 3]),
                                                (0, 99, 0, [0, 0])):
        ran.clear()
        flags.zero_()
        loop = cuda_graph.CapturedLoop(lambda s=stop_after: body(s), 'cpu')
        got = cuda_graph.run_chunks(loop, flags, max_steps, 8,
                                    captured=False, name='loop')
        assert len(ran) == chunks and got == last


def test_a_hold_of_no_env_equals_no_hold(plain_library):
    """The chunks hold with every env's flag False at their first step:
    field for field the step without a hold, through the plain engine
    and through the kernel entry's launch path (the stand-in library)."""
    cfg = EnvConfig(height=8, width=8, num_snakes=3, snake_length=3,
                    done_mode='any')
    b = 5
    gen = torch.Generator().manual_seed(4)
    state, obs = engine.reset(cfg, engine.spawn_tables(cfg, 'cpu'),
                              reset_draws(cfg, b, gen, 'cpu'))
    envs = step_kernel.StaticEnvs(cfg, b, 'cpu')
    envs.load(state)
    envs.out.obs.copy_(obs)
    none = torch.zeros(b, dtype=torch.bool)
    for _ in range(6):
        actions = torch.randint(0, 3, (b, 3), generator=gen,
                                dtype=torch.int32)
        fruit = torch.rand((b, 3), generator=gen)
        want = step_kernel.step(cfg, envs.state, actions, fruit)
        got = step_kernel.step(cfg, envs.state, actions, fruit,
                               hold=(none, envs.out))
        plan = step_kernel._plan(cfg, b, torch.device('cpu'))
        arena = plan.pack(envs.state, envs.out)
        launched = plan.launch_step(arena, actions, fruit, none)
        for pair in (got, launched):
            for g, w in zip(pair, want):
                for (name, x), (_, y) in zip(g.fields(), w.fields()):
                    assert x.dtype == y.dtype and torch.equal(x, y), name
        envs.store(*want)
    assert plain_library.calls == 6


# --- the batched evaluation --------------------------------------------------

def evaluate_step_loop(net, cfg, e, max_steps, reset, fruit_u):
    """The per-step loop the chunks replace: one read-back a step, a
    break once every env is done. Returns (rew, life, steps)."""
    n = cfg.num_snakes
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=False, device='cpu')
    states, obs = reset_fn(reset)
    dones = torch.zeros((e, n), dtype=torch.bool)
    dirs = torch.zeros((e, n, 2), dtype=torch.int32)
    rew = torch.zeros((e, n))
    life = torch.zeros_like(rew)
    out, steps = None, 0
    for t in range(max_steps):
        active = ~dones
        frozen = dones.all(-1)
        q = net(obs.reshape((e * n,) + obs.shape[2:])).reshape(e, n, -1)
        acts, new_dirs = EV.masked_actions(obs, q, dirs, active)
        states, out = step_fn(states, acts, StepDraws(fruit_u[t], None, None),
                              hold=(frozen, out) if t > 0 else None)
        obs = out.obs
        dirs = torch.where(frozen[:, None, None], dirs, new_dirs)
        rew = rew + torch.where(active, out.reward, 0.0)
        life = life + active.to(torch.float32)
        dones = dones | out.done
        steps = t + 1
        if bool(dones.all()):
            break
    return rew, life, steps


@pytest.mark.parametrize('n,done_mode,e,max_steps,ends_inside', [
    (4, 'any', 4, 20, True), (2, 'all', 3, 13, False)],
    ids=['ends-inside-a-chunk', '13-steps'])
def test_evaluate_batch_chunks_match_jax_and_the_step_loop(
        n, done_mode, e, max_steps, ends_inside):
    jcfg, cfg = configs(height=8, width=8, num_snakes=n, snake_length=3,
                        done_mode=done_mode)
    params, net = flax_dqn(5, (8, 8))
    key = jax.random.key(6)
    jrun = JEV.build_evaluate_batch(FlaxDQN(num_actions=3), jcfg, e,
                                    max_steps)
    jr, jt = (float(x) for x in jrun(params, key))
    reset_keys = jax.random.split(key, e)
    reset = reset_draws_from_keys(cfg, reset_keys)
    fruit_u = jax_fruit_draws(reset_keys, max_steps, n)

    calls, step = [], step_kernel.step

    def counting(*args, **kwargs):
        calls.append(None)
        return step(*args, **kwargs)

    run = EV.build_evaluate_batch(net, cfg, e, max_steps, device='cpu')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_kernel, 'step', counting)
        got = run(reset=reset, fruit_u=fruit_u)
    np.testing.assert_allclose(float(got.mean_reward), jr, rtol=1e-6)
    np.testing.assert_allclose(float(got.mean_lifetime), jt, rtol=1e-6)
    rew, life, steps = evaluate_step_loop(net, cfg, e, max_steps, reset,
                                          fruit_u)
    assert got.steps == steps
    assert torch.equal(got.mean_reward, rew.mean())
    assert torch.equal(got.mean_lifetime, life.mean())
    # whole chunks, the last one past the end or past max_steps
    assert len(calls) == chunks_run(steps) and run.chunk_steps == 8
    if ends_inside:
        assert steps < max_steps and steps % 8
    else:
        assert steps == max_steps and max_steps % 8
    again = run.uncaptured(reset=reset, fruit_u=fruit_u)
    assert again.steps == got.steps
    assert torch.equal(again.mean_reward, got.mean_reward)
    (loop,) = run.captured_loops()
    assert loop.graph is None


# --- the batched battle ------------------------------------------------------

def battle_step_loop(net, cfg, opponents, e, max_steps, draws):
    """The per-step battle loop the chunks replace (one read-back a step,
    a break once every env is done). Returns (rewards, lifetimes)."""
    n = cfg.num_snakes
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=False, device='cpu')
    states, obs = reset_fn(draws.reset)
    auxs = [op.init(e, 'cpu') for op in opponents]
    dones = torch.zeros((e, n), dtype=torch.bool)
    dirs = torch.zeros((e, 2), dtype=torch.int32)
    rew = torch.zeros((e, n))
    life = torch.zeros_like(rew)
    out = None
    for t in range(max_steps):
        frozen = dones.all(-1)
        a0, new_dirs = BB.masked_seat0(obs[:, 0], net(obs[:, 0]), dirs,
                                       ~dones[:, 0])
        acts = [torch.where(dones[:, 0], 0, a0)]
        for i, op in enumerate(opponents):
            seat = draws.seat[i]
            ai, auxs[i] = op.apply(obs[:, i + 1], auxs[i],
                                   None if seat is None else seat[t])
            acts.append(torch.where(dones[:, i + 1], 0, ai))
        states, out = step_fn(states, torch.stack(acts, 1),
                              StepDraws(draws.fruit_u[t], None, None),
                              hold=(frozen, out) if t > 0 else None)
        obs = out.obs
        dirs = torch.where(frozen[:, None], dirs, new_dirs)
        life = life + (~dones).to(torch.float32)
        rew = rew + torch.where(frozen[:, None], 0.0, out.reward)
        dones = dones | out.done
        if bool(dones.all()):
            break
    return rew, life


def battle_lineups(name, cfg, hw):
    """(JAX opponents, port opponents) of a lineup."""
    if name == 'greedy+random':
        return ([JBB.BatchedGreedy(), JBB.BatchedRandom()],
                [BB.BatchedGreedy(), BB.BatchedRandom()])
    params, net = flax_dqn(8, hw)
    state = net.state_dict()
    jcfg = JN.NeatConfig(num_inputs=128, num_outputs=3)
    tcfg = TN.NeatConfig(num_inputs=128, num_outputs=3)
    jgenome = mutated_population(
        JN, jcfg, JH.fc3_to_genome(dqn_to_flax(state, hw), jcfg), 3)[2]
    tgenome = mutated_population(
        TN, tcfg, TH.fc3_to_genome(state, tcfg), 3)[2]
    return ([JBB.BatchedDQN(params),
             JBB.BatchedNEAT(dqn_to_flax(state, hw), jgenome, jcfg),
             JBB.BatchedGreedy()],
            [BB.BatchedDQN(net),
             BB.BatchedNEAT(state, tgenome, tcfg, cfg, device='cpu'),
             BB.BatchedGreedy()])


@pytest.mark.parametrize('lineup,n,done_mode,max_steps,seed', [
    ('greedy+random', 3, 'any', 20, 12),
    ('dqn+neat+greedy', 4, 'all', 13, 11)])
def test_battle_batch_chunks_match_jax_and_the_step_loop(
        lineup, n, done_mode, max_steps, seed):
    jcfg, cfg = configs(height=10, width=10, num_snakes=n, snake_length=3,
                        done_mode=done_mode)
    e = 4
    params, net = flax_dqn(2, (10, 10))
    jopp, topp = battle_lineups(lineup, cfg, (10, 10))
    key = jax.random.key(seed)
    jrun = JBB.build_battle_batch(FlaxDQN(num_actions=3), jcfg, jopp,
                                  num_envs=e, max_steps=max_steps)
    jr, jl = (np.asarray(x) for x in jrun(params, key))
    draws = battle_draws_from_key(cfg, key, [op.draws for op in topp], e,
                                  max_steps)
    run = BB.build_battle_batch(net, cfg, topp, num_envs=e,
                                max_steps=max_steps, device='cpu')
    rew, life = run(draws=draws)
    np.testing.assert_allclose(rew.numpy(), jr, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(life.numpy(), jl)
    want_rew, want_life = battle_step_loop(net, cfg, topp, e, max_steps,
                                           draws)
    assert torch.equal(rew, want_rew) and torch.equal(life, want_life)
    steps = int(life.max())
    if done_mode == 'any':
        assert steps < max_steps and steps % 8   # ends inside a chunk
    else:
        assert steps == max_steps == 13          # the last chunk runs over
    again = run.uncaptured(draws=draws)
    assert torch.equal(again[0], rew) and torch.equal(again[1], life)


# --- the fitness episodes ----------------------------------------------------

BOARD = dict(height=10, width=10, num_snakes=2, snake_length=3,
             done_mode='any')


def fitness_configs():
    return (JConfig.from_reward_dict(JH.DEFAULT_REWARD, **BOARD),
            EnvConfig.from_reward_dict(TH.DEFAULT_REWARD, **BOARD))


def fitness_step_loop(tr, act, draws):
    """The per-step fitness episode the chunks replace (one read-back a
    step, a break once every snake is done). Returns (returns (P, N),
    the steps taken, each later step's rewards had the loop gone on)."""
    states, obs = tr._reset_env(draws.reset)
    p, n = obs.shape[:2]
    done = torch.zeros((p, n), dtype=torch.bool)
    ret = torch.zeros((p, n))
    steps = 0
    for t in range(tr.episode_steps):
        emb = tr.net.features(obs.reshape((p * n,) + obs.shape[2:]))
        actions = torch.where(done, 0, act(emb.view(p, n, -1)))
        states, out = tr._step_env(
            states, actions, StepDraws(draws.fruit_u[t], None, None))
        obs, done, ret = out.obs, done | out.done, ret + out.reward
        steps = t + 1
        if bool(done.all()):
            break
    # one more step, as a chunk's tail would take it unmasked
    after = None
    if steps < tr.episode_steps:
        alive = states.alive.clone()
        _, out = tr._step_env(states, torch.zeros((p, n), dtype=torch.int32),
                              StepDraws(draws.fruit_u[steps], None, None))
        after = (alive, out.reward)
    return ret.numpy(), steps, after


@torch.no_grad()
def test_neat_fitness_chunks_match_jax_in_two_buckets(tmp_path):
    """Two populations in two (m, num_sweeps) buckets (the fc3 seed's
    clones; mutants with hidden sigmoid and tanh nodes), each through
    JAX's ``_episode_runner`` of its bucket and through the port's
    chunks, A, B, A: returns within 1e-6 of JAX's, EQUAL to the per-step
    loop's; one graph's buffers a bucket; the env steps counted in whole
    chunks. Episodes end inside a chunk (13 steps at most): after the
    last env is done the engine would still pay the snakes that are done
    but alive, so the chunk must add nothing then; snakes that died earn
    exactly 0."""
    steps = 13
    jcfg, cfg = fitness_configs()
    params, _ = flax_dqn(3, (10, 10))
    jn = JN.NeatConfig(num_inputs=128, num_outputs=3, pop_size=6)
    tn = TN.NeatConfig(num_inputs=128, num_outputs=3, pop_size=6)
    jtr = JH.HybridNEATTrainer(params, env_cfg=jcfg, neat_cfg=jn,
                               episode_steps=steps,
                               result_file=str(tmp_path / 'j.pkl'))
    ttr = TH.HybridNEATTrainer(params, env_cfg=cfg, neat_cfg=tn,
                               episode_steps=steps, device='cpu',
                               result_file=str(tmp_path / 't.pkl'))
    jseed = JH.fc3_to_genome(params, jn)
    tseed = TH.fc3_to_genome(params, tn)
    pops = {'clones': ([jseed] * 6, [tseed] * 6),
            'mutants': (mutated_population(JN, jn, jseed, 6),
                        mutated_population(TN, tn, tseed, 6))}
    runs = 0
    ended_inside = False
    # the clones' episodes end at steps 7 and 2, the mutants' runs its 13
    for name, k_ep in (('clones', 2), ('mutants', 1), ('clones', 7)):
        jgen, tgen = pops[name]
        jb = JH.PaddedNetBatch(jgen, jn)
        tb = TH.PaddedNetBatch(tgen, tn, device='cpu')
        key = jax.random.key(k_ep)
        states, obs = jtr._reset_jit(jnp.broadcast_to(key[None], (6,)))
        want = np.asarray(jtr._episode_runner(jb.m, jb.num_sweeps)(
            jtr.dqn_params, *jb.tensors, states, obs))
        draws = episode_draws_from_key(cfg, key, steps).take(
            torch.zeros(6, dtype=torch.long))
        got = ttr._episode(TH.neat_head(tb), draws)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        loop_ret, taken, after = fitness_step_loop(ttr, tb.acts, draws)
        np.testing.assert_array_equal(got, loop_ret)
        runs += chunks_run(taken)
        assert ttr.env_steps == runs == ttr.env_steps_by_width[6]
        if after is not None:
            alive, reward = after
            assert (reward[~alive] == 0).all()
            # done but alive ('any'): the time reward, which JAX never adds
            assert (reward[alive] != 0).any()
            ended_inside |= bool(taken % 8)
    assert ended_inside
    keys = set(ttr.captured_loops())
    assert len(keys) == 2 and all(k[:2] == (6, 'neat') for k in keys)
    assert {k[2:] for k in keys} == {
        (b.m, b.num_sweeps) for b in (
            TH.PaddedNetBatch(g, tn, device='cpu')
            for _, g in pops.values())}


@torch.no_grad()
def test_es_fitness_chunks_match_jax_and_take_their_widths(tmp_path):
    """The ES head's members (the seed's fc3 perturbed from a numpy seed)
    through JAX's ``run`` program and the port's chunks: returns within
    1e-6 of JAX's, EQUAL to the per-step loop's; validation and the
    hold-out blocks run under keys of their own widths."""
    steps = 13
    jcfg, cfg = fitness_configs()
    params, _ = flax_dqn(4, (10, 10))
    common = dict(episode_steps=steps, pop_size=4, fitness_episodes=1)
    jtr = JH.HeadESTrainer(params, env_cfg=jcfg,
                           result_file=str(tmp_path / 'j.pkl'), **common)
    ttr = TH.HeadESTrainer(params, env_cfg=cfg, device='cpu',
                           result_file=str(tmp_path / 't.pkl'), **common)
    rng = np.random.default_rng(0)
    k, b = ttr.kernel.numpy(), ttr.bias.numpy()
    W = (k[None] + 0.3 * rng.normal(size=(5,) + k.shape)).astype(np.float32)
    bias = (b[None] + 0.3 * rng.normal(size=(5, 3))).astype(np.float32)
    key = jax.random.key(9)
    states, obs = jtr._reset_jit(jnp.broadcast_to(key[None], (5,)))
    want = np.asarray(jtr._run(jtr.dqn_params, jnp.asarray(W),
                               jnp.asarray(bias), states, obs))
    draws = episode_draws_from_key(cfg, key, steps).take(
        torch.zeros(5, dtype=torch.long))
    got = ttr._run(torch.as_tensor(W), torch.as_tensor(bias), draws)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert len(set(got.sum(-1).tolist())) > 1
    loop_ret, taken, _ = fitness_step_loop(
        ttr, lambda emb: TH._es_acts((torch.as_tensor(W),
                                      torch.as_tensor(bias)), emb), draws)
    np.testing.assert_array_equal(got, loop_ret)
    ttr.validate(ttr._seed_theta, 3)
    ttr.holdout_returns(ttr._seed_theta, ttr._seed_theta, episodes=3,
                        block=2)
    assert set(ttr.captured_loops()) == {(5, 'es'), (3, 'es'), (4, 'es'),
                                         (2, 'es')}
    assert ttr.env_steps == sum(ttr.env_steps_by_width.values())
    assert all(v % 8 == 0 for v in ttr.env_steps_by_width.values())
