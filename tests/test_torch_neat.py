"""marlsnake_torch.algo.neat and .neat_hybrid against the JAX package.

The port's NEAT is a copy of the JAX package's pure-Python NEAT, so the
same runs give the same genomes, genes and fitnesses (EQUAL). The hybrid
trainers' episodes take the JAX trainers' own draws: each episode's key
(``fold_in`` of the generation key) gives one env's reset draws and the
fruit draws of every step, copied to every member, as JAX broadcasts the
key. Float32 on the CPU, TF32 off. Tolerances, each where it is used:

* the padded-net sweeps against JAX's and against
  ``FeedForwardNetwork.activate``: rtol 1e-5, atol 1e-5 (the same float32
  products summed in other orders; activate sums in float64);
* a fitness episode: every action EQUAL, and every compared decision is
  either more than 1e-4 from a tie or has the same values on both sides
  (the relu head's exact zeros); returns EQUAL, fitness within rtol 1e-6;
* ES: fitnesses and validation scores within rtol 1e-6, theta within atol
  1e-6 (the update's sums are taken in other orders);
* the DQN features of the trained checkpoint against flax's: rtol 1e-5,
  atol 1e-5 (trained features reach ~44; fc1 sums 25,600 float32
  products, in other orders).
"""

import copy
import dataclasses
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.algo import neat as JN
from marlsnake_tpu.algo import neat_hybrid as JH
from marlsnake_tpu.core.types import EnvConfig as JConfig
from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_torch.algo import neat as TN
from marlsnake_torch.algo import neat_hybrid as TH
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.models.dqn import DQN
from marlsnake_torch.models.weights import dqn_from_flax
from marlsnake_torch.rng import EpisodeDraws, ESDraws
from test_torch_engine import _t, reset_draws_from_keys
from test_torch_evaluator import jax_fruit_draws

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, STEPS = (10, 10), 32
BOARD = dict(height=10, width=10, num_snakes=2, snake_length=3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test here runs many small CPU ops. When several pytest
    workers share the CPU, torch's intra-op threads spin against theirs:
    one thread a test keeps the file's time near its time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs():
    return (JConfig.from_reward_dict(JH.DEFAULT_REWARD, **BOARD),
            EnvConfig.from_reward_dict(TH.DEFAULT_REWARD, **BOARD))


def flax_params(seed, hw=HW):
    return jax.device_get(FlaxDQN(num_actions=3).init(
        jax.random.key(seed), jnp.zeros((1,) + hw + (8,), jnp.float32)))


def genes(g):
    return (g.key, g.fitness,
            {k: (n.bias, n.activation, n.response)
             for k, n in g.nodes.items()},
            {k: (c.weight, c.enabled) for k, c in g.connections.items()})


def episode_draws_from_key(cfg, key, steps=STEPS):
    """One env's draws of the episode JAX plays from ``key``."""
    keys = key[None]
    return EpisodeDraws(reset_draws_from_keys(cfg, keys),
                        jax_fruit_draws(keys, steps, cfg.num_snakes))


def mutated_population(N, cfg, seed_genome, size=8):
    """The seed genome and heavily mutated descendants with hidden
    sigmoid and tanh nodes (tests/test_algo.py:176-215) and perturbed
    weights, built with the package ``N``'s own mutation operators."""
    genomes = [seed_genome]
    next_key = [cfg.num_outputs + 1000]
    pyr = random.Random(3)
    for gi in range(1, size):
        g = seed_genome.copy(gi)
        for _ in range(1 + gi):
            g._mutate_add_node(cfg, pyr, next_key)
            g._mutate_add_conn(cfg, pyr)
        for nk in list(g.nodes):
            if pyr.random() < 0.4:
                g.nodes[nk].activation = pyr.choice(
                    ('relu', 'sigmoid', 'tanh'))
        g.mutate(cfg, pyr, next_key)
        genomes.append(g)
    return genomes


# --- the NEAT copy -----------------------------------------------------------

def test_population_evolves_the_same_genomes_on_xor():
    """tests/test_algo.py:140-157 in both packages: every generation's
    keys and fitnesses, and the final genomes gene for gene, EQUAL."""
    def evolve(N):
        cfg = N.NeatConfig(num_inputs=2, num_outputs=1, pop_size=60,
                           activation_default='sigmoid',
                           activation_options=('sigmoid',),
                           compatibility_threshold=3.0)
        cases = [((0, 0), 0), ((0, 1), 1), ((1, 0), 1), ((1, 1), 0)]
        history = []

        def eval_fn(genomes, c):
            for _, g in genomes:
                net = N.FeedForwardNetwork.create(g, c)
                g.fitness = 4.0 - sum((net.activate(x)[0] - y) ** 2
                                      for x, y in cases)
            history.append([(g.key, g.fitness) for _, g in genomes])

        pop = N.Population(cfg, seed=1)
        best = pop.run(eval_fn, 12, verbose=False)
        return history, [genes(g) for g in pop.genomes], genes(best), [
            (sp.key, sp.best_fitness, len(sp.members)) for sp in pop.species]

    want, got = evolve(JN), evolve(TN)
    assert len(got[0]) == 12
    assert got == want


# --- the padded population and its sweeps --------------------------------------

def test_padded_batch_and_sweeps_match_jax_and_the_python_net():
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(16, 3)).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    params = {'params': {'fc3': {'kernel': kernel, 'bias': bias}}}
    state_dict = {'fc3.weight': torch.as_tensor(kernel.T),
                  'fc3.bias': torch.as_tensor(bias)}
    jcfg = JN.NeatConfig(num_inputs=16, num_outputs=3)
    cfg = TN.NeatConfig(num_inputs=16, num_outputs=3)
    jgen = mutated_population(JN, jcfg, JH.fc3_to_genome(params, jcfg))
    tgen = mutated_population(TN, cfg, TH.fc3_to_genome(state_dict, cfg))
    assert [genes(g) for g in tgen] == [genes(g) for g in jgen]
    assert any(n.activation != 'relu' for g in tgen for n in g.nodes.values())

    jb, tb = JH.PaddedNetBatch(jgen, jcfg), TH.PaddedNetBatch(tgen, cfg,
                                                              device='cpu')
    assert (tb.m, tb.num_sweeps) == (jb.m, jb.num_sweeps)
    for j, t in zip(jb.tensors, tb.tensors):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    emb = (3 * rng.normal(size=(len(tgen), 4, 16))).astype(np.float32)
    got = tb.logits(torch.as_tensor(emb)).numpy()
    np.testing.assert_allclose(got, jb.logits(emb), rtol=1e-5, atol=1e-5)
    # sweep_values on its own, with the batch's tensors as arguments
    again = TH.sweep_values(*tb.tensors, tb.num_sweeps, 16, 3,
                            torch.as_tensor(emb)).numpy()
    np.testing.assert_array_equal(again, got)
    acts = tb.acts(torch.as_tensor(emb)).numpy()
    assert acts.dtype == np.int32
    nets = [TN.FeedForwardNetwork.create(g, cfg) for g in tgen]
    for p, net in enumerate(nets):
        for a in range(emb.shape[1]):
            want = np.asarray(net.activate(emb[p, a]), np.float64)
            np.testing.assert_allclose(got[p, a], want, rtol=1e-5,
                                       atol=1e-5, err_msg=f'{p} {a}')
            top2 = np.sort(want)[-2:]
            if top2[1] - top2[0] > 1e-4:
                assert acts[p, a] == int(np.argmax(want)), (p, a)


def test_seed_genome_matches_jax():
    """fc3_to_genome of the port's DQN (flax weights through
    dqn_from_flax), of its state_dict and of the flax tree: gene for gene
    JAX's."""
    params = flax_params(1)
    jcfg = JN.NeatConfig(num_inputs=128, num_outputs=3)
    cfg = TN.NeatConfig(num_inputs=128, num_outputs=3)
    net = DQN(HW, 8, 3, assume_binary_obs=True, device='cpu')
    net.load_state_dict(dqn_from_flax(params, HW))
    want = genes(JH.fc3_to_genome(params, jcfg))
    for dqn in (net, net.state_dict(), params):
        assert genes(TH.fc3_to_genome(dqn, cfg)) == want


# --- fitness episodes and generations ------------------------------------------

def trainers(params, tmp, seed=0, pop=8, **kwargs):
    jcfg, cfg = configs()
    jn, tn = (N.NeatConfig(num_inputs=128, num_outputs=3, pop_size=pop)
              for N in (JN, TN))
    jtr = JH.HybridNEATTrainer(params, env_cfg=jcfg, neat_cfg=jn,
                               episode_steps=STEPS, seed=seed,
                               result_file=f'{tmp}/j.pkl', **kwargs)
    ttr = TH.HybridNEATTrainer(params, env_cfg=cfg, neat_cfg=tn,
                               episode_steps=STEPS, seed=seed,
                               result_file=f'{tmp}/t.pkl', device='cpu',
                               **kwargs)
    return jtr, ttr


def top_block(values):
    """(where each decision's values equal its maximum (..., A), the gap
    from that maximum to the largest value below it): an argmax takes
    the block's first index, so a decision is the same on both sides
    when the blocks are and the gap exceeds the two sides' difference.
    Exact ties (the relu head's zeros, a saturated sigmoid) form one
    block."""
    top = values.max(-1, keepdims=True)
    block = values == top
    below = np.where(block, -np.inf, values).max(-1)
    return block, top[..., 0] - below


def replay_jax_episode(jtr, batch, k_ep, pop):
    """The episode JAX's runner plays from ``k_ep`` (neat_hybrid.py:
    321-343), step by step with its jitted pieces. Returns (returns (P, N),
    [(values (P, N, 3), done before the step)] of every step)."""
    inp, out = jtr.neat_cfg.num_inputs, jtr.neat_cfg.num_outputs
    sweeps = jax.jit(lambda emb: JH.sweep_values(
        *batch.tensors, batch.num_sweeps, inp, out, emb))
    states, obs = jtr._reset_jit(jnp.broadcast_to(k_ep[None], (pop,)))
    n = obs.shape[1]
    done = np.zeros((pop, n), bool)
    ret = np.zeros((pop, n), np.float32)
    steps = []
    for _ in range(jtr.episode_steps):
        if done.all():
            break
        vals = np.asarray(sweeps(jtr._embed(jtr.dqn_params, obs)))
        steps.append((vals, done.copy(), np.asarray(obs)))
        actions = np.where(done, 0, vals.argmax(-1)).astype(np.int32)
        states, o = jtr._step_jit(states, jnp.asarray(actions))
        done |= np.asarray(o.done)
        ret += np.asarray(o.reward)
        obs = o.obs
    return ret, steps


def test_fitness_episode_matches_jax(tmp_path):
    """8 genomes (the fc3 seed and mutants with hidden sigmoid and tanh
    nodes), one 32-step episode on JAX's draws: the port's features and
    sweeps on each step's obs agree with JAX's decisions, and its
    eval_genomes gives JAX's fitness to every genome."""
    params = flax_params(2)
    jtr, ttr = trainers(params, tmp_path, seed=5)
    jgen = mutated_population(JN, jtr.neat_cfg,
                              JH.fc3_to_genome(params, jtr.neat_cfg))
    tgen = mutated_population(TN, ttr.neat_cfg,
                              TH.fc3_to_genome(params, ttr.neat_cfg))
    pop = len(jgen)
    # the key of JAX's first generation's first episode
    k_ep = jax.random.fold_in(jax.random.fold_in(jax.random.key(5), 1), 0)
    jbatch = JH.PaddedNetBatch(jgen, jtr.neat_cfg)
    ret, steps = replay_jax_episode(jtr, jbatch, k_ep, pop)
    run = jtr._episode_runner(jbatch.m, jbatch.num_sweeps)
    states, obs = jtr._reset_jit(jnp.broadcast_to(k_ep[None], (pop,)))
    np.testing.assert_array_equal(
        ret, np.asarray(run(jtr.dqn_params, *jbatch.tensors, states, obs)))

    tbatch = TH.PaddedNetBatch(tgen, ttr.neat_cfg, device='cpu')
    decisions = ties = 0
    for t, (vals, done, obs_t) in enumerate(steps):
        with torch.no_grad():
            emb = ttr.net.features(_t(obs_t).flatten(0, 1)).view(
                pop, 2, -1)
        mine = tbatch.logits(emb).numpy()
        np.testing.assert_allclose(mine, vals, rtol=1e-5, atol=1e-5)
        live = ~done
        jtop, jmargin = top_block(vals)
        ttop, _ = top_block(mine)
        assert (jtop == ttop).all(-1)[live].all(), f'step {t}'
        assert (jmargin[live] > 1e-4).all(), f'a near-tie at step {t}'
        decisions += int(live.sum())
        ties += int((jtop.sum(-1) > 1)[live].sum())
    assert decisions > 100 and len(steps) > 5, (decisions, ties)

    jtr.eval_genomes([(g.key, g) for g in jgen], jtr.neat_cfg)
    draws = episode_draws_from_key(ttr.env_cfg, k_ep)
    ttr.eval_genomes([(g.key, g) for g in tgen], ttr.neat_cfg, [draws])
    got = np.array([g.fitness for g in tgen])
    np.testing.assert_allclose(got, [g.fitness for g in jgen], rtol=1e-6)
    np.testing.assert_array_equal(got, ret.mean(-1))
    assert len(set(got.tolist())) > 1
    assert ttr.env_steps == len(steps)


def test_neat_generations_match_jax(tmp_path):
    """HybridNEATTrainer.run(2) at pop 8, two fitness episodes a
    generation, on JAX's draws: every genome's fitness in both
    generations, the winner and the saved result EQUAL."""
    params = flax_params(3)
    jtr, ttr = trainers(params, tmp_path, seed=7, fitness_episodes=2)
    record = {}
    for name, tr in (('jax', jtr), ('port', ttr)):
        inner = tr.eval_genomes

        def recording(genomes, cfg, *args, inner=inner, name=name):
            inner(genomes, cfg, *args)
            record.setdefault(name, []).append(
                [(k, g.fitness) for k, g in genomes])

        tr.eval_genomes = recording
    jbest = jtr.run(2, verbose=False)
    root = jax.random.key(7)
    draws = [[episode_draws_from_key(
        ttr.env_cfg, jax.random.fold_in(jax.random.fold_in(root, g), j))
        for j in range(2)] for g in (1, 2)]
    tbest = ttr.run(2, verbose=False, draws=draws)
    assert len(record['port']) == 2
    for a, b in zip(record['port'], record['jax']):
        np.testing.assert_allclose([f for _, f in a], [f for _, f in b],
                                   rtol=1e-6)
        assert [k for k, _ in a] == [k for k, _ in b]
    assert genes(tbest) == genes(jbest)
    saved = TH.load_hybrid_raw(str(tmp_path / 't.pkl'))
    assert genes(saved['neat_genome']) == genes(
        JH.load_hybrid_raw(str(tmp_path / 'j.pkl'))['neat_genome'])
    assert ttr.env_steps > 2 * 2 * 10


def test_clones_score_identically_and_runs_repeat(tmp_path):
    """Common random numbers: four clones of the seed genome score the
    same over three episodes; the same seed gives the same run."""
    params = flax_params(4)
    _, tr = trainers(params, tmp_path, pop=4, fitness_episodes=3)
    g = TH.fc3_to_genome(params, tr.neat_cfg)
    genomes = [(i, copy.deepcopy(g)) for i in range(4)]
    tr.eval_genomes(genomes, tr.neat_cfg)
    assert len({gn.fitness for _, gn in genomes}) == 1
    runs = []
    for _ in range(2):
        _, tr = trainers(params, tmp_path, seed=3, pop=4)
        runs.append(genes(tr.run(1, verbose=False)))
    assert runs[0] == runs[1]


def es_trainers(params, tmp, seed=0, **kwargs):
    jcfg, cfg = configs()
    common = dict(episode_steps=16, pop_size=4, sigma=0.05,
                  fitness_episodes=2, seed=seed, **kwargs)
    return (JH.HeadESTrainer(params, env_cfg=jcfg, result_file=f'{tmp}/j.pkl',
                             neat_cfg=JN.NeatConfig(), **common),
            TH.HeadESTrainer(params, env_cfg=cfg, result_file=f'{tmp}/t.pkl',
                             neat_cfg=TN.NeatConfig(), device='cpu',
                             **common))


def test_head_es_generation_matches_jax(tmp_path):
    """HeadESTrainer.run(1) on JAX's perturbations, episodes and
    validation set: the history, the champion and its score."""
    params = flax_params(5)
    jtr, ttr = es_trainers(params, tmp_path, seed=2)
    jtheta, jval, jhist = jtr.run(1, verbose=False, val_episodes=3)

    key, k_eps, k_env = jax.random.split(jax.random.key(2), 3)
    eps_k = jax.random.normal(k_eps, (2, 128, 3))
    eps_b = jax.random.normal(jax.random.fold_in(k_eps, 1), (2, 3))
    episodes = tuple(episode_draws_from_key(
        ttr.env_cfg, jax.random.fold_in(k_env, j), 16) for j in range(2))
    val_keys = jtr._val_keys(3)
    val = EpisodeDraws(reset_draws_from_keys(ttr.env_cfg, val_keys),
                       jax_fruit_draws(val_keys, 16, 2))
    ttheta, tval, thist = ttr.run(
        1, verbose=False, val_episodes=3, val_draws=val,
        draws=[ESDraws(_t(eps_k), _t(eps_b), episodes)])
    (jrec,), (trec,) = jhist, thist
    assert trec.keys() == jrec.keys()
    for k in jrec:
        np.testing.assert_allclose(trec[k], jrec[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tval, jval, rtol=1e-6)
    for t, j in zip(ttheta, jtheta):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    assert trec['pert_best'] != trec['pert_mean']
    saved = TH.load_hybrid_raw(str(tmp_path / 't.pkl'))['neat_genome']
    assert saved.fitness == tval
    assert ttr.env_steps > 0


def test_head_es_runs_repeat_and_holdout_is_paired(tmp_path):
    """The relu head equals the fc3-seeded genome's net; one seed gives
    the same generation twice; a head against itself on the hold-out
    set differs by exactly 0 (tests/test_algo.py:532-614)."""
    params = flax_params(6)
    _, a = es_trainers(params, tmp_path, seed=1)
    _, b = es_trainers(params, tmp_path, seed=1)
    genome = a.theta_to_genome(a._seed_theta)
    net = TN.FeedForwardNetwork.create(genome, a.neat_cfg)
    emb = np.random.default_rng(0).normal(size=(2, 128)).astype(np.float32)
    want = np.maximum(emb @ a.kernel.numpy() + a.bias.numpy(), 0.0)
    for i in range(2):
        np.testing.assert_allclose(net.activate(emb[i]), want[i],
                                   rtol=1e-5, atol=1e-5)
    ha = a.run(1, verbose=False, val_episodes=2)[2]
    hb = b.run(1, verbose=False, val_episodes=2)[2]
    assert ha == hb and np.isfinite(ha[0]['theta_fitness'])
    ma, mb, dmean, dstd = a.holdout_compare(a._seed_theta, a._seed_theta,
                                            episodes=3, block=2)
    assert ma == mb and dmean == 0.0 and dstd == 0.0


# --- checkpoints --------------------------------------------------------------

def test_msgpack_checkpoints_load_in_both_packages(tmp_path):
    params = flax_params(7)
    jcfg = JN.NeatConfig(num_inputs=128, num_outputs=3, pop_size=7)
    cfg = TN.NeatConfig(num_inputs=128, num_outputs=3, pop_size=7)
    for writer, N, H, c in (('jax', JN, JH, jcfg), ('port', TN, TH, cfg)):
        genome = H.fc3_to_genome(params, c)
        genome.fitness = np.float32(1.25)
        path = str(tmp_path / f'{writer}.msgpack')
        H.save_checkpoint_safe({'dqn_params': params, 'neat_genome': genome,
                                'neat_config': c}, path)
    for path in ('jax', 'port'):
        path = str(tmp_path / f'{path}.msgpack')
        a, b = JH.load_hybrid_raw(path), TH.load_hybrid_raw(path)
        assert dataclasses.asdict(b['neat_config']) == dataclasses.asdict(
            a['neat_config']) == dataclasses.asdict(cfg)
        assert genes(b['neat_genome']) == genes(a['neat_genome'])
        assert b['neat_genome'].fitness == 1.25
        assert b['format'] == a['format'] == 'marlsnake-hybrid-v1'
        for la, lb in zip(jax.tree.leaves(a['dqn_params']),
                          jax.tree.leaves(b['dqn_params'])):
            assert la.dtype == lb.dtype
            np.testing.assert_array_equal(la, lb)
    # the two writers give the same bytes
    with open(tmp_path / 'jax.msgpack', 'rb') as fa, \
            open(tmp_path / 'port.msgpack', 'rb') as fb:
        assert fa.read() == fb.read()


def test_trained_checkpoint_loads_in_the_port():
    """artifacts/hybrid_neat_20x20.pkl (written by the JAX package): its
    net equals JAX's on an embedding, and its DQN's features through
    dqn_from_flax match flax's."""
    path = os.path.join(REPO, 'artifacts', 'hybrid_neat_20x20.pkl')
    jparams, jnet = JH.load_hybrid(path)
    params, net = TH.load_hybrid(path)
    raw = TH.load_hybrid_raw(path)
    assert isinstance(raw['neat_genome'], TN.Genome)
    assert isinstance(raw['neat_config'], TN.NeatConfig)
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(3, 128)).astype(np.float32)
    for e in emb:
        assert net.activate(e) == jnet.activate(e)
    obs = (rng.random((3, 20, 20, 8)) < 0.1).astype(np.uint8)
    want = FlaxDQN(num_actions=3, assume_binary_obs=True).apply(
        jparams, jnp.asarray(obs), method=FlaxDQN.features)
    dqn = DQN((20, 20), 8, 3, assume_binary_obs=True, device='cpu')
    dqn.load_state_dict(dqn_from_flax(params, (20, 20)))
    with torch.no_grad():
        got = dqn.features(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unknown_pickle_global_is_refused(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.getcwd, ())

    path = str(tmp_path / 'evil.pkl')
    with open(path, 'wb') as f:
        pickle.dump({'dqn_params': Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match='getcwd'):
        TH.load_hybrid_raw(path)
    # the port's own pickle round-trips
    cfg = TN.NeatConfig(num_inputs=4, num_outputs=3)
    genome = TH.fc3_to_genome(
        {'fc3': {'kernel': np.ones((4, 3), np.float32),
                 'bias': np.zeros(3, np.float32)}}, cfg)
    TH.save_checkpoint_safe({'dqn_params': {'w': np.arange(3.0)},
                             'neat_genome': genome, 'neat_config': cfg},
                            str(tmp_path / 'own.pkl'))
    back = TH.load_hybrid_raw(str(tmp_path / 'own.pkl'))
    assert genes(back['neat_genome']) == genes(genome)
    np.testing.assert_array_equal(back['dqn_params']['w'], np.arange(3.0))


@pytest.mark.parametrize('render', [False, True], ids=['plain', 'video'])
def test_render_winner_headless(tmp_path, render):
    """render_winner on a checkpoint the port's trainer wrote, with and
    without its headless video."""
    if render:
        pytest.importorskip('cv2')
    params = flax_params(8)
    _, tr = trainers(params, tmp_path, pop=4)
    TH.save_checkpoint_safe({'dqn_params': tr.dqn_params,
                             'neat_genome': TH.fc3_to_genome(tr.net,
                                                             tr.neat_cfg),
                             'neat_config': tr.neat_cfg},
                            str(tmp_path / 'w.pkl'))
    _, cfg = configs()
    video = str(tmp_path / 'w.mp4')
    rew, life = TH.render_winner(str(tmp_path / 'w.pkl'), env_cfg=cfg,
                                 episodes=1, render=render, max_steps=12,
                                 video_path=video, seed=0, device='cpu')
    assert np.isfinite(rew) and life > 0
    assert os.path.exists(video) == render
