"""Hybrid NEAT-over-frozen-DQN evolution, and the head ES beside it.

The port of the JAX package's ``algo/neat_hybrid.py``, the counterpart of
the reference ``train_ga.py``: a pre-trained DQN is frozen as a 128-d
feature extractor (train_ga.py:94-111); NEAT evolves the 3-way decision
head, seeded with a genome equivalent to the DQN's own fc3 layer
(``fc3_to_genome``, train_ga.py:199-215), which is saved immediately as
the initial winner and overwritten whenever evolution improves on it
(train_ga.py:224-257). ``HeadESTrainer`` evolves the same head by
antithetic ES.

A fitness episode plays the whole population at once, one env per
member: each step the DQN's features of every (member, snake), the
members' heads (``sweep_values`` over a ``PaddedNetBatch`` for NEAT, a
relu layer for ES), ``argmax``, and one step of every env, on CUDA one
launch of the step kernel's entry without auto-reset
(``step_kernel.step``). Every env is stepped every step and every
snake's reward is summed, dead or alive, until ``episode_steps`` steps
or until every snake is done, as the JAX ``while_loop`` does. The steps
run in chunks of up to 8, on CUDA as the replays of one captured graph
a (width, head) bucket, with one read-back a chunk
(``_FitnessEpisodes``). Every member of an episode plays the same draws
(common random numbers): one env's ``EpisodeDraws``, copied to each
member's row.

Every method that draws takes its draws as an argument too
(``rng.EpisodeDraws``, ``rng.ESDraws``). Fitnesses, ranks and means are
taken on the host in float32 numpy, as the JAX trainers take them.

Checkpoints keep the JAX package's payload: ``dqn_params`` is the flax
tree of numpy arrays (``models.weights.dqn_to_flax``), the genome and
the ``NeatConfig`` are the port's copies of ``algo/neat.py``'s classes.
``.msgpack`` is flax's msgpack layout, written and read with ``msgpack``
alone, so that files pass between the packages both ways; any other
name is a pickle, read by a restricted unpickler that maps the JAX
package's NEAT classes onto the port's and refuses every other global
but numpy's array reconstruction. ``msgpack``, PIL and cv2 are imported
only by the functions that need them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import random
import time
from typing import Callable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from marlsnake_torch.algo import neat
from marlsnake_torch.algo.neat import (FeedForwardNetwork, Genome,
                                       NeatConfig, Population,
                                       _required_nodes, _topo_layers)
from marlsnake_torch.core.types import FEATURE_CHANNEL, EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.models.dqn import DQN
from marlsnake_torch.models.weights import dqn_from_flax, dqn_to_flax
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.rng import (EpisodeDraws, ESDraws, StepDraws,
                                 derive_seed, episode_draws, es_draws)
from marlsnake_torch.utils.cuda_graph import (CapturedLoop, GraphPool,
                                              copy_into, run_chunks,
                                              tail_chunk_steps)

DEFAULT_REWARD = {'fruit': 10.0, 'kill': 0.0, 'lose': -20.0, 'win': 0.0,
                  'time': -0.03}  # train_ga.py:266-273

HYBRID_FORMAT = 'marlsnake-hybrid-v1'
# flax's msgpack extension codes (flax.serialization._MsgpackExtType)
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_CHUNK_BYTES = 1 << 30  # flax splits larger arrays into chunks

_NEAT_MODULES = ('marlsnake_tpu.algo.neat', 'marlsnake_torch.algo.neat')
_NEAT_CLASSES = ('Genome', 'NodeGene', 'ConnGene', 'NeatConfig')
_NUMPY_GLOBALS = frozenset(
    (module, name)
    for module in ('numpy._core.multiarray', 'numpy.core.multiarray')
    for name in ('_reconstruct', 'scalar')) | {('numpy', 'ndarray'),
                                               ('numpy', 'dtype')}


def _default_env_cfg() -> EnvConfig:
    return EnvConfig.from_reward_dict(DEFAULT_REWARD, height=20, width=20,
                                      num_snakes=4, snake_length=5)


# --- checkpoints -------------------------------------------------------------

def _genome_to_dict(g: Genome) -> dict:
    return {
        'key': int(g.key),
        'fitness': None if g.fitness is None else float(g.fitness),
        'nodes': [[int(k), float(n.bias), n.activation,
                   float(n.response)] for k, n in g.nodes.items()],
        'connections': [[int(i), int(o), float(c.weight),
                         bool(c.enabled)]
                        for (i, o), c in g.connections.items()],
    }


def _genome_from_dict(d: dict) -> Genome:
    g = Genome(int(d['key']))
    g.fitness = d['fitness']
    for k, bias, act, resp in d['nodes']:
        g.nodes[int(k)] = neat.NodeGene(float(bias), str(act), float(resp))
    for i, o, wgt, en in d['connections']:
        g.connections[(int(i), int(o))] = neat.ConnGene(float(wgt),
                                                        bool(en))
    return g


def _canonical(x):
    """The tree as flax packs it: dicts with their keys sorted (as
    ``jax.tree_util`` rebuilds them) and tuples as lists (msgpack with
    ``strict_types`` packs no tuple), all the way down."""
    if isinstance(x, (tuple, list)):
        return [_canonical(v) for v in x]
    if isinstance(x, dict):
        return {k: _canonical(x[k]) for k in sorted(x)}
    return x


def _array_bytes(arr: np.ndarray) -> bytes:
    import msgpack
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError('object and structured dtypes cannot be stored')
    if arr.nbytes > _MAX_CHUNK_BYTES:
        raise ValueError('arrays above 1 GiB are chunked by flax, which '
                         'this writer does not do')
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes('C')),
                         use_bin_type=True)


def msgpack_pack(payload) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts, lists,
    Python scalars and numpy arrays, byte for byte: dicts with sorted
    keys, an array as extension 1 holding ``packb((shape, dtype name,
    C-order bytes))``, a numpy scalar as extension 3 (the same bytes of a
    0-d array)."""
    import msgpack

    def default(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(_EXT_NDARRAY, _array_bytes(x))
        if isinstance(x, np.generic):
            return msgpack.ExtType(_EXT_NPSCALAR,
                                   _array_bytes(np.asarray(x)))
        raise TypeError(f'cannot pack {type(x).__name__}')

    return msgpack.packb(_canonical(payload), default=default,
                         strict_types=True)


def msgpack_unpack(data: bytes):
    """The inverse of ``msgpack_pack`` (``flax.serialization.
    msgpack_restore`` for trees without chunked arrays)."""
    import msgpack

    def ext_hook(code, blob):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            return msgpack.ExtType(code, blob)
        shape, dtype, buf = msgpack.unpackb(blob, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(
            shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]

    tree = msgpack.unpackb(data, ext_hook=ext_hook, raw=False)
    if isinstance(tree, dict) and any(
            isinstance(v, dict) and '__msgpack_chunked_array__' in v
            for v in tree.values()):
        raise ValueError('chunked arrays (above 1 GiB) are not supported')
    return tree


class _HybridUnpickler(pickle.Unpickler):
    """Reads a hybrid checkpoint pickle of either package: the NEAT
    classes of both map onto the port's, numpy's array reconstruction is
    allowed, every other global is refused."""

    def find_class(self, module, name):
        if module in _NEAT_MODULES and name in _NEAT_CLASSES:
            return getattr(neat, name)
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f'global {module}.{name} is not allowed in a hybrid checkpoint')


def save_checkpoint_safe(data, filename: str):
    """Atomic hybrid-checkpoint write (train_ga.py:45-57): a temporary file
    beside ``filename``, then a rename. ``data`` holds ``dqn_params`` (the
    flax tree of numpy arrays), ``neat_genome`` and ``neat_config``. A
    ``.msgpack`` name selects the pickle-free format; any other name the
    reference's pickle layout."""
    tmp = filename + '.tmp'
    if filename.endswith('.msgpack'):
        payload = dict(data)
        payload['format'] = HYBRID_FORMAT
        payload['neat_genome'] = _genome_to_dict(payload['neat_genome'])
        payload['neat_config'] = dataclasses.asdict(payload['neat_config'])
        blob = msgpack_pack(payload)
        with open(tmp, 'wb') as f:
            f.write(blob)
    else:
        with open(tmp, 'wb') as f:
            pickle.dump(data, f)
    os.replace(tmp, filename)


def load_hybrid_raw(filename: str) -> dict:
    """Load either hybrid-checkpoint format, written by either package ->
    ``{'dqn_params', 'neat_genome': Genome, 'neat_config': NeatConfig}``."""
    if filename.endswith('.msgpack'):
        with open(filename, 'rb') as f:
            data = dict(msgpack_unpack(f.read()))
        data['neat_genome'] = _genome_from_dict(data['neat_genome'])
        cfg_d = dict(data['neat_config'])
        if isinstance(cfg_d.get('activation_options'), list):
            cfg_d['activation_options'] = tuple(
                cfg_d['activation_options'])
        data['neat_config'] = NeatConfig(**cfg_d)
        return data
    with open(filename, 'rb') as f:
        return _HybridUnpickler(f).load()


def load_hybrid(result_file: str):
    """Load a hybrid checkpoint -> (dqn_params, FeedForwardNetwork)."""
    data = load_hybrid_raw(result_file)
    net = FeedForwardNetwork.create(data['neat_genome'],
                                    data['neat_config'])
    return data['dqn_params'], net


# --- the frozen DQN and its head ---------------------------------------------

def _is_flax(params: Mapping) -> bool:
    p = params['params'] if 'params' in params else params
    return isinstance(p.get('fc3'), Mapping)


def as_dqn(dqn, env_cfg: EnvConfig, device: torch.device) -> DQN:
    """The frozen feature DQN on ``device`` from the port's ``DQN``, its
    state_dict, or flax DQN parameters."""
    if isinstance(dqn, DQN):
        return dqn.to(device)
    hw = (env_cfg.obs_height, env_cfg.obs_width)
    net = DQN(hw, FEATURE_CHANNEL * env_cfg.frame_stack,
              env_cfg.num_actions, assume_binary_obs=True, device=device)
    net.load_state_dict(dqn_from_flax(dqn, hw) if _is_flax(dqn) else dqn)
    return net


def _fc3(dqn):
    """(kernel (in, out), bias (out,)) float32 numpy of the DQN's fc3, as
    flax lays it out: the port's ``DQN``, its state_dict or flax
    parameters."""
    if isinstance(dqn, torch.nn.Module):
        dqn = dqn.state_dict()
    if _is_flax(dqn):
        p = dqn['params'] if 'params' in dqn else dqn
        return (np.asarray(p['fc3']['kernel'], np.float32),
                np.asarray(p['fc3']['bias'], np.float32))
    return (dqn['fc3.weight'].detach().cpu().numpy().T,
            dqn['fc3.bias'].detach().cpu().numpy())


def _head_genome(kernel: np.ndarray, bias: np.ndarray,
                 neat_cfg: NeatConfig) -> Genome:
    genome = Genome(0)
    genome.configure_new(neat_cfg, random.Random(0))
    for o, ok in enumerate(neat_cfg.output_keys):
        genome.nodes[ok].bias = float(bias[o])
        for i, ik in enumerate(neat_cfg.input_keys):
            genome.connections[(ik, ok)].weight = float(kernel[i, o])
    return genome


def fc3_to_genome(dqn, neat_cfg: NeatConfig) -> Genome:
    """Convert the DQN's fc3 layer into an equivalent NEAT genome
    (train_ga.py:199-215). ``dqn`` is the port's ``DQN`` or its state_dict
    (``fc3.weight`` is (out, in), so it is transposed), or flax
    parameters."""
    return _head_genome(*_fc3(dqn), neat_cfg)


def sweep_values(wd, bd, actd, evd, num_sweeps: int, inp: int, out: int,
                 emb: torch.Tensor) -> torch.Tensor:
    """K masked dense sweeps over padded node values (see
    :class:`PaddedNetBatch`), as batched ``torch.matmul``: emb (P, N, inp)
    -> output-node values (P, N, out). The sigmoid's and tanh's
    pre-activations are clipped to +-60 as ``neat.py``'s are."""
    m = wd.shape[-1]
    v = F.pad(emb.to(torch.float32), (0, m - inp))
    act = actd[:, None, :]
    ev = evd[:, None, :]
    wt = wd.transpose(1, 2)
    for _ in range(num_sweeps):
        pre = torch.matmul(v, wt) + bd[:, None, :]
        relu_v = pre.clamp_min(0.0)
        sig_v = torch.sigmoid((5.0 * pre).clamp(-60.0, 60.0))
        tanh_v = torch.tanh((2.5 * pre).clamp(-60.0, 60.0))
        new = torch.where(act == 1, sig_v,
                          torch.where(act == 2, tanh_v, relu_v))
        v = torch.where(ev, new, v)
    return v[..., inp:inp + out]


class PaddedNetBatch:
    """The whole population's genomes as ONE padded dense-sweep stack.

    Any feed-forward NEAT net is evaluated EXACTLY by K sweeps of a
    masked dense adjacency matmul over its full node-value vector
    (K = topo depth): after sweep k every node of depth <= k holds its
    final value, so reading the output slots after K_max sweeps
    reproduces ``FeedForwardNetwork.activate`` (topo order, missing
    sources read as 0 — neat.py:305-314) for every genome at once.

    Node slots per genome: [0, I) inputs, [I, I+O) outputs (value stays
    0 when an output is never evaluated, matching ``values.get(k, 0)``),
    then required hidden nodes. M is padded to a multiple of 16 and K to
    a multiple of 2, the JAX package's buckets.
    """

    ACT_IDS = {'relu': 0, 'sigmoid': 1, 'tanh': 2}

    def __init__(self, genomes, cfg: NeatConfig, device='cuda'):
        inp, out = cfg.num_inputs, cfg.num_outputs
        self.num_inputs, self.num_outputs = inp, out
        pop = len(genomes)

        rows = []
        for g in genomes:
            conns = [(i, o) for (i, o), c in g.connections.items()
                     if c.enabled]
            required = _required_nodes(cfg.input_keys, cfg.output_keys,
                                       conns, g.nodes)
            layers = _topo_layers(cfg.input_keys, conns, required)
            rows.append((g, conns, layers))

        max_hidden = max(
            (sum(1 for layer in layers for nk in layer
                 if nk not in cfg.output_keys)
             for _, _, layers in rows), default=0)
        m = inp + out + max_hidden
        self.m = m = -(-m // 16) * 16
        k = max((len(layers) for _, _, layers in rows), default=1)
        self.num_sweeps = -(-max(k, 1) // 2) * 2

        w = np.zeros((pop, m, m), np.float32)
        b = np.zeros((pop, m), np.float32)
        act = np.zeros((pop, m), np.int32)
        ev = np.zeros((pop, m), bool)
        in_pos = {nk: i for i, nk in enumerate(cfg.input_keys)}
        out_pos = {nk: inp + j for j, nk in enumerate(cfg.output_keys)}
        for p, (g, conns, layers) in enumerate(rows):
            slot = dict(in_pos)
            slot.update(out_pos)
            next_hidden = inp + out
            for layer in layers:
                for nk in layer:
                    if nk not in slot:
                        slot[nk] = next_hidden
                        next_hidden += 1
            for layer in layers:
                for nk in layer:
                    s = slot[nk]
                    ev[p, s] = True
                    b[p, s] = g.nodes[nk].bias
                    act[p, s] = self.ACT_IDS[g.nodes[nk].activation]
                    for (i, o) in conns:
                        if o != nk or i not in slot:
                            # sources without a slot are never evaluated
                            # -> contribute 0, like values.get(i, 0.0)
                            continue
                        w[p, s, slot[i]] += g.connections[(i, o)].weight

        dev = resolve_device(device)
        self.wd, self.bd, self.actd, self.evd = (
            torch.as_tensor(x, device=dev) for x in (w, b, act, ev))

    @property
    def tensors(self):
        return (self.wd, self.bd, self.actd, self.evd)

    def logits(self, emb: torch.Tensor) -> torch.Tensor:
        """Output-node values (pop, n, num_outputs) of embeddings
        (pop, n, num_inputs)."""
        return sweep_values(*self.tensors, self.num_sweeps, self.num_inputs,
                            self.num_outputs, emb)

    def acts(self, emb: torch.Tensor) -> torch.Tensor:
        """(pop, n, num_inputs) embeddings -> (pop, n) greedy actions,
        int32 (the first maximal output, as ``jnp.argmax``)."""
        return self.logits(emb).argmax(-1).to(torch.int32)


def neat_head(batch: PaddedNetBatch) -> '_Head':
    """The fitness head of a ``PaddedNetBatch``: its sweeps and argmax,
    keyed by its (m, num_sweeps) bucket, as the JAX trainer keys its
    ``_runners``."""
    k, inp, out = batch.num_sweeps, batch.num_inputs, batch.num_outputs

    def act(tensors, emb):
        return sweep_values(*tensors, k, inp, out, emb).argmax(-1).to(
            torch.int32)

    return _Head(('neat', batch.m, k), batch.tensors, act)


def _es_acts(tensors, emb):
    """The ES head: relu(emb W + b), argmax. Ties resolve to the first
    index, like np.argmax in the reference's consumers (train_ga.py:241)."""
    W, b = tensors
    return torch.relu(torch.bmm(emb, W) + b[:, None, :]).argmax(-1).to(
        torch.int32)


class _Head(NamedTuple):
    """A fitness episode's decision head: ``act(tensors, emb (P, N, I))
    -> actions (P, N) int32``. ``key`` names what ``act`` computes: the
    episode's graph is kept by (width P, key), and ``tensors`` are copied
    into its buffers each episode."""
    key: tuple
    tensors: tuple
    act: Callable


@dataclasses.dataclass
class _FitnessBuffers:
    """What a fitness episode's chunks carry, at fixed addresses."""
    envs: step_kernel.StaticEnvs
    done: torch.Tensor     # (P, N) bool
    ret: torch.Tensor      # (P, N) float32
    t: torch.Tensor        # (1,) int64: the next step's index
    fruit_u: torch.Tensor  # (episode_steps, P, N) float32
    head: tuple            # the head's tensors
    act: Callable          # the head's act
    flags: torch.Tensor    # (2,) int32: [live, steps run]


class _FitnessEpisodes:
    """What both trainers share: the frozen DQN, the env without
    auto-reset on the device, and the fitness episode.

    The episode is the JAX package's ``lax.while_loop`` (every env
    stepped every step, every snake's reward summed, dead or alive, until
    ``episode_steps`` steps or until every snake is done), run in chunks
    of ``chunk_steps`` steps: on CUDA one captured graph a (width, head)
    bucket, replayed, its population tensors copied into its buffers, the
    trainer's graphs in one memory pool; on the CPU the same body run
    directly. The host reads one flag a chunk and stops after the chunk
    in which the loop ended; the chunk's steps after that point hold every
    env still and add no reward. ``captured = False`` runs the chunks
    without the graphs. ``env_steps`` and ``env_steps_by_width`` count the
    steps run, the chunks' tails included: one kernel launch each on
    CUDA."""

    def __init__(self, dqn, env_cfg, neat_cfg, episode_steps, seed, device):
        self.device = resolve_device(device)
        self.env_cfg = env_cfg or _default_env_cfg()
        self.neat_cfg = neat_cfg or NeatConfig(
            num_inputs=128, num_outputs=self.env_cfg.num_actions)
        self.episode_steps = episode_steps
        self.seed = seed
        self.net = as_dqn(dqn, self.env_cfg, self.device)
        # the checkpoints' payload layout: flax's tree of numpy arrays
        self.dqn_params = dqn_to_flax(
            self.net.state_dict(),
            (self.env_cfg.obs_height, self.env_cfg.obs_width))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._reset_env, self._step_env = build_vector_fns(
            self.env_cfg, autoreset=False, device=self.device)
        self.chunk_steps = tail_chunk_steps(episode_steps)
        self.captured = True
        # (buffers, CapturedLoop) by (width, head key), in one pool
        self._loops = {}
        self._pool = GraphPool()
        self.env_steps = 0  # env steps run, one kernel launch each on CUDA
        self.env_steps_by_width = {}   # the same, by the episodes' env count
        # wall seconds and calls by phase: 'episodes', 'batch_build' (the
        # NEAT trainer's PaddedNetBatch), 'checkpoint', and the ES
        # trainer's 'fitness' and 'validation'; each phase ends in a
        # read-back or on the host, so its device work is in its time
        self.seconds, self.calls = {}, {}

    @contextlib.contextmanager
    def _timed(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[phase] = (self.seconds.get(phase, 0.0)
                                   + time.perf_counter() - t0)
            self.calls[phase] = self.calls.get(phase, 0) + 1

    def _draws(self, num_envs: int) -> EpisodeDraws:
        return episode_draws(self.env_cfg, num_envs, self.episode_steps,
                             self.generator, self.device)

    def captured_loops(self) -> dict:
        """The ``CapturedLoop`` of each (width, head key) bucket so far."""
        return {key: loop for key, (_, loop) in self._loops.items()}

    def _loop(self, p: int, head: _Head):
        key = (p,) + head.key
        if key not in self._loops:
            dev, n = self.device, self.env_cfg.num_snakes

            def zeros(shape, dtype=torch.float32):
                return torch.zeros(shape, dtype=dtype, device=dev)

            b = _FitnessBuffers(
                envs=step_kernel.StaticEnvs(self.env_cfg, p, dev),
                done=zeros((p, n), torch.bool), ret=zeros((p, n)),
                t=zeros((1,), torch.int64),
                fruit_u=zeros((max(self.episode_steps, 1), p, n)),
                head=tuple(zeros(x.shape, x.dtype) for x in head.tensors),
                act=head.act, flags=zeros((2,), torch.int32))
            self._loops[key] = (b, CapturedLoop(lambda: self._chunk(b), dev,
                                                self._pool))
        return self._loops[key]

    def _chunk(self, b: _FitnessBuffers) -> None:
        """``chunk_steps`` steps of the episode over the buffers ``b``,
        branch-free, with no read-back: the body of JAX's while_loop, its
        condition a device predicate."""
        steps = self.episode_steps
        p, n = b.done.shape
        state, out = b.envs.state, b.envs.out
        done, ret, t = b.done, b.ret, b.t
        for _ in range(self.chunk_steps):
            go = (t < steps) & ~done.all()          # (1,): JAX's cond
            obs = out.obs
            emb = self.net.features(obs.reshape((p * n,) + obs.shape[2:]))
            actions = torch.where(done, 0, b.act(b.head, emb.view(p, n, -1)))
            fruit = b.fruit_u.index_select(0, t.clamp(max=steps - 1))[0]
            # once the loop has ended every env is held still
            state, out = self._step_env(
                state, actions, StepDraws(fruit, None, None),
                hold=((~go).expand(p).contiguous(), out))
            done = done | out.done
            ret = ret + torch.where(go, out.reward, 0.0)
            t = t + 1
        b.envs.store(state, out)
        for dst, src in ((b.done, done), (b.ret, ret), (b.t, t)):
            dst.copy_(src)
        live = (t < steps) & ~done.all()
        b.flags.copy_(torch.cat([live.to(torch.int64), t]))

    @torch.no_grad()
    def _episode(self, head: _Head, draws: EpisodeDraws) -> np.ndarray:
        """One episode of every member under ``head``; ``draws`` has one
        env a member. Returns each (member, snake)'s summed reward, (P, N)
        float32."""
        with self._timed('episodes'):
            p = draws.fruit_u.shape[1]
            b, loop = self._loop(p, head)
            states, obs = self._reset_env(draws.reset)
            b.envs.load(states)
            b.envs.out.obs.copy_(obs)
            for x in (b.done, b.ret, b.t, b.flags):
                x.zero_()
            b.fruit_u[:self.episode_steps].copy_(
                draws.fruit_u[:self.episode_steps])
            copy_into(b.head, head.tensors)
            b.act = head.act
            _, run = run_chunks(loop, b.flags, self.episode_steps,
                                self.chunk_steps, self.captured,
                                name='fitness')
            self.env_steps += run
            self.env_steps_by_width[p] = (
                self.env_steps_by_width.get(p, 0) + run)
            # a copy: on the CPU .cpu() would hand out the buffer itself
            return b.ret.to('cpu', copy=True).numpy()

    def _save(self, genome: Genome, filename: str):
        with self._timed('checkpoint'):
            save_checkpoint_safe({'dqn_params': self.dqn_params,
                                  'neat_genome': genome,
                                  'neat_config': self.neat_cfg}, filename)


class HybridNEATTrainer(_FitnessEpisodes):
    """NEAT over the frozen DQN's embedding. ``dqn`` is the port's
    ``DQN``, its state_dict or flax DQN parameters; ``fitness_episodes``
    K > 1 scores each genome by its mean over K episodes with common
    random numbers."""

    def __init__(self, dqn, env_cfg: Optional[EnvConfig] = None,
                 neat_cfg: Optional[NeatConfig] = None,
                 episode_steps: int = 512,
                 result_file: str = 'hybrid_neat_best.pkl',
                 seed: int = 0, fitness_episodes: int = 1, device='cuda'):
        super().__init__(dqn, env_cfg, neat_cfg, episode_steps, seed,
                         device)
        self.result_file = result_file
        self.fitness_episodes = fitness_episodes
        self.best_fitness = -1e9

    def eval_genomes(self, genomes, cfg: NeatConfig,
                     draws: Optional[Sequence[EpisodeDraws]] = None):
        """Batched fitness: one env per genome, all stepped together,
        every genome's net in one :class:`PaddedNetBatch`. ``draws``: the
        K episodes' draws, one env each (drawn from the trainer's
        generator when None). Each new best genome is saved."""
        pop = len(genomes)
        with self._timed('batch_build'):
            batch = PaddedNetBatch([g for _, g in genomes], cfg,
                                   self.device)
        if draws is None:
            draws = [self._draws(1) for _ in range(self.fitness_episodes)]
        rows = torch.zeros(pop, dtype=torch.long)
        head = neat_head(batch)
        ep_rets = [self._episode(head, d.take(rows)) for d in draws]
        returns = np.stack(ep_rets).mean(0)  # (pop, n)

        for (gid, genome), ret in zip(genomes, returns):
            genome.fitness = float(ret.mean())
            if genome.fitness > self.best_fitness:
                self.best_fitness = genome.fitness
                self._save(genome, self.result_file)

    def run(self, num_generations: int = 50, verbose: bool = True,
            draws: Optional[Sequence[Sequence[EpisodeDraws]]] = None):
        """Evolve; ``draws[g]`` are generation g's episode draws."""
        pop = Population(self.neat_cfg, seed=self.seed)
        init = fc3_to_genome(self.net, self.neat_cfg)
        pop.inject(init)
        self.best_fitness = -1e9
        # initial winner saved immediately (train_ga.py:290-305)
        self._save(init, self.result_file)
        per_gen = iter(draws) if draws is not None else None

        def eval_fn(genomes, cfg):
            self.eval_genomes(genomes, cfg,
                              None if per_gen is None else next(per_gen))

        return pop.run(eval_fn, num_generations, verbose=verbose)


class HeadESTrainer(_FitnessEpisodes):
    """Antithetic weight-perturbation ES on the hybrid decision head.

    The JAX package's ``HeadESTrainer``: the frozen DQN's 128-d embedding
    -> a relu 3-way head -> argmax (the fc3-seeded NEAT genome's
    ``FeedForwardNetwork``), with OpenAI-style ES as the variation
    [Salimans et al. 2017]:

      * population = theta +/- sigma * eps_i (antithetic pairs) and theta
        itself, all in one batch per episode, on common random numbers;
      * update = rank-shaped gradient ascent on theta, the ranks taken by
        ``np.argsort`` on the host, as the JAX trainer takes them;
      * the champion is chosen on a FIXED validation set of episodes (the
        same draws every generation, from a generator of its own), so
        comparisons across generations are paired.

    The result saves as a standard fc3-topology hybrid genome.
    ``holdout_compare`` measures two heads on fresh paired episodes.
    """

    def __init__(self, dqn, env_cfg: Optional[EnvConfig] = None,
                 neat_cfg: Optional[NeatConfig] = None,
                 episode_steps: int = 512, pop_size: int = 128,
                 sigma: float = 0.02, lr: float = 0.01,
                 fitness_episodes: int = 4, seed: int = 0,
                 result_file: str = 'hybrid_es_best.msgpack',
                 device='cuda'):
        if pop_size % 2:
            raise ValueError('antithetic pairs need an even pop')
        super().__init__(dqn, env_cfg, neat_cfg, episode_steps, seed,
                         device)
        self.pop_size = pop_size
        self.sigma = sigma
        self.lr = lr
        self.fitness_episodes = fitness_episodes
        self.result_file = result_file
        kernel, bias = _fc3(self.net)
        self.kernel = torch.as_tensor(kernel, device=self.device)  # (128, 3)
        self.bias = torch.as_tensor(bias, device=self.device)      # (3,)
        self._seed_theta = (self.kernel, self.bias)
        self._val_sets = {}

    def _run(self, W: torch.Tensor, b: torch.Tensor,
             draws: EpisodeDraws) -> np.ndarray:
        """One episode of the member batch W (P, 128, 3), b (P, 3), one env
        a member in ``draws``; per-member per-snake returns (P, N)."""
        return self._episode(_Head(('es',), (W, b), _es_acts), draws)

    def _fitness(self, W, b, draws: Sequence[EpisodeDraws]) -> np.ndarray:
        """Mean per-member fitness over the K episodes ``draws`` (one env
        each), every member on the same draws."""
        with self._timed('fitness'):
            rows = torch.zeros(W.shape[0], dtype=torch.long)
            ep = [self._run(W, b, d.take(rows)) for d in draws]
            return np.stack(ep).mean(0).mean(-1)  # (P,)

    def validation_draws(self, episodes: int) -> EpisodeDraws:
        """The FIXED validation set: ``episodes`` envs from a generator of
        its own, drawn once and the same every generation."""
        if episodes not in self._val_sets:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(derive_seed(self.seed, 777_000))
            self._val_sets[episodes] = episode_draws(
                self.env_cfg, episodes, self.episode_steps, gen, self.device)
        return self._val_sets[episodes]

    def validate(self, theta, episodes: int = 8,
                 draws: Optional[EpisodeDraws] = None) -> float:
        """Mean return of ``theta`` over the validation episodes (``draws``
        of ``episodes`` envs, the fixed set when None), theta tiled
        across the member slots."""
        with self._timed('validation'):
            if draws is None:
                draws = self.validation_draws(episodes)
            W = theta[0][None].expand((episodes,) + theta[0].shape)
            b = theta[1][None].expand((episodes,) + theta[1].shape)
            ret = self._run(W, b, draws.take(torch.arange(episodes)))
            return float(ret.mean())

    def _member_batch(self, theta, eps_k, eps_b):
        """[theta, theta+sigma*eps_i, theta-sigma*eps_i] stacked."""
        k, b = theta
        Wp = torch.cat([k[None], k[None] + self.sigma * eps_k,
                        k[None] - self.sigma * eps_k], 0)
        bp = torch.cat([b[None], b[None] + self.sigma * eps_b,
                        b[None] - self.sigma * eps_b], 0)
        return Wp, bp

    def run(self, num_generations: int = 50, verbose: bool = True,
            on_generation=None, val_episodes: int = 8,
            draws: Optional[Sequence[ESDraws]] = None,
            val_draws: Optional[EpisodeDraws] = None):
        """Evolve; ``draws[g]`` is generation g's ``ESDraws``,
        ``val_draws`` the validation set (``val_episodes`` envs)."""
        half = self.pop_size // 2
        theta = self._seed_theta
        # champion selection rides the FIXED validation draws: the seed's
        # score there is the bar every theta must clear
        seed_val = self.validate(theta, val_episodes, val_draws)
        best_theta, best_val = theta, seed_val
        # initial winner saved immediately (the NEAT path's contract,
        # train_ga.py:290-305) so the result file always exists
        self._save_theta(theta, seed_val)
        history = []
        for gen in range(num_generations):
            d = draws[gen] if draws is not None else es_draws(
                self.env_cfg, half, self.kernel.shape[0],
                self.fitness_episodes, self.episode_steps, self.generator,
                self.device)
            W, b = self._member_batch(theta, d.eps_k, d.eps_b)
            fit = self._fitness(W, b, d.episodes)  # (1 + 2*half,)
            f_theta, f_pos, f_neg = fit[0], fit[1:1 + half], fit[1 + half:]
            # rank-shaped utilities over the 2*half perturbed members
            # (centered ranks in [-0.5, 0.5] — scale-free, outlier-robust)
            pert = np.concatenate([f_pos, f_neg])
            ranks = np.empty(pert.size)
            ranks[np.argsort(pert)] = np.arange(pert.size)
            u = ranks / (pert.size - 1) - 0.5
            u_pos, u_neg = u[:half], u[half:]
            coef = torch.as_tensor(
                ((u_pos - u_neg) / (half * self.sigma)).astype(np.float32),
                device=self.device)
            gk = torch.einsum('p,pij->ij', coef, d.eps_k)
            gb = torch.einsum('p,pj->j', coef, d.eps_b)
            theta = (theta[0] + self.lr * gk, theta[1] + self.lr * gb)
            val = self.validate(theta, val_episodes, val_draws)
            if val > best_val:
                best_val, best_theta = val, theta
                self._save_theta(best_theta, best_val)
            rec = {'gen': gen, 'theta_fitness': float(f_theta),
                   'pert_best': float(pert.max()),
                   'pert_mean': float(pert.mean()),
                   'val': val, 'best_val': best_val,
                   'seed_val': seed_val,
                   'theta_l2_from_seed': float(torch.sqrt(
                       ((theta[0] - self._seed_theta[0]) ** 2).sum()
                       + ((theta[1] - self._seed_theta[1]) ** 2).sum()))}
            history.append(rec)
            if verbose:
                print(f"gen {gen:3d} | train {rec['theta_fitness']:8.2f}"
                      f" | val {val:8.2f}"
                      f" | best val {best_val:8.2f}"
                      f" (seed {seed_val:.2f})"
                      f" | |d|={rec['theta_l2_from_seed']:.3f}")
            if on_generation:
                on_generation(rec)
        return best_theta, best_val, history

    def theta_to_genome(self, theta) -> Genome:
        """Pack (kernel, bias) into the fc3-topology hybrid genome."""
        return _head_genome(theta[0].cpu().numpy(), theta[1].cpu().numpy(),
                            self.neat_cfg)

    def _save_theta(self, theta, score):
        genome = self.theta_to_genome(theta)
        genome.fitness = score
        self._save(genome, self.result_file)

    def holdout_draws(self, episodes: int = 32,
                      seed: int = 10_000) -> EpisodeDraws:
        """Fresh episodes never used in training: ``episodes`` envs from a
        generator seeded from ``self.seed + seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive_seed(self.seed + seed))
        return episode_draws(self.env_cfg, episodes, self.episode_steps,
                             gen, self.device)

    def holdout_compare(self, theta_a, theta_b, episodes: int = 32,
                        seed: int = 10_000, block: int = 64,
                        draws: Optional[EpisodeDraws] = None):
        """Paired held-out evaluation: both heads play the same fresh
        episodes (``draws`` of ``episodes`` envs, or ``holdout_draws``),
        ``block`` episodes of each head in one batch. Returns (mean_a,
        mean_b, mean paired diff, std of paired diff)."""
        ra, rb = self.holdout_returns(theta_a, theta_b, episodes, seed,
                                      block, draws)
        d = rb - ra
        return (float(np.mean(ra)), float(np.mean(rb)),
                float(d.mean()), float(d.std(ddof=1)))

    def holdout_returns(self, theta_a, theta_b, episodes: int = 32,
                        seed: int = 10_000, block: int = 64,
                        draws: Optional[EpisodeDraws] = None):
        """``holdout_compare``'s episodes: each head's mean return over the
        snakes of every held-out episode, (episodes,) float32 numpy each."""
        if draws is None:
            draws = self.holdout_draws(episodes, seed)
        ra, rb = [], []
        done = 0
        while done < episodes:
            v = min(block, episodes - done)
            rows = torch.arange(done, done + v)
            W = torch.cat([theta_a[0][None].expand((v,) + theta_a[0].shape),
                           theta_b[0][None].expand((v,) + theta_b[0].shape)])
            b = torch.cat([theta_a[1][None].expand((v,) + theta_a[1].shape),
                           theta_b[1][None].expand((v,) + theta_b[1].shape)])
            ret = self._run(W, b, draws.take(torch.cat([rows, rows])))
            ret = ret.mean(-1)
            ra.extend(ret[:v])
            rb.extend(ret[v:])
            done += v
        return np.asarray(ra), np.asarray(rb)


def render_winner(winner_pickle: str, env_cfg: Optional[EnvConfig] = None,
                  episodes: int = 1, render: bool = True,
                  max_steps: int = 256, video_path: str = 'neat.mp4',
                  seed: int = 0, device='cuda'):
    """Load a hybrid checkpoint, play and (optionally) render episodes,
    print the evaluation summary — counterpart of the reference's
    ``render_winner`` (train_ga.py:309-503). The envs step through a
    ``GymAdapter`` (one kernel launch a step on CUDA); the DQN's features
    run on ``device``, the evolved head on the host."""
    from marlsnake_torch.envs.env import SnakeEnv
    from marlsnake_torch.envs.wrappers import GymAdapter, RenderGUI

    dqn_params, neat_net = load_hybrid(winner_pickle)
    env_cfg = env_cfg or _default_env_cfg()
    dev = resolve_device(device)
    n = env_cfg.num_snakes
    env = GymAdapter(SnakeEnv(env_cfg, device=dev), seed=seed)
    if render:
        env = RenderGUI(env, save_video=True, video_path=video_path,
                        fps=10)
    net = as_dqn(dqn_params, env_cfg, dev)

    ep_rewards, ep_timelifes = [], []
    for ep in range(episodes):
        obs = env.reset()
        dones = [False] * n
        rews = np.zeros(n)
        timelifes = np.zeros(n)
        step = 0
        while not all(dones) and step < max_steps:
            step += 1
            with torch.no_grad():
                emb = net.features(torch.as_tensor(obs, device=dev))
            emb = emb.cpu().numpy()
            actions = []
            for i in range(n):
                if dones[i]:
                    actions.append(0)
                    continue
                timelifes[i] += 1
                actions.append(int(np.argmax(neat_net.activate(emb[i]))))
            if render:
                env.render()
            obs, r, dones, _ = env.step(actions)
            for i in range(n):
                rews[i] += r[i]
        ep_rewards.append(rews.mean())
        ep_timelifes.append(timelifes.mean())
        print(f'[Eval] Ep {ep + 1}/{episodes} | '
              f'Mean Reward: {ep_rewards[-1]:.2f} | '
              f'Mean Timelife: {ep_timelifes[-1]:.1f} steps')
    if episodes:
        print('=' * 50)
        print(f'FINAL EVALUATION OVER {episodes} EPISODES:')
        print(f'Overall Mean Reward: {np.mean(ep_rewards):.3f}')
        print(f'Overall Mean Timelife: {np.mean(ep_timelifes):.2f} steps')
        print('=' * 50)
    env.close()
    return float(np.mean(ep_rewards)), float(np.mean(ep_timelifes))
