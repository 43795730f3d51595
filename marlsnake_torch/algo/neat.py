"""Minimal NEAT (NeuroEvolution of Augmenting Topologies) implementation.

The port's own copy of the JAX package's ``algo/neat.py`` (pure Python,
``random.Random``), kept line for line so that the same ``eval_fn`` evolves
the same genomes in both packages. The reference drives its hybrid
evolution through the ``neat-python`` package (train_ga.py:219-307) with
the config written by ``create_neat_config`` (train_ga.py:115-195); this
is a compact self-contained NEAT engine with the same moving parts:
genomes (node + connection genes), speciation by compatibility distance,
stagnation, elitism, crossover, weight/structural mutation, and
feed-forward network instantiation. Defaults mirror the reference's ini
values.

Only what the hybrid flow needs is implemented — feed-forward nets, max
fitness criterion — not the full neat-python surface.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple


def relu(x: float) -> float:
    return x if x > 0.0 else 0.0


def sigmoid(x: float) -> float:
    x = max(-60.0, min(60.0, 5.0 * x))
    return 1.0 / (1.0 + math.exp(-x))


def tanh_act(x: float) -> float:
    return math.tanh(max(-60.0, min(60.0, 2.5 * x)))


ACTIVATIONS = {'relu': relu, 'sigmoid': sigmoid, 'tanh': tanh_act}


@dataclasses.dataclass
class NeatConfig:
    """Defaults mirror config-neat-hybrid.ini (train_ga.py:117-195)."""
    num_inputs: int = 128
    num_outputs: int = 3
    pop_size: int = 100
    # fitness
    fitness_threshold: float = 1e9
    # genome / mutation
    activation_default: str = 'relu'
    activation_options: Tuple[str, ...] = ('relu', 'sigmoid', 'tanh')
    activation_mutate_rate: float = 0.1
    bias_init_stdev: float = 1.0
    bias_max_value: float = 3.0
    bias_min_value: float = -3.0
    bias_mutate_power: float = 0.5
    bias_mutate_rate: float = 0.7
    bias_replace_rate: float = 0.1
    weight_init_stdev: float = 1.0
    weight_max_value: float = 3.0
    weight_min_value: float = -3.0
    weight_mutate_power: float = 0.5
    weight_mutate_rate: float = 0.8
    weight_replace_rate: float = 0.1
    conn_add_prob: float = 0.5
    conn_delete_prob: float = 0.2
    node_add_prob: float = 0.2
    node_delete_prob: float = 0.2
    enabled_mutate_rate: float = 0.01
    # speciation
    compatibility_threshold: float = 2.0
    compatibility_disjoint_coefficient: float = 1.0
    compatibility_weight_coefficient: float = 0.5
    # stagnation / reproduction
    max_stagnation: int = 15
    species_elitism: int = 1
    elitism: int = 1
    survival_threshold: float = 0.2
    min_species_size: int = 3

    @property
    def input_keys(self) -> List[int]:
        return [-i - 1 for i in range(self.num_inputs)]

    @property
    def output_keys(self) -> List[int]:
        return list(range(self.num_outputs))


@dataclasses.dataclass
class NodeGene:
    bias: float
    activation: str = 'relu'
    response: float = 1.0

    def copy(self):
        return NodeGene(self.bias, self.activation, self.response)

    def distance(self, other, cfg: NeatConfig) -> float:
        d = abs(self.bias - other.bias)
        if self.activation != other.activation:
            d += 1.0
        return d * cfg.compatibility_weight_coefficient


@dataclasses.dataclass
class ConnGene:
    weight: float
    enabled: bool = True

    def copy(self):
        return ConnGene(self.weight, self.enabled)

    def distance(self, other, cfg: NeatConfig) -> float:
        d = abs(self.weight - other.weight)
        if self.enabled != other.enabled:
            d += 1.0
        return d * cfg.compatibility_weight_coefficient


class Genome:
    def __init__(self, key: int):
        self.key = key
        self.nodes: Dict[int, NodeGene] = {}
        self.connections: Dict[Tuple[int, int], ConnGene] = {}
        self.fitness: Optional[float] = None

    # --- initialization (full_direct, like the reference ini) ----------
    def configure_new(self, cfg: NeatConfig, rng: random.Random):
        for ok in cfg.output_keys:
            self.nodes[ok] = NodeGene(
                rng.gauss(0.0, cfg.bias_init_stdev),
                cfg.activation_default)
        for ik in cfg.input_keys:
            for ok in cfg.output_keys:
                self.connections[(ik, ok)] = ConnGene(
                    rng.gauss(0.0, cfg.weight_init_stdev))

    def copy(self, new_key: int) -> 'Genome':
        g = Genome(new_key)
        g.nodes = {k: v.copy() for k, v in self.nodes.items()}
        g.connections = {k: v.copy() for k, v in self.connections.items()}
        return g

    # --- crossover ------------------------------------------------------
    @staticmethod
    def crossover(key: int, parent1: 'Genome', parent2: 'Genome',
                  rng: random.Random) -> 'Genome':
        """parent1 must be the fitter parent."""
        child = Genome(key)
        for nk, n1 in parent1.nodes.items():
            n2 = parent2.nodes.get(nk)
            child.nodes[nk] = (n1 if n2 is None or rng.random() < 0.5
                               else n2).copy()
        for ck, c1 in parent1.connections.items():
            c2 = parent2.connections.get(ck)
            child.connections[ck] = (c1 if c2 is None or rng.random() < 0.5
                                     else c2).copy()
        return child

    # --- mutation -------------------------------------------------------
    def mutate(self, cfg: NeatConfig, rng: random.Random,
               next_node_key: List[int]):
        if rng.random() < cfg.node_add_prob:
            self._mutate_add_node(cfg, rng, next_node_key)
        if rng.random() < cfg.node_delete_prob:
            self._mutate_delete_node(cfg, rng)
        if rng.random() < cfg.conn_add_prob:
            self._mutate_add_conn(cfg, rng)
        if rng.random() < cfg.conn_delete_prob:
            self._mutate_delete_conn(rng)
        for node in self.nodes.values():
            if rng.random() < cfg.bias_mutate_rate:
                if rng.random() < cfg.bias_replace_rate:
                    node.bias = rng.gauss(0.0, cfg.bias_init_stdev)
                else:
                    node.bias += rng.gauss(0.0, cfg.bias_mutate_power)
                node.bias = max(cfg.bias_min_value,
                                min(cfg.bias_max_value, node.bias))
            if rng.random() < cfg.activation_mutate_rate:
                node.activation = rng.choice(cfg.activation_options)
        for conn in self.connections.values():
            if rng.random() < cfg.weight_mutate_rate:
                if rng.random() < cfg.weight_replace_rate:
                    conn.weight = rng.gauss(0.0, cfg.weight_init_stdev)
                else:
                    conn.weight += rng.gauss(0.0, cfg.weight_mutate_power)
                conn.weight = max(cfg.weight_min_value,
                                  min(cfg.weight_max_value, conn.weight))
            if rng.random() < cfg.enabled_mutate_rate:
                conn.enabled = not conn.enabled

    def _mutate_add_node(self, cfg, rng, next_node_key):
        enabled = [(k, c) for k, c in self.connections.items() if c.enabled]
        if not enabled:
            return
        (i, o), conn = rng.choice(enabled)
        conn.enabled = False
        nk = next_node_key[0]
        next_node_key[0] += 1
        self.nodes[nk] = NodeGene(0.0, cfg.activation_default)
        self.connections[(i, nk)] = ConnGene(1.0)
        self.connections[(nk, o)] = ConnGene(conn.weight)

    def _mutate_delete_node(self, cfg, rng):
        hidden = [k for k in self.nodes if k not in cfg.output_keys]
        if not hidden:
            return
        k = rng.choice(hidden)
        del self.nodes[k]
        self.connections = {ck: c for ck, c in self.connections.items()
                            if k not in ck}

    def _mutate_add_conn(self, cfg, rng):
        ins = cfg.input_keys + list(self.nodes.keys())
        outs = list(self.nodes.keys())
        i = rng.choice(ins)
        o = rng.choice(outs)
        if (i, o) in self.connections or i == o:
            return
        if self._creates_cycle(i, o):
            return
        self.connections[(i, o)] = ConnGene(
            rng.gauss(0.0, cfg.weight_init_stdev))

    def _creates_cycle(self, i, o) -> bool:
        # feed-forward constraint: adding i->o must not close a cycle
        if i == o:
            return True
        seen = {o}
        stack = [o]
        while stack:
            node = stack.pop()
            for (a, b) in self.connections:
                if a == node and b not in seen:
                    if b == i:
                        return True
                    seen.add(b)
                    stack.append(b)
        return False

    def _mutate_delete_conn(self, rng):
        if self.connections:
            del self.connections[rng.choice(list(self.connections))]

    # --- compatibility distance ----------------------------------------
    def distance(self, other: 'Genome', cfg: NeatConfig) -> float:
        node_d = 0.0
        disjoint_nodes = 0
        for k in set(self.nodes) | set(other.nodes):
            a, b = self.nodes.get(k), other.nodes.get(k)
            if a is None or b is None:
                disjoint_nodes += 1
            else:
                node_d += a.distance(b, cfg)
        max_nodes = max(len(self.nodes), len(other.nodes), 1)
        node_dist = (node_d + cfg.compatibility_disjoint_coefficient
                     * disjoint_nodes) / max_nodes

        conn_d = 0.0
        disjoint_conns = 0
        for k in set(self.connections) | set(other.connections):
            a = self.connections.get(k)
            b = other.connections.get(k)
            if a is None or b is None:
                disjoint_conns += 1
            else:
                conn_d += a.distance(b, cfg)
        max_conns = max(len(self.connections), len(other.connections), 1)
        conn_dist = (conn_d + cfg.compatibility_disjoint_coefficient
                     * disjoint_conns) / max_conns
        return node_dist + conn_dist

    def size(self):
        enabled = sum(1 for c in self.connections.values() if c.enabled)
        return len(self.nodes), enabled


class FeedForwardNetwork:
    """Evaluated network: topologically-ordered node evaluations."""

    def __init__(self, input_keys, output_keys, node_evals):
        self.input_keys = input_keys
        self.output_keys = output_keys
        self.node_evals = node_evals
        self.values = {}

    @staticmethod
    def create(genome: Genome, cfg: NeatConfig) -> 'FeedForwardNetwork':
        conns = [(i, o) for (i, o), c in genome.connections.items()
                 if c.enabled]
        required = _required_nodes(cfg.input_keys, cfg.output_keys, conns,
                                   genome.nodes)
        layers = _topo_layers(cfg.input_keys, conns, required)
        node_evals = []
        for layer in layers:
            for node in layer:
                inputs = [(i, genome.connections[(i, node)].weight)
                          for (i, o) in conns if o == node]
                ng = genome.nodes[node]
                node_evals.append(
                    (node, ACTIVATIONS[ng.activation], ng.bias, inputs))
        return FeedForwardNetwork(cfg.input_keys, cfg.output_keys,
                                  node_evals)

    def activate(self, inputs) -> List[float]:
        values = {k: 0.0 for k in self.output_keys}
        for k, v in zip(self.input_keys, inputs):
            values[k] = float(v)
        for node, act, bias, links in self.node_evals:
            s = bias
            for i, w in links:
                s += values.get(i, 0.0) * w
            values[node] = act(s)
        return [values.get(k, 0.0) for k in self.output_keys]


def _required_nodes(input_keys, output_keys, conns, nodes):
    """Nodes on some path to an output."""
    required = set(output_keys)
    changed = True
    while changed:
        changed = False
        for (i, o) in conns:
            if o in required and i in nodes and i not in required:
                required.add(i)
                changed = True
    return required


def _topo_layers(input_keys, conns, required):
    # every dependency of a required node is an input or itself required,
    # so readiness reduces to "all incoming sources already placed"
    placed = set(input_keys)
    layers = []
    remaining = set(required)
    while remaining:
        layer = {n for n in remaining
                 if all(i in placed or i not in remaining
                        for (i, o) in conns if o == n)}
        if not layer:
            # unreachable with the feed-forward constraint; terminate anyway
            layer = set(remaining)
        layers.append(sorted(layer))
        placed |= layer
        remaining -= layer
    return layers


@dataclasses.dataclass
class Species:
    key: int
    representative: Genome
    members: List[Genome]
    best_fitness: float = -math.inf
    last_improved: int = 0


class Population:
    """NEAT evolution loop: speciate -> evaluate -> reproduce."""

    def __init__(self, cfg: NeatConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = random.Random(seed)
        self.genomes: List[Genome] = []
        self._next_genome_key = 0
        self._next_node_key = [cfg.num_outputs]
        self._next_species_key = 0
        self.species: List[Species] = []
        self.generation = 0
        self.best: Optional[Genome] = None
        for _ in range(cfg.pop_size):
            g = Genome(self._new_key())
            g.configure_new(cfg, self.rng)
            self.genomes.append(g)

    def _new_key(self) -> int:
        self._next_genome_key += 1
        return self._next_genome_key

    def inject(self, genome: Genome):
        """Replace one random genome with a seeded genome (used for the
        DQN-fc3 initial winner, train_ga.py:290-305)."""
        idx = self.rng.randrange(len(self.genomes))
        genome = genome.copy(self._new_key())
        self.genomes[idx] = genome

    # ------------------------------------------------------------------
    def _speciate(self):
        cfg = self.cfg
        for sp in self.species:
            sp.members = []
        unplaced = []
        for g in self.genomes:
            placed = False
            for sp in self.species:
                if g.distance(sp.representative, cfg) \
                        < cfg.compatibility_threshold:
                    sp.members.append(g)
                    placed = True
                    break
            if not placed:
                unplaced.append(g)
        for g in unplaced:
            self._next_species_key += 1
            self.species.append(Species(self._next_species_key, g, [g],
                                        last_improved=self.generation))
        self.species = [sp for sp in self.species if sp.members]
        for sp in self.species:
            sp.representative = self.rng.choice(sp.members)

    def _reproduce(self):
        cfg = self.cfg
        # stagnation
        alive = []
        for sp in sorted(self.species, key=lambda s: -s.best_fitness):
            best = max(g.fitness for g in sp.members)
            if best > sp.best_fitness:
                sp.best_fitness = best
                sp.last_improved = self.generation
            stagnant = (self.generation - sp.last_improved
                        > cfg.max_stagnation)
            if not stagnant or len(alive) < cfg.species_elitism:
                alive.append(sp)
        if not alive:
            alive = self.species[:1]

        # fitness sharing -> offspring counts
        min_fit = min(g.fitness for sp in alive for g in sp.members)
        adj = []
        for sp in alive:
            mean_fit = sum(g.fitness for g in sp.members) / len(sp.members)
            adj.append(mean_fit - min_fit + 1e-8)
        total_adj = sum(adj)
        counts = [max(cfg.min_species_size,
                      int(round(a / total_adj * cfg.pop_size)))
                  for a in adj]
        # normalize to pop_size
        while sum(counts) > cfg.pop_size:
            counts[counts.index(max(counts))] -= 1
        while sum(counts) < cfg.pop_size:
            counts[counts.index(min(counts))] += 1

        new_genomes = []
        for sp, n_off in zip(alive, counts):
            members = sorted(sp.members, key=lambda g: -g.fitness)
            for e in members[:cfg.elitism][:n_off]:
                new_genomes.append(e)
            n_off -= min(cfg.elitism, n_off)
            cutoff = max(2, int(math.ceil(cfg.survival_threshold
                                          * len(members))))
            parents = members[:cutoff]
            for _ in range(n_off):
                p1, p2 = (self.rng.choice(parents),
                          self.rng.choice(parents))
                if p2.fitness > p1.fitness:
                    p1, p2 = p2, p1
                child = Genome.crossover(self._new_key(), p1, p2, self.rng)
                child.mutate(cfg, self.rng, self._next_node_key)
                new_genomes.append(child)
        self.genomes = new_genomes[:cfg.pop_size]

    # ------------------------------------------------------------------
    def run(self, eval_fn, num_generations: int,
            verbose: bool = True) -> Genome:
        """eval_fn(list[(key, Genome)], cfg) must set genome.fitness."""
        for _ in range(num_generations):
            eval_fn([(g.key, g) for g in self.genomes], self.cfg)
            gen_best = max(self.genomes, key=lambda g: g.fitness)
            if self.best is None or gen_best.fitness > self.best.fitness:
                self.best = gen_best
            if verbose:
                mean = (sum(g.fitness for g in self.genomes)
                        / len(self.genomes))
                print(f'gen {self.generation:3d} | best '
                      f'{gen_best.fitness:9.4f} | mean {mean:9.4f} | '
                      f'species {len(self.species) or 1}')
            if gen_best.fitness >= self.cfg.fitness_threshold:
                break
            self._speciate()
            self._reproduce()
            self.generation += 1
        return self.best
