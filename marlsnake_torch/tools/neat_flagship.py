"""Reference-scale hybrid-NEAT flagship run: the JAX repository's
``tools/neat_flagship.py`` on the port.

The reference's configuration (train_ga.py: pop 100, 50 generations, the
20x20 4-snake length-5 env with the GA reward) over the frozen trained
DQN, each genome scored by its mean over K=4 fitness episodes of 512
steps on common random numbers, the population stepped as one batch
(``PaddedNetBatch``). The DQN is the ``dqn_params`` of
``artifacts/hybrid_neat_20x20.pkl``, bit-equal to the JAX run's orbax
``artifacts/dqn20_ckpt`` ``showcase20``.

Each generation writes one row with the JAX rows' keys (``gen``,
``best``, ``mean``, ``wall_sec``: the fitness evaluation's seconds,
``max_hidden_nodes``, ``mean_hidden_nodes``) to
``OUT/neat_flagship_curve.jsonl`` (default ``artifacts/torch``); the
winner goes to ``OUT/ckpt/hybrid_neat_20x20_full.pkl``. The last line
printed is one JSON object: the card, the total seconds, each
generation's seconds split into its fitness episodes and the host work
(``PaddedNetBatch`` builds and checkpoint writes, as the trainer times
them, and speciation and reproduction, from the end of one evaluation to
the start of the next), the mean episode length, and the winner's size
and its largest weight and bias difference from the fc3 seed.

    python -m marlsnake_torch.tools.neat_flagship [GENERATIONS [POP [K]]]
    python -m marlsnake_torch.tools.neat_flagship --device cpu \\
        --generations 2 --pop-size 4 --fitness-episodes 1 \\
        --episode-steps 8 --out /tmp/neat

A run at other counts than the defaults is refused into the default
``OUT``, where the committed curve is.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from marlsnake_torch.algo.neat import Genome, NeatConfig
from marlsnake_torch.algo.neat_hybrid import (HybridNEATTrainer,
                                              fc3_to_genome, load_hybrid_raw)
from marlsnake_torch.device import resolve_device
from marlsnake_torch.utils.profiling import card_label

HYBRID = os.path.join('artifacts', 'hybrid_neat_20x20.pkl')
OUT_DIR = os.path.join('artifacts', 'torch')
CURVE = 'neat_flagship_curve.jsonl'
WINNER = 'hybrid_neat_20x20_full.pkl'
# tools/neat_flagship.py:25-30 and :45-49
DEFAULTS = dict(generations=50, pop_size=100, fitness_episodes=4,
                episode_steps=512)


def neat_config(pop_size: int = DEFAULTS['pop_size']) -> NeatConfig:
    return NeatConfig(num_inputs=128, num_outputs=3, pop_size=pop_size)


def refuse_narrowed(counts: dict, committed: dict, out: str,
                    path: str) -> None:
    """Raise if a run at ``counts`` other than ``committed`` would write
    into the default output directory, over a committed curve."""
    if counts != committed and os.path.abspath(out) == os.path.abspath(
            OUT_DIR):
        raise ValueError(f'a run at {counts} would overwrite {path}, made '
                         f'at {committed}: give it another out')


def load_dqn_params(hybrid: str = HYBRID) -> dict:
    """The trained DQN's flax parameters (the hybrid checkpoint's)."""
    return load_hybrid_raw(hybrid)['dqn_params']


def _weights(g: Genome):
    """({connection: weight, disabled ones as 0}, {node: bias})."""
    return ({k: c.weight if c.enabled else 0.0
             for k, c in g.connections.items()},
            {k: n.bias for k, n in g.nodes.items()})


def genome_delta(winner: Genome, seed: Genome, cfg: NeatConfig) -> dict:
    """The winner's size and its largest absolute weight and bias
    difference from ``seed`` (a connection or node that only one genome
    has counts against 0)."""
    (wc, wb), (sc, sb) = _weights(winner), _weights(seed)

    def most(a, b):
        return max((abs(a.get(k, 0.0) - b.get(k, 0.0))
                    for k in set(a) | set(b)), default=0.0)

    return {'nodes': len(winner.nodes),
            'hidden_nodes': sum(1 for k in winner.nodes
                                if k not in cfg.output_keys),
            'connections': len(winner.connections),
            'enabled_connections': sum(c.enabled for c in
                                       winner.connections.values()),
            'max_abs_weight_delta': most(wc, sc),
            'max_abs_bias_delta': most(wb, sb)}


def episode_summary(trainer) -> dict:
    """The env steps a trainer took, in all and by its episodes' env
    count, and its mean episode length."""
    return {'env_steps': trainer.env_steps,
            'env_steps_by_width': {str(k): v for k, v in
                                   trainer.env_steps_by_width.items()},
            'mean_episode_steps': (trainer.env_steps
                                   / trainer.calls['episodes'])}


def run(generations: int = 50, pop_size: int = 100,
        fitness_episodes: int = 4, episode_steps: int = 512,
        out: str = OUT_DIR, hybrid: str = HYBRID, device='cuda',
        seed: int = 0) -> dict:
    """Evolve, write the curve and the winner, and return the summary."""
    counts = dict(generations=generations, pop_size=pop_size,
                  fitness_episodes=fitness_episodes,
                  episode_steps=episode_steps)
    curve_path = os.path.join(out, CURVE)
    refuse_narrowed(counts, DEFAULTS, out, curve_path)
    # float32 as the parity tests pin the nets (no TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(device)
    card = card_label(dev)
    os.makedirs(os.path.join(out, 'ckpt'), exist_ok=True)
    winner_path = os.path.join(out, 'ckpt', WINNER)
    tr = HybridNEATTrainer(load_dqn_params(hybrid),
                           neat_cfg=neat_config(pop_size),
                           episode_steps=episode_steps,
                           fitness_episodes=fitness_episodes,
                           result_file=winner_path, seed=seed, device=dev)
    # (wall clock, the trainer's phase seconds) at each evaluation's ends
    marks = []
    inner = tr.eval_genomes
    gen_idx = [0]
    rows = []
    with open(curve_path, 'w') as curve:
        def timed_eval(genomes, cfg, *args):
            marks.append((time.time(), dict(tr.seconds)))
            t0 = time.time()
            inner(genomes, cfg, *args)
            dt = time.time() - t0
            marks.append((time.time(), dict(tr.seconds)))
            fits = [g.fitness for _, g in genomes]
            hidden = [sum(1 for nk in g.nodes if nk not in cfg.output_keys)
                      for _, g in genomes]
            rec = {'gen': gen_idx[0], 'best': max(fits),
                   'mean': sum(fits) / len(fits), 'wall_sec': round(dt, 2),
                   'max_hidden_nodes': max(hidden),
                   'mean_hidden_nodes': round(sum(hidden) / len(hidden), 2)}
            gen_idx[0] += 1
            rows.append(dict(rec, eval_s=dt))
            curve.write(json.dumps(rec) + '\n')
            curve.flush()
            print(json.dumps(rec), flush=True)

        tr.eval_genomes = timed_eval
        t0 = time.time()
        best = tr.run(num_generations=generations, verbose=True)
        total = time.time() - t0
    marks.append((time.time(), dict(tr.seconds)))

    def part(label, a, b):
        return marks[b][1].get(label, 0.0) - marks[a][1].get(label, 0.0)

    per_gen = []
    for g, row in enumerate(rows):
        start, end, after = 2 * g, 2 * g + 1, 2 * g + 2
        per_gen.append({
            'eval_s': row['eval_s'],
            'episodes_s': part('episodes', start, end),
            'batch_build_s': part('batch_build', start, end),
            'checkpoint_s': part('checkpoint', start, end),
            # speciation and reproduction: from the end of this
            # evaluation to the start of the next (or of the return)
            'reproduction_s': marks[after][0] - marks[end][0]})
    means = [r['mean'] for r in rows]
    summary = dict(
        counts, card=card, total_s=total,
        generation_s=per_gen,
        generation_mean_s={k: sum(p[k] for p in per_gen) / len(per_gen)
                           for k in per_gen[0]},
        initial_checkpoint_s=marks[0][1].get('checkpoint', 0.0),
        checkpoint_writes=tr.calls.get('checkpoint', 0),
        **episode_summary(tr),
        median_best=statistics.median(r['best'] for r in rows),
        first_five_mean=sum(means[:5]) / len(means[:5]),
        last_five_mean=sum(means[-5:]) / len(means[-5:]),
        best_fitness=best.fitness,
        winner=genome_delta(best, fc3_to_genome(tr.net, tr.neat_cfg),
                            tr.neat_cfg),
        curve=curve_path, checkpoint=winner_path)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('counts', nargs='*', type=int,
                   help='GENERATIONS [POP [K]], as the JAX script takes '
                        'them')
    p.add_argument('--generations', type=int,
                   default=DEFAULTS['generations'])
    p.add_argument('--pop-size', type=int, default=DEFAULTS['pop_size'])
    p.add_argument('--fitness-episodes', type=int,
                   default=DEFAULTS['fitness_episodes'])
    p.add_argument('--episode-steps', type=int,
                   default=DEFAULTS['episode_steps'])
    p.add_argument('--out', default=OUT_DIR)
    p.add_argument('--hybrid', default=HYBRID)
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    if len(a.counts) > 3:
        p.error('at most three positional counts: GENERATIONS POP K')
    for name, value in zip(('generations', 'pop_size', 'fitness_episodes'),
                           a.counts):
        setattr(a, name, value)
    return run(a.generations, a.pop_size, a.fitness_episodes,
               a.episode_steps, a.out, a.hybrid, a.device)


if __name__ == '__main__':
    main()
