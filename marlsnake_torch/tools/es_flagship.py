"""Head-ES flagship: the JAX repository's ``tools/es_flagship.py`` on the
port. It evolves the hybrid decision head past the fc3 seed with
antithetic ES (``HeadESTrainer``) over the frozen trained DQN (the
``dqn_params`` of ``artifacts/hybrid_neat_20x20.pkl``, bit-equal to the
JAX run's orbax ``showcase20``), 4 fitness episodes of 512 steps a
generation on common random numbers, and reports:

* the config as the file's first line, then one row a generation with
  the JAX rows' keys (``HeadESTrainer.run``'s record and ``wall_sec``);
* the held-out paired comparison of the seed and the champion on fresh
  episodes (``ES_HOLDOUT_EPISODES``, 256 by default), with JAX's keys and
  ``seed_sem``, the seed's own standard error over those episodes.

The default run is JAX's canonical run, the config of its committed
``artifacts/es_flagship_curve.jsonl``: 100 generations, pop 256, sigma
0.03, lr 0.003, 32 validation episodes; the JAX script's own defaults
(60, 128, 0.02, 0.01, 8) are not. ``--curve es_broadsearch_curve.jsonl``
with 60 generations, sigma 0.1 and lr 0.01 is the broad search.

Writes ``OUT/CURVE`` (default ``artifacts/torch/es_flagship_curve.jsonl``)
and the champion to ``OUT/ckpt/`` (``hybrid_es_20x20.pkl``, or the curve's
name for another curve). The last line printed is one JSON object: the
card, the total seconds, each generation's seconds split into its fitness
episodes, its validation and checkpoint writes, the mean episode length,
and the holdout.

    python -m marlsnake_torch.tools.es_flagship [GENS [POP [SIGMA [LR [VAL]]]]]
    python -m marlsnake_torch.tools.es_flagship --device cpu \\
        --generations 2 --pop-size 4 --val-episodes 2 --holdout-episodes 4 \\
        --episode-steps 8 --fitness-episodes 1 --out /tmp/es

A run at other counts than a committed curve's is refused into the
default ``OUT``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from marlsnake_torch.algo.neat_hybrid import HeadESTrainer
from marlsnake_torch.device import resolve_device
from marlsnake_torch.tools.neat_flagship import (HYBRID, OUT_DIR,
                                                 episode_summary,
                                                 load_dqn_params,
                                                 neat_config,
                                                 refuse_narrowed)
from marlsnake_torch.utils.profiling import card_label

CURVE = 'es_flagship_curve.jsonl'
BROAD_CURVE = 'es_broadsearch_curve.jsonl'
# the config header of JAX's artifacts/es_flagship_curve.jsonl, in its
# key order
CANONICAL = dict(generations=100, pop_size=256, sigma=0.03, lr=0.003,
                 val_episodes=32, fitness_episodes=4, episode_steps=512)
# NEXT_STEPS.md item 3; JAX's es_broadsearch_curve.jsonl records no pop or
# validation count, so the canonical run's are taken
BROAD = dict(CANONICAL, generations=60, sigma=0.1, lr=0.01)
COMMITTED = {CURVE: CANONICAL, BROAD_CURVE: BROAD}
HOLDOUT_EPISODES = 256
CHAMPIONS = {CURVE: 'hybrid_es_20x20.pkl'}


def holdout_episodes() -> int:
    """The holdout's episode count as the JAX script reads it."""
    return int(os.environ.get('ES_HOLDOUT_EPISODES',
                              str(HOLDOUT_EPISODES)))


def run(generations: int = 100, pop_size: int = 256, sigma: float = 0.03,
        lr: float = 0.003, val_episodes: int = 32,
        fitness_episodes: int = 4, episode_steps: int = 512,
        holdout: int = None, out: str = OUT_DIR, curve: str = CURVE,
        hybrid: str = HYBRID, device='cuda') -> dict:
    """Evolve, write the curve, the holdout and the champion, and return
    the summary."""
    holdout = holdout_episodes() if holdout is None else holdout
    config = dict(generations=generations, pop_size=pop_size, sigma=sigma,
                  lr=lr, val_episodes=val_episodes,
                  fitness_episodes=fitness_episodes,
                  episode_steps=episode_steps)
    curve_path = os.path.join(out, curve)
    refuse_narrowed(dict(config, holdout_episodes=holdout),
                    dict(COMMITTED.get(curve, {}),
                         holdout_episodes=HOLDOUT_EPISODES),
                    out, curve_path)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(device)
    card = card_label(dev)
    os.makedirs(os.path.join(out, 'ckpt'), exist_ok=True)
    champion_path = os.path.join(out, 'ckpt', CHAMPIONS.get(
        curve, 'hybrid_' + curve.replace('_curve.jsonl', '.pkl')))
    es = HeadESTrainer(load_dqn_params(hybrid), neat_cfg=neat_config(),
                       episode_steps=episode_steps, pop_size=pop_size,
                       sigma=sigma, lr=lr,
                       fitness_episodes=fitness_episodes, seed=0,
                       result_file=champion_path, device=dev)
    header = {'config': config}
    if curve == BROAD_CURVE:
        header['note'] = ("JAX's es_broadsearch_curve.jsonl records no pop "
                          f'or validation count: this run takes pop '
                          f'{pop_size} and {val_episodes} validation '
                          f'episodes')
    per_gen = []
    with open(curve_path, 'w') as f:
        f.write(json.dumps(header) + '\n')
        f.flush()
        t_gen = [time.time()]
        marks = [dict(es.seconds)]

        def record(rec):
            now = time.time()
            rec = dict(rec, wall_sec=round(now - t_gen[0], 2))
            snap = dict(es.seconds)
            # generation 0's holds the seed's validation and first save
            per_gen.append(dict(
                {f'{k}_s': snap.get(k, 0.0) - marks[-1].get(k, 0.0)
                 for k in ('fitness', 'validation', 'checkpoint')},
                wall_s=now - t_gen[0]))
            marks.append(snap)
            t_gen[0] = now
            f.write(json.dumps(rec) + '\n')
            f.flush()

        t0 = time.time()
        best_theta, best_val, hist = es.run(
            num_generations=generations, on_generation=record,
            val_episodes=val_episodes)
        total = time.time() - t0

        # held-out paired comparison: seed vs champion on fresh draws
        t1 = time.time()
        ra, rb = es.holdout_returns(es._seed_theta, best_theta,
                                    episodes=holdout)
        holdout_s = time.time() - t1
        d = rb - ra
        dmean, dstd = float(d.mean()), float(d.std(ddof=1))
        sem = dstd / holdout ** 0.5
        verdict = {
            'holdout_episodes': holdout,
            'seed_mean': round(float(np.mean(ra)), 4),
            'champion_mean': round(float(np.mean(rb)), 4),
            'paired_diff_mean': round(dmean, 4),
            'paired_diff_sem': round(sem, 4),
            'champion_beats_seed': bool(dmean > 2 * sem),
            'champion_val_score': round(best_val, 4),
            'seed_val_score': (round(hist[0]['seed_val'], 4) if hist
                               else None),
            'total_min': round(total / 60, 2),
            'seed_sem': round(float(ra.std(ddof=1)) / holdout ** 0.5, 4),
        }
        f.write(json.dumps({'holdout': verdict}) + '\n')
    print('HOLDOUT:', json.dumps(verdict), flush=True)
    summary = dict(
        config, card=card, total_s=total, holdout_s=holdout_s,
        generation_s=per_gen,
        generation_mean_s={k: sum(p[k] for p in per_gen) / len(per_gen)
                           for k in per_gen[0]} if per_gen else {},
        checkpoint_writes=es.calls.get('checkpoint', 0),
        **episode_summary(es),
        holdout=verdict, curve=curve_path, checkpoint=champion_path)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('values', nargs='*',
                   help='GENERATIONS [POP [SIGMA [LR [VAL_EPISODES]]]], as '
                        'the JAX script takes them')
    p.add_argument('--generations', type=int,
                   default=CANONICAL['generations'])
    p.add_argument('--pop-size', type=int, default=CANONICAL['pop_size'])
    p.add_argument('--sigma', type=float, default=CANONICAL['sigma'])
    p.add_argument('--lr', type=float, default=CANONICAL['lr'])
    p.add_argument('--val-episodes', type=int,
                   default=CANONICAL['val_episodes'])
    p.add_argument('--fitness-episodes', type=int,
                   default=CANONICAL['fitness_episodes'])
    p.add_argument('--episode-steps', type=int,
                   default=CANONICAL['episode_steps'])
    p.add_argument('--holdout-episodes', type=int, default=None,
                   help='default: $ES_HOLDOUT_EPISODES, else 256')
    p.add_argument('--curve', default=CURVE,
                   help=f'the curve file in --out ({BROAD_CURVE} for the '
                        f'broad search)')
    p.add_argument('--out', default=OUT_DIR)
    p.add_argument('--hybrid', default=HYBRID)
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    names = (('generations', int), ('pop_size', int), ('sigma', float),
             ('lr', float), ('val_episodes', int))
    if len(a.values) > len(names):
        p.error('at most five positional values: GENERATIONS POP SIGMA LR '
                'VAL_EPISODES')
    for (name, kind), value in zip(names, a.values):
        setattr(a, name, kind(value))
    return run(a.generations, a.pop_size, a.sigma, a.lr, a.val_episodes,
               a.fitness_episodes, a.episode_steps, a.holdout_episodes,
               a.out, a.curve, a.hybrid, a.device)


if __name__ == '__main__':
    main()
