"""The config matrix: the JAX repository's ``bench_table.py`` on the port.

Runs the bench rollout (``bench.measure``: one captured CUDA graph of the
steps, obs consumed by a checksum, auto-reset) over the JAX table's
configs, the ray-feature env's rows, and the policy-in-the-loop rows
(``bench.measure_acting``: a greedy DQN forward for all 4096 x 4 agents,
then the env step, 64 steps as one graph; float32, and the ``_opt`` row
in bfloat16 with binary obs, 8 zero channels and the frame re-encoded
from the grid). The 17 rows carry JAX's tags, env counts, scan lengths
and ``EnvConfig``s field for field, and each row JAX's keys;
``reference_steps_per_sec`` is the reference implementation's single-env
CPU rate where ``BASELINE.md`` gives one (783, 596, 616 env-steps/s).

Writes ``OUT`` (default ``artifacts/torch/BENCH_TABLE.json``): JAX's
``{'unit', 'rows'}`` and ``card``, the card's name and power limit. Each
row is printed as it is measured, with its graph's pool bytes and the
allocator's peak beside it (not in the file).

    python -m marlsnake_torch.bench_table
    python -m marlsnake_torch.bench_table --device cpu --num-envs 2 \\
        --max-steps 2 --iters 1 --blocks 1 --out /tmp/table.json

``--num-envs`` and ``--max-steps`` cap every row's env count and scan
length (a check on the CPU); such a narrowed table is refused into the
default ``OUT``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterator, NamedTuple, Optional

import torch

from marlsnake_torch import bench
from marlsnake_torch.core.maps import load_layout
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.utils.profiling import card_label

OUT = os.path.join('artifacts', 'torch', 'BENCH_TABLE.json')

# (tag, num_envs, cfg, reference steps/s or None): bench_table.py:26-90
CONFIGS = [
    ('20x20x4_full_obs', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3), 783.0),
    ('20x20x4_full_obs_procedural', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
               spawn_mode='procedural'), 783.0),
    ('20x20x4_full_obs_procedural_both', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
               spawn_mode='procedural', spawn_orientations='both'),
     None),
    ('20x20x4_full_obs_procedural_packedobs', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
               spawn_mode='procedural', obs_format='packed'), None),
    ('20x20x4_vision5', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
               vision_range=5), 596.0),
    ('20x20x4_vision5_procedural', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
               vision_range=5, spawn_mode='procedural'), None),
    ('20x20x4_vision5_framestack2', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
               vision_range=5, frame_stack=2), None),
    ('20x20cross_x8_framestack4', 4096,
     EnvConfig(num_snakes=8, snake_length=3, frame_stack=4,
               map_layout=load_layout('20x20_cross')), None),
    # BASELINE.json configs[3]: 4096 envs, 30x30, 8 snakes, frame_stack=4,
    # walls
    ('30x30walls_x8_framestack4', 4096,
     EnvConfig(height=30, width=30, num_snakes=8, snake_length=3,
               frame_stack=4, map_layout=load_layout('30x30_pillars')),
     None),
    ('20x20cross_x8_framestack4_packedobs', 4096,
     EnvConfig(num_snakes=8, snake_length=3, frame_stack=4,
               map_layout=load_layout('20x20_cross'),
               obs_format='packed'), None),
    ('30x30walls_x8_framestack4_packedobs', 4096,
     EnvConfig(height=30, width=30, num_snakes=8, snake_length=3,
               frame_stack=4, map_layout=load_layout('30x30_pillars'),
               obs_format='packed'), None),
    ('40x40ml2_x4', 2048,
     EnvConfig(height=40, width=40, num_snakes=4, snake_length=3,
               map_layout=load_layout('40x40_ml2')), None),
    ('10x10x1', 8192,
     EnvConfig(height=10, width=10, num_snakes=1, snake_length=3), 616.0),
]

# the ray-feature env's rows (bench_table.py:97-104)
GRAPH_CONFIGS = [
    ('20x20x4_graph', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3)),
    ('20x20x4_graph_framestack2', 4096,
     EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
               frame_stack=2)),
]

# rows whose steps take so little device time that a longer graph
# amortises its launch (bench_table.py:110)
LONG_SCAN = {'10x10x1': 1024}

# the policy-in-the-loop rows (bench_table.py:308-316)
ACTING_CONFIG = EnvConfig(height=20, width=20, num_snakes=4,
                          snake_length=3)
ACTING_ENVS = 4096
ACTING = [('20x20x4_dqn_policy_in_loop', False),
          ('20x20x4_dqn_policy_in_loop_opt', True)]


class Row(NamedTuple):
    tag: str
    num_envs: int
    cfg: EnvConfig
    reference: Optional[float]
    kind: str          # 'rollout', 'graph' or 'acting'
    scan_steps: int
    optimized: bool = False


def table() -> Iterator[Row]:
    """The 17 rows in the JAX table's order."""
    for tag, num_envs, cfg, ref in CONFIGS:
        yield Row(tag, num_envs, cfg, ref, 'rollout',
                  LONG_SCAN.get(tag, 256))
    for tag, num_envs, cfg in GRAPH_CONFIGS:
        yield Row(tag, num_envs, cfg, None, 'graph', 256)
    for tag, opt in ACTING:
        yield Row(tag, ACTING_ENVS, ACTING_CONFIG, None, 'acting', 64, opt)


def measure_row(row: Row, device='cuda', num_envs: Optional[int] = None,
                max_steps: Optional[int] = None, iters: Optional[int] = None,
                blocks: Optional[int] = None) -> dict:
    """One row of the file, JAX's keys in JAX's order, with ``memory``
    beside them; ``num_envs`` and ``max_steps`` cap its width and scan,
    ``iters`` and ``blocks`` replace the JAX table's counts."""
    n = min(row.num_envs, num_envs or row.num_envs)
    steps = min(row.scan_steps, max_steps or row.scan_steps)
    counts = {k: v for k, v in (('iters', iters), ('blocks', blocks))
              if v is not None}
    if row.kind == 'acting':
        m = bench.measure_acting(row.cfg, n, steps, optimized=row.optimized,
                                 device=device, **counts)
    else:
        m = bench.measure(row.cfg, n, steps, graph=row.kind == 'graph',
                          device=device, **counts)
    memory = m.pop('memory')
    ref = row.reference
    return dict(config=row.tag, num_envs=n, **m,
                reference_steps_per_sec=ref,
                vs_reference=(round(m['steps_per_sec'] / ref, 1) if ref
                              else None),
                memory=memory)


def run(out: str = OUT, device='cuda', num_envs: Optional[int] = None,
        max_steps: Optional[int] = None, iters: Optional[int] = None,
        blocks: Optional[int] = None) -> dict:
    """Measure every row, write the table to ``out`` and return it."""
    narrowed = any(x is not None for x in (num_envs, max_steps, iters,
                                           blocks))
    if narrowed and os.path.abspath(out) == os.path.abspath(OUT):
        raise ValueError(f'a narrowed table would overwrite {OUT}: give it '
                         f'another out')
    # float32 as the parity tests pin the nets (cuDNN and cuBLAS would
    # take TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(device)
    card = card_label(dev)
    print(card, flush=True)
    rows = []
    for row in table():
        measured = measure_row(row, dev, num_envs, max_steps, iters, blocks)
        print(json.dumps(measured), flush=True)
        measured.pop('memory')
        rows.append(measured)
    result = {'unit': 'env-steps/s/chip', 'rows': rows, 'card': card}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, 'w') as f:
        json.dump(result, f, indent=1)
    print(f'wrote {out}', flush=True)
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--out', default=OUT)
    p.add_argument('--device', default='cuda')
    p.add_argument('--num-envs', type=int, default=None,
                   help="cap every row's env count")
    p.add_argument('--max-steps', type=int, default=None,
                   help="cap every row's scan length")
    p.add_argument('--iters', type=int, default=None)
    p.add_argument('--blocks', type=int, default=None)
    a = p.parse_args(argv)
    return run(a.out, a.device, a.num_envs, a.max_steps, a.iters, a.blocks)


if __name__ == '__main__':
    main()
