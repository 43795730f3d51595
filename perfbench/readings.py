"""The readings that a cell's limits are set from.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--controls]

For each seed: set-up, a short window, the program's state freed, then
the numbers the check compares, of the program against the reference
(the lower readings); with ``--controls`` also of the control, the
reference put in the program's place at the precision below the one the
configuration states (TF32 for the learners; the env's float32 picks in
bfloat16), and of each fault the cell can have, planted in the reference
put in the program's place. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def readings(cell: harness.Cell, seed: int, seconds: float, controls: bool,
             device) -> dict:
    harness.set_precision(cell.config)
    driver = harness.load_module('drivers', cell.workload['driver']).Driver(
        cell.config, cell.workload['params'], seed, device)
    t0 = time.perf_counter()
    driver.setup()
    harness.run_window(driver, seconds, torch.device(device))
    driver.release()
    out = {'seed': seed, 'program': driver.compared()}
    if controls:
        out.update(driver.controls())
    out['seconds'] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--controls', action='store_true')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    cell = harness.Cell.find(a.workload)
    for seed in (int(s) for s in a.seeds.split(',')):
        print(json.dumps(readings(cell, seed, a.seconds, a.controls,
                                  a.device)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
