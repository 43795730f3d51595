#!/usr/bin/env python3
"""Build and drive the PyTorch port (marlsnake_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA step kernel and the safety mask (csrc/safety_mask.cu)
   with nvcc from this checkout's sources, one nvcc a source, started
   together;
3. the kernel against its plain PyTorch version (engine.step_autoreset)
   on the card, at 10x10 with 2 snakes (B=64, done_mode 'all' and 'any'),
   at 20x20 with 4 snakes (B=4096) and at 40x40 with 8 snakes (B=1024),
   64 steps each, the same actions and draws for both: every state and
   output field must be EQUAL, floats included (tolerance 0: the library
   is built with -fmad=false and both sides do the same IEEE operations in
   the same order), and each run must auto-reset some envs; then both
   entries of the safety mask against their plain versions on the card
   (``mask_parity_phase``, tolerance 0): reachable_count on 3,072 and 384
   boards of 20x20, 256 of 40x40 and of 11x9 and 8 of 216x216 at limits
   1, 7, 60 and passable densities 0.3, 0.7, 0.95, and on 384 boards of
   20x20 from starts off the board (row -1, row 20, column -1, column 20,
   row 25: both count 0, as JAX does); safety_mask (act,
   new_dir, next_pos, head_exists) on 8 steps each at 40x40x8, at N=1
   with a claim board, at E=1, at 11x9x3, at 10 and 11 snakes of 20x20
   (on either side of the block's 32 warps), on an obs at an odd cell
   offset into a larger tensor (its base and env stride not multiples of
   16 bytes) and on the battle's seat 0 (E=128, N=1: a view of a 4-snake
   obs with claims), and on random 9-byte cells at 32 snakes of 20x20, 8
   snakes of 216x216 and 12 of 200x200 (whose planes beyond the deadly
   ones overflow shared memory into scratch); before that, each entry's
   registers, spills and shared memory as ptxas reports them for every
   instance, with no spill allowed at the 20x20 instance;
4. the main path: VectorSnakeEnv with 4096 envs of 20x20 with 4 snakes
   and the reference-width DQN (random weights from a seed, float32, TF32
   off) acting epsilon-greedily for 16 steps; the launch counter is set
   to 0 before and read after, and the last step is held against the
   plain version;
5. times at 4096 envs of 20x20x4, after warm-up:
   - device_ms: the kernel's own device time, from torch.profiler over a
     rolling loop (each launch steps the state the previous one returned,
     as the main path does, so the 9 MB of input state is not replayed
     from L2);
   - host_us: the wrapper's host time per call on that rolling loop (host
     clock, no sync, the median of 5 blocks of 100 calls; no output is
     read there, and a caller pays for the view of each output it reads,
     on its first read);
   - call_ms: the wrapper's wall rate (CUDA events around 200 calls on
     the same inputs): the slower of host and device sets it;
   - the same device time under three pacings of the launches (as the
     host sends them, queued back to back behind a device-side sleep,
     spaced 100 us apart), for both entries: pacing_probe;
   - the plain version, the acting forward, marlsnake_torch.bench's
     env-steps/s, and a profiler window over 16 bench steps: device time
     by kernel name and the device's idle share;
6. the step kernel's entry without auto-reset (step_kernel.step, the DQN
   trainer's env step) against engine.step at the same four sizes, 64
   steps of random actions with no reset, so that most envs finish and go
   on being stepped: every field EQUAL (tolerance 0), some env finished.
   Then at the shape and config the training path gives it (256 envs of
   20x20x4 with the trainer's rewards), once as above and once holding
   finished envs still as the trainer does (against engine.step followed
   by step_kernel.select_envs), and holding at 10x10x2, 40x40x8 and
   11x9x3 too;
7. the replay ring on the card against the same calls on the CPU, with the
   same rows, masks and draws: pushes that wrap the ring, then a sample,
   every field and sampled row equal;
8. the training path: DQNTrainer at 256 envs of 20x20 with 4 snakes
   (reference-width DQN, batch 512, ring of 10,000, float32, TF32 off),
   two episodes through train_episode, each chunk of 8 steps a replay of
   its captured CUDA graph; the no-reset entry's launch counter is set to
   0 before and must equal the env steps the chunks ran (an episode's
   last chunk runs on after its last env finished), replays included;
   updates happen,
   the loss is finite, the ring holds min(pushed, capacity) rows, the
   parameters moved and the target parameters did not;
9. one TD update on the card against the same update on the CPU (same
   parameters and batch): loss within 1e-5 relative, each gradient within
   1e-5 + 1e-4 x its largest magnitude (cuDNN and oneDNN sum in other
   orders, and cuDNN's backward may use atomics);
10. a full checkpoint saved on the card and loaded into a fresh trainer:
   one more episode from each gives equal metrics and parameters (cuDNN
   set to its deterministic algorithms for this phase; the saving trainer
   runs its chunks uncaptured, since its graph holds the algorithms of
   its capture, and the fresh one captures its own);
11. times of the training path: the no-reset entry's device_ms, host_us and
   call_ms at 256 and 4096 envs with its byte bound and engine.step
   beside it, its device time while it holds no, half or all envs still,
   a replay push's device time, milliseconds per episode at 32
   and 256 envs for update_every 1 and 4 (marlsnake_torch.bench's train
   rows), and a profiler window over 16 training steps at 32 and 256 envs:
   device time by kernel name, idle share, device-to-host copies a step;
12. the rest of the config surface, one variant after another: procedural
   spawn ('horizontal' at 20x20x4 B=4096, 'both' at 20x20x2), packed obs
   (20x20x4), frame stack 4 with full obs (10x10x2 and 20x20x4, uint8 and
   packed), vision 5 (20x20x4, frame_stack 1 and 2) and all of them at
   once at 40x40x8. For each: both entries against the plain engine, 64
   steps, every state and output field EQUAL (tolerance 0; the step entry
   stepped on and holding finished envs), with the auto-resets and held
   steps counted; then a rollout of 16 steps through VectorSnakeEnv and
   one through the step entry as the trainer drives it, the launch
   counters set to 0 before and read after, the last step held against the
   plain version; then both entries' device_ms, host_us, call_ms and byte
   bound (recomputed for the variant's obs and spawn);
13. this slice's paths at full width: the bench rollout at 4096 envs of
   20x20x4 with pool and procedural spawn, uint8 and packed obs, the
   vision-5 window and the graph (ray) env with the rays' own time, each
   rollout of 256 steps a replay of its captured CUDA graph (launches
   equal the steps, replays included); profiler windows of 16 packed and
   16 graph steps; the replay push on packed rows beside uint8 rows; two
   training episodes at 256 envs with packed obs (launches equal the
   steps the chunk graphs ran, updates made, loss finite) and its
   train-bench row;
14. PPO and the batched evaluator at full width (``ppo_phase``,
   ``evaluator_phase``): three PPO updates at the showcase width (256 envs
   of 20x20x4, length 5, 128 rollout steps) through PPOTrainer.update,
   the auto-reset entry launched once a rollout step, the rollout a
   replay of its captured graph (the counters set to 0 before and read
   after, replays included), losses finite, the first update's entropy
   within 0.1 of ln 3, the parameters moved; update 1's trajectory
   replayed through the plain engine on the CPU with the recorded actions
   and the same draws (every obs, reward and done flag and the final
   states EQUAL); one minibatch of 2,048 rows card against CPU (loss
   within 1e-5 relative, gradients within 1e-5 + 1e-4 x max|g|); a full
   checkpoint round trip (cuDNN deterministic; the next update equal from
   both, the saving trainer's rollout uncaptured); the `--mode ppo` bench rows at 64 and 256 envs; profiler windows
   over 16 rollout steps and one minibatch update of 32,768 rows. Then
   evaluate_batch's loop (build_evaluate_batch, chunks of 8 steps, a
   captured graph) with the port's DQN at 256 envs of 20x20x4 for up to
   512 steps, the step entry and the safety mask launched once a step run
   (whole chunks: the last one runs on after every env is done;
   auto-reset entry never, the plain mask and the plain fills never); the
   mask on the card EQUAL to its plain version on the card and on the CPU
   on 16 recorded steps, and reachable_count's own path (each step's
   3,072 post-move boards, 16 launches) EQUAL to the plain fill; the step
   entry holding no env EQUAL to it without a hold (the chunks' first
   step); the graph EQUAL to its uncaptured chunks (result and every
   buffer, captured under deterministic cuDNN, tolerance 0); ms a step,
   graph against uncaptured in turns (G U U G); profiler windows of 16
   steps both ways (device busy, idle share, launches and read-backs a
   step, the step kernel's and the mask's device us a launch in the
   graph); the capture's seconds and pool bytes; both mask entries'
   device_ms, host_us, call_ms, plain ms and bound at the path's shapes;
15. NEAT and ES evolution at full width (``evolution_phase``):
   HybridNEATTrainer with NeatConfig()'s pop 100 over the reference-width
   DQN (20x20x4, length 5, DEFAULT_REWARD, 512-step episodes) for 3
   generations (the first speciation puts each genome in a species of its
   own, so generation 1 is all elites; generation 2 has mutated
   topologies), and
   HeadESTrainer at pop 128 with 4 fitness and 8 validation episodes for
   2 generations: the step entry launched once an env step (its counter
   set to 0 before each run and read after; the auto-reset entry never);
   four clones of the seed genome score the same; the result pickle loads
   and its net equals its genome; one fitness episode of 8 genomes (seed
   and mutants with hidden sigmoid/tanh nodes) card against CPU with the
   same weights and draws (decisions more than 1e-4 from a tie equal,
   returns equal where every decision agreed); sweep_values at pop 100
   within 1e-5 + 1e-5 x |value| of the CPU (float32 products summed in
   another order); holdout_compare(seed, seed) exactly 0; two ES
   trainers of one seed give equal theta_fitness; each generation's time
   split into fitness episodes and host work (PaddedNetBatch builds,
   checkpoint writes, reproduction); profiler windows of 16 fitness steps;
   then the wrapper layer (``adapter_phase``): make('Snake-v1') plays a
   random episode to its end (one launch of the step entry at B=1 a step,
   no call of the plain engine, the last step EQUAL to it, a rank at the
   end), make_snake(num_envs=8) (one auto-reset launch a step, and the
   auto-reset entry against the plain engine at its B=8),
   DQNEvaluator over 2 episodes (one mask launch at E=1 a step, ms per
   step, a profiler window, the mask's times), render_winner(render=False)
   on the NEAT checkpoint, and the step entry against engine.step at B=1,
   B=100 and B=129, the widths of the adapter, NEAT and ES (tolerance 0);
   then the battle arenas (``battle_phase``): build_battle_batch at 128
   envs of 20x20x4 (length 5) for up to 512 steps, the masked DQN against
   the PPO phase's trained net, the NEAT phase's winner and Greedy
   (chunks of 8 steps, a captured graph; one step launch a step run, no
   plain-engine call; the same battle recorded on the card, uncaptured,
   and 16 of its episodes replayed on the CPU: every decision more than
   1e-4 from a tie equal, near-ties counted, rewards and lifetimes of
   unparted episodes equal; one mask launch at E=128, N=1 a step run; the
   hold of no env and the graph against its uncaptured chunks as in the
   evaluator's; ms a step in turns G U U G, profiler windows of 16 steps
   both ways, the capture's cost; both mask entries at the battle's
   shapes) and the host BattleArena for
   one episode of up to 128 steps (one step launch at B=1 a step, one
   mask launch a step seat 0 began alive); then every subcommand of the
   CLI once at small counts (``cli_phase``: train writes the checkpoint
   that eval, battle, battle --batched, neat and es load; train-ppo and
   demo; the launches of both step entries and of the mask counted per
   subcommand, no plain-engine or plain-mask call);
16. data-parallel training (``parallel_phase``, ``marlsnake_torch/parallel``):
   first both entries against the plain engine at a rank's widths (the
   auto-reset entry at DistributedPPO's 128 envs a gloo rank and the
   scaling harness's 512, the step entry at DistributedDQN's 128 with its
   hold); then world 1 on NCCL in this process, where DistributedDQN (2
   episodes at 256 envs of 20x20x4) and DistributedPPO (2 updates at 256 envs) must
   EQUAL DQNTrainer and PPOTrainer at the same draws (parameters, target,
   Adam state, ring, epsilon, env states, metrics; cuDNN deterministic),
   with the step entry launched once an env step and the auto-reset entry
   once a rollout step; two gloo ranks sharing the card (2 x 128 envs,
   ``parallel.runner``): DQN for 2 episodes and PPO for 1 update with
   parameters bit-equal across ranks, each rank's launches equal to its
   own env steps, and the first all-reduced gradient of each within
   1e-5 + 1e-4 x max|g| of the mean of the ranks' gradients computed on
   the CPU from the same minibatches and parameters;
   ``launch_local_cluster(2, 'cuda', 'gloo')`` with equal digests; the
   scaling harness at world 1 and 2 (findings, not gates: one card cannot
   show scaling); times, and the collectives of a 16-step DQN episode and
   a PPO update by kind (``collective_counts``) with their times;
17. the captured loops (``graph_phase``, ``utils/cuda_graph.py``): each
   graph against its uncaptured body on the card, cuDNN deterministic,
   tolerance 0, every field: two DQN episodes at 256 envs for
   update_every 1 and 4 and the fused update, three PPO updates at 256
   envs (states, trajectories, metrics), 64 bench steps at 4096 envs; the
   launch counters equal to the steps the graphs ran; then in turns
   (graph, uncaptured, uncaptured, graph) ms per DQN step at 32 and 256
   envs, ms per PPO update and rollout at 64 and 256 envs and bench
   env-steps/s at 4096 envs; profiler windows of 16 steps of each path,
   graph and uncaptured (device busy, idle share, device events, graph
   and kernel launches and read-backs a step, each kernel's device time a
   launch inside the graph); each capture's seconds and pool bytes; then
   the program's tracer (``tracer_phase``): 256 stamps back to back in one
   graph, nonzero, in order, on a tick of at most 1,024 ns; two DQN
   episodes at 256 envs traced EQUAL to untraced (tolerance 0, cuDNN
   deterministic), the traced chunk graph with 34 marks; the same
   read-backs a step traced and untraced under ``profiling.trace``, and
   its phase track placed by the stamps' own kernels;
18. the learning-curve and battle programs (``showcase_phase``, after
   the CLI phase): first both step entries against the plain engine at
   the programs' shapes and configs (run_ppo's B=128, run_ppo20's B=256,
   run_dqn's B=32 with its hold, the battle's B=128 of 20x20x4 length 3
   with its hold; tolerance 0); then run_dqn's config (32 envs, ring 50,000, batch 256)
   for 12 episodes through ``examples/train_showcase.py``'s program, one
   captured chunk graph for the cold and the warm ring, EQUAL (cuDNN
   deterministic, tolerance 0: state, ring, epsilon, rows) to the same
   12 episodes uncaptured; 3 updates of run_ppo's config (128 envs)
   EQUAL to the uncaptured rollout; 2 of run_ppo20's (256 envs); ms per
   episode, step and update; ``tools/battle_batch_run.py``'s main at 128
   envs x 512 steps of 20x20x4 (length 3) on the NEAT phase's checkpoint
   (flax-init weights of seed 0), one step and one mask launch a loop
   step, ms per step and a 16-step profiler window. It reads nothing
   under ``artifacts/`` (the flagship phase reads the trained DQN's
   pickle there);
19. the config matrix and evolution at the flagship scale (after the
   showcase phase): ``bench_table_phase`` holds the auto-reset entry
   against the plain engine over 64 steps (tolerance 0) at each config
   of ``marlsnake_torch/bench_table.py`` it had not met (20x20_cross and
   30x30_pillars with 8 snakes and a frame stack of 4, uint8 and packed;
   40x40_ml2; 10x10x1; vision 5 with procedural spawn; procedural spawn
   in both orientations) at 512 or 1,024 envs, times one short block of
   every row of the table (launches equal the steps of every call,
   replays included; graph pool and allocator peak), then the entry's
   device_ms, bytes and bound at those configs at the table's widths;
   ``flagship_phase`` holds the step entry against engine.step at the
   evolution programs' widths (B=100, 257, 32, 128), runs
   ``tools/neat_flagship.py`` (2 generations, pop 100, K=4, 512 steps)
   and ``tools/es_flagship.py`` (2 generations, pop 256, 32 validation
   episodes, a holdout of 64) over the trained DQN of
   ``artifacts/hybrid_neat_20x20.pkl`` (the step entry once an env step,
   tallied by width), one fitness episode of 8 genomes on the trained
   features card against CPU (uncaptured, as it reads every step's
   values back), profiler windows of 16 trained fitness steps at B=100
   and B=257, graph and uncaptured; then the fitness graphs of 512-step
   episodes at B=100 (NEAT) and B=257 (ES) EQUAL to their uncaptured
   chunks (returns and every buffer, cuDNN deterministic, tolerance 0),
   ms a step run in turns G U U G, and each graph's capture seconds and
   pool bytes;
20. the distillation and the two rollout demos (``distill_phase``,
   ``demos_phase``, after the flagship phase): K1 against the plain
   engine over one 32-step greedy rollout of the committed student
   (conv 32,64, fc 128) at E=256 with the iteration's draws and over
   ``examples/demo.py``'s first 64 steps at B=1024 (tolerance 0); then
   ``tools/distill_acting.py``'s ``run`` for 3 outer iterations at that
   width over the trained teacher of ``artifacts/hybrid_neat_20x20.pkl``
   (K1 once a rollout step, 96 launches, no plain-engine call; ms an
   iteration by part; the written student reads back), one outer
   iteration card against CPU at 4 envs and 4 SGD steps of 256
   (``distill_card_vs_cpu``: the visited obs, states, labels and
   agreement EQUAL, gradients within 1e-5 + 1e-4 x max|g|, loss and
   parameters within 1e-5, the CPU chain taking the card's gradient
   where both sides' are within Adam's eps of zero), a profiler window
   of one full-width iteration (busy, idle share, K1's device us a
   launch, allocator peak); then both demos' ``main`` at their defaults
   (K1 once a step, 512 launches each, no plain-engine call) and their
   env-steps/s;
21. one JSON line of kernels (every entry and variant; the auto-reset
   entry's row carries the PPO numbers and the config matrix's launches,
   the step entry's the evaluator's,
   the evolution's, the adapters', the battles', the CLI's, the
   data-parallel trainers', the programs' and the flagship programs',
   with its launches on every
   path; the auto-reset entry's ``launches_by_path`` the distillation's
   and the demos'; a row of the auto-reset entry at each new config of the matrix;
   masked_actions with its launches on every masked path and its times
   at E=256 x N=4, 128 x 1 and 1 x 4; reachable_count with its own path's
   launches and its times at 3,072 and 384 boards), then, as the last
   line, {"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": ...}}.

The graph phase alone (~3 minutes of command time): ``python3 -c "import
torch, chip_smoke as cs; torch.backends.cudnn.allow_tf32 = False;
torch.backends.cuda.matmul.allow_tf32 = False; from marlsnake_torch.ops
import step_kernel; step_kernel.build_library(); cs.graph_phase('')"``.
Run one phase alone: ``python3 -c "import chip_smoke as cs, tempfile, torch;
torch.backends.cudnn.allow_tf32 = False;
torch.backends.cuda.matmul.allow_tf32 = False; d = tempfile.mkdtemp();
cs.evolution_phase('', d); cs.adapter_phase('', d)"``; the battle and CLI
phases need the NEAT phase's ``neat.pkl`` in ``d`` and PPO parameters
(``cs.ppo_phase('', keep)`` puts them in ``keep['ppo_params']``);
``cs.parallel_phase('', d)`` runs alone once the kernel is built
(``step_kernel.build_library()``).

``python3 chip_smoke.py --masked-paths [DIR]`` times the three masked
paths alone (``masked_paths``: ms per step and a 16-step profiler window
of evaluate_batch, build_battle_batch and DQNEvaluator) and both mask
entries at those paths' shapes (``mask_kernel_times``) against the
marlsnake_torch package in DIR, by default this checkout's: a parent
tree unpacked with ``git archive`` into a git-ignored directory gives
the parent's numbers on the same card, run in turns with this tree's.
``python3 chip_smoke.py --mask-phases`` does the same for this checkout,
then times masked_actions built to stop after each of its phases
(``mask_phase_times``).

Exits non-zero without a result when CUDA is not available.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# H100 SXM int32 and logic rate: 64 lanes on each of 132 SMs at 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TRACER_STAMPS = 256   # back-to-back stamps of tracer_phase
KERNEL_NAME = 'step_autoreset'       # part of the kernels' names as the
STEP_KERNEL_NAME = 'step_noreset'    # profiler reports them
MASK_KERNEL_NAME = 'masked_actions_kernel'
FILL_KERNEL_NAME = 'reachable_count_kernel'
FILL_WORD_OPS = 9    # a board word a round: 2 shifts, 4 ORs of neighbours,
                     # an AND with the passable word, an OR, a popcount
SCAN_CELL_OPS = 16   # a cell of the mask's obs scan: 8 channel compares,
                     # the deadly OR, 2 argmax keys, the length


def log(*args):
    print(*args, flush=True)


def event_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_us(fn, blocks: int = 5, iters: int = 100) -> list:
    """Host microseconds to call ``fn()``, one mean per block of
    ``iters`` calls: a host clock around the block with no
    synchronisation inside (fewer calls than the launch queue holds, so
    the host never waits for the device). The host is shared, so the
    median block is the figure and the others show the spread."""
    fn()
    per_block = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per_block.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return per_block


def profile_device(fn, iters: int) -> dict:
    """``marlsnake_torch.utils.profiling.device_profile``: ``iters`` calls
    of ``fn()`` under torch.profiler, after one to warm up (imported
    here, once the port is on the path)."""
    from marlsnake_torch.utils.profiling import device_profile
    return device_profile(fn, iters)


def kernel_device_us(fn, kernel_name: str, iters: int) -> float:
    """Mean device microseconds of the kernels named ``kernel_name`` over
    ``iters`` calls of ``fn()``, from torch.profiler. The tracer now and
    then returns a window without its device records: such a window is
    taken again, at most twice, before this raises."""
    for _ in range(3):
        prof = profile_device(fn, iters)
        mine = [v for k, v in prof['kernels'].items() if kernel_name in k]
        if mine:
            return sum(v[0] for v in mine) / sum(v[1] for v in mine)
        log(f'the profiler saw no {kernel_name} kernel in {iters} calls '
            f'({len(prof["kernels"])} device event names): once more')
    raise AssertionError(f'the profiler saw no {kernel_name} kernel')


def compare(kernel_pair, plain_pair, where: str) -> float:
    """Raise unless every field is equal; returns the max abs difference
    over the float fields (0.0 when equal)."""
    err = 0.0
    for got, want in zip(kernel_pair, plain_pair):
        for (name, a), (_, b) in zip(got.fields(), want.fields()):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f'{where}: {name} is {a.dtype} '
                                     f'{tuple(a.shape)}, plain {b.dtype} '
                                     f'{tuple(b.shape)}')
            if a.is_floating_point():
                err = max(err, (a - b).abs().max().item() if a.numel()
                          else 0.0)
            if not torch.equal(a, b):
                bad = (a != b).nonzero()[:5].tolist()
                raise AssertionError(f'{where}: {name} differs at {bad}')
    return err


def describe(cfg) -> str:
    """A config's board and the options that differ from the default."""
    parts = [f'{cfg.height}x{cfg.width}x{cfg.num_snakes}',
             f'done_mode={cfg.done_mode}']
    if cfg.spawn_mode != 'pool':
        parts.append(f'spawn={cfg.spawn_mode}/{cfg.spawn_orientations}')
    if cfg.obs_format != 'uint8':
        parts.append(cfg.obs_format)
    if cfg.frame_stack != 1:
        parts.append(f'frame_stack={cfg.frame_stack}')
    if cfg.vision_range:
        parts.append(f'vision={cfg.vision_range}')
    return ' '.join(parts)


def parity(cfg, num_envs: int, steps: int, seed: int) -> float:
    from marlsnake_torch.core import engine
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import reset_draws, step_draws

    dev = torch.device('cuda')
    tables = engine.spawn_tables(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state, _ = engine.reset(cfg, tables,
                            reset_draws(cfg, num_envs, gen, dev))
    before = step_kernel.step_autoreset.launches
    err, resets = 0.0, 0
    for t in range(steps):
        actions = torch.randint(0, cfg.num_actions,
                                (num_envs, cfg.num_snakes), generator=gen,
                                device=dev, dtype=torch.int32)
        draws = step_draws(cfg, num_envs, gen, dev)
        want = engine.step_autoreset(cfg, tables, state, actions, draws)
        got = step_kernel.step_autoreset(cfg, tables, state, actions, draws)
        torch.cuda.synchronize()
        err = max(err, compare(got, want, f'{describe(cfg)} t={t}'))
        resets += int(got[1].done_all.sum())
        state = got[0]
    if step_kernel.step_autoreset.launches - before != steps:
        raise AssertionError('the launch counter did not move')
    if resets == 0:
        raise AssertionError('no auto-reset happened in the parity run')
    log(f'parity {describe(cfg)} B={num_envs} steps={steps}: equal, '
        f'{resets} auto-resets, max_abs_err={err}')
    return err


def parity_step(cfg, num_envs: int, steps: int, seed: int,
                hold: bool = False) -> float:
    """The entry without auto-reset against engine.step, from one reset
    on: envs finish and go on being stepped or, with ``hold``, are held
    still from the step after they finish, inside the kernel's launch
    (against engine.step followed by step_kernel.select_envs)."""
    from marlsnake_torch.core import engine
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import reset_draws

    dev = torch.device('cuda')
    tables = engine.spawn_tables(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state, _ = engine.reset(cfg, tables,
                            reset_draws(cfg, num_envs, gen, dev))
    before = step_kernel.step.launches
    err, finished, stepped_after, held = 0.0, 0, 0, 0
    frozen = torch.zeros((num_envs,), dtype=torch.bool, device=dev)
    out = want_out = None
    for t in range(steps):
        actions = torch.randint(0, cfg.num_actions,
                                (num_envs, cfg.num_snakes), generator=gen,
                                device=dev, dtype=torch.int32)
        fruit_u = torch.rand((num_envs, cfg.num_snakes), generator=gen,
                             device=dev)
        want = engine.step(cfg, state, actions, fruit_u)
        if hold and t > 0:
            held += int(frozen.sum())
            want = step_kernel.select_envs(frozen, (state, want_out), want)
            got = step_kernel.step(cfg, state, actions, fruit_u,
                                   hold=(frozen, out))
        else:
            stepped_after += int(frozen.sum())
            got = step_kernel.step(cfg, state, actions, fruit_u)
        torch.cuda.synchronize()
        err = max(err, compare(got, want, f'step {describe(cfg)} t={t}'))
        state, out, want_out = got[0], got[1], want[1]
        frozen = frozen | out.done_all
        finished = int(frozen.sum()) if hold else int(out.done_all.sum())
    if step_kernel.step.launches - before != steps:
        raise AssertionError('the step launch counter did not move by one '
                             'a step')
    if finished == 0 or (held if hold else stepped_after) == 0:
        raise AssertionError('no finished env was stepped or held in the '
                             'run')
    log(f'parity step (no reset) {describe(cfg)} '
        f'rewards={cfg.rewards} B={num_envs} '
        f'steps={steps}: equal, {finished} envs finished at the end, '
        + (f'{held} steps of envs held still, ' if hold else
           f'{stepped_after} steps of finished envs, ')
        + f'max_abs_err={err}')
    return err


def kernel_traffic(cfg, state, actions, draws, outputs,
                   autoreset: bool = True) -> tuple:
    """(bytes, ops) one step must move and do: every input read once,
    every output written once. What only a resetting env reads is counted
    for the envs that reset in this step (none without auto-reset, where
    ``draws`` is the fruit draws alone): its pool row and the base grid,
    or its snakes' four procedural draws. The oldest slot of the frame
    history is dropped unread."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    new_state, out = outputs
    resets = int(out.done_all.sum()) if autoreset else 0
    b, n, k = state.num_envs, cfg.num_snakes, cfg.snake_length
    hw = cfg.height * cfg.width
    draws = list(draws)
    if autoreset and cfg.spawn_mode == 'procedural':
        spawn_read = resets * n * 16
        draws = [draws[0], draws[2]]
    else:
        spawn_read = resets * n * k * 4 + (hw * 4 if resets else 0)
    dropped = (nbytes([state.hist_grid[:, :1], state.obs_stack[:, :1]])
               if cfg.frame_stack > 1 else 0)
    read = (nbytes([t for _, t in state.fields()]) - dropped
            + nbytes([actions.to(torch.int32)]) + nbytes(draws)
            + spawn_read)
    written = (nbytes([t for _, t in new_state.fields()])
               + nbytes([t for _, t in out.fields()]))
    # integer work: ~2 ops per obs byte (bit extract + store) and ~16 per
    # cell for the grid passes (erase, prefix count, fruit pick, copy)
    ops = b * (2 * out.obs[0].numel() + 16 * hw)
    return read + written, ops


def bound_row(label, device_ms, host_blocks, call_ms, plain_ms, traffic,
              smi) -> dict:
    """An entry's times beside its bound, logged and as a ``kernels`` row:
    ``traffic`` is (bytes, int32 operations) its inputs need."""
    wrapper_us = sorted(host_blocks)[len(host_blocks) // 2]
    nbytes, ops = traffic
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    pct_of_bound = 100.0 * bound_ms / device_ms
    log(f'{label}: device {device_ms:.5f} ms (torch.profiler), '
        f'host {wrapper_us:.2f} us per call (median of blocks '
        f'{[round(x, 2) for x in host_blocks]}), call {call_ms:.5f} ms, '
        f'plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({nbytes} bytes '
        f'-> {bytes_ms:.5f} ms; {ops} int ops -> {ops_ms:.5f} ms), '
        f'{pct_of_bound:.1f}% of bound [{smi}]')
    return {'ms': device_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'library_ms': None, 'device_ms': device_ms,
            'host_us': wrapper_us, 'call_ms': call_ms,
            'pct_of_bound': pct_of_bound, 'bytes': nbytes, 'int_ops': ops}


def time_entry(label, kernel_name, step_fn, plain_fn, state, traffic,
               smi) -> dict:
    """Times of one entry of the step kernel. ``step_fn(state)`` returns
    (state, out) through the wrapper; ``plain_fn()`` is its plain version
    on the same inputs; ``traffic`` is kernel_traffic's (bytes, ops)."""
    rolling = [state]

    def roll():
        rolling[0], _ = step_fn(rolling[0])

    device_ms = kernel_device_us(roll, kernel_name, 100) / 1e3
    host_blocks = host_us(roll)
    call_ms = event_ms(lambda: step_fn(state), 200)
    plain_ms = event_ms(plain_fn, 20)
    return bound_row(f'{label} (rolling)', device_ms, host_blocks, call_ms,
                     plain_ms, traffic, smi)


def pacing_probe(label, kernel_name, step_fn, state, smi) -> dict:
    """Device microseconds a launch of one entry over the same rolling
    loop of 100 launches under three pacings: 'host', as the host sends
    them (what time_entry reports); 'queued', behind a device-side sleep
    of a few milliseconds, so that all 100 are enqueued before the first
    runs and they run back to back; 'spaced', the host waiting 100 us
    after each launch, so that every launch finds the device idle. A
    kernel that a launch's own stores to the L2 cache can outrun reads
    lower the more idle time its predecessor's stores had to drain."""
    rolling = [state]

    def burst(setup, pause):
        def run():
            setup()
            for _ in range(100):
                rolling[0], _ = step_fn(rolling[0])
                if pause:
                    time.sleep(pause)
        return run

    pacings = {
        'host': burst(lambda: None, 0.0),
        'queued': burst(lambda: torch.cuda._sleep(10_000_000), 0.0),
        'spaced': burst(lambda: None, 1e-4)}
    out = {k: kernel_device_us(fn, kernel_name, 1)
           for k, fn in pacings.items()}
    log(f'{label}: device us a launch by pacing of 100 rolling launches '
        f'(torch.profiler): {json.dumps(out)} [{smi}]')
    return out


def log_window(title, window, steps, smi, also=()) -> None:
    """The window's totals and its 14 largest kernels, then every kernel
    whose name holds one of ``also``."""
    log(f'{title}: wall {window["wall_us"]:.1f} us, device busy '
        f'{window["busy_us"]:.1f} us over a span of '
        f'{window["span_us"]:.1f} us, idle share {window["idle_share"]}, '
        f'{window["dtoh"]} device-to-host copies in {steps} steps '
        f'({window["dtoh"] / steps:.2f} a step), '
        f'{sum(v[1] for v in window["kernels"].values())} device events, '
        f'{window["graph_launches"]} graph launches and '
        f'{window["kernel_launches"]} kernel launches from the host '
        f'[{smi}]')
    table = sorted(window['kernels'].items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, count)) in enumerate(table):
        if i < 14 or any(part in name for part in also):
            log(f'  {us:10.1f} us {count:4d}x  {name[:100]}')


def drive_rollout(cfg, num_envs: int, steps: int, seed: int) -> int:
    """``steps`` random-action steps through VectorSnakeEnv (auto-reset),
    the entry's launch counter set to 0 before and read after; the last
    step must equal the plain engine's. Returns the launches."""
    from marlsnake_torch.core import engine
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import step_draws

    env = VectorSnakeEnv(cfg, num_envs, device='cuda', seed=seed)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 1)
    states, obs = env.reset()
    step_kernel.step_autoreset.launches = 0
    for _ in range(steps):
        actions = torch.randint(0, cfg.num_actions,
                                (num_envs, cfg.num_snakes), generator=gen,
                                device='cuda', dtype=torch.int32)
        last = (states, actions, step_draws(cfg, num_envs, env.generator,
                                            'cuda'))
        states, out = env.step(*last)
    torch.cuda.synchronize()
    launches = step_kernel.step_autoreset.launches
    if launches != steps:
        raise AssertionError(f'{describe(cfg)}: {steps} rollout steps but '
                             f'{launches} launches of step_autoreset')
    compare((states, out), engine.step_autoreset(
        cfg, engine.spawn_tables(cfg, torch.device('cuda')), *last),
        f'{describe(cfg)} rollout, last step')
    if out.obs.shape != (num_envs,) + cfg.obs_shape \
            or out.obs.dtype != torch.uint8:
        raise AssertionError(f'obs {out.obs.dtype} {tuple(out.obs.shape)}')
    return launches


def drive_steps(cfg, num_envs: int, steps: int, seed: int) -> tuple:
    """The entry without auto-reset as the trainer drives it: from one
    reset on, finished envs held still (``build_vector_fns`` with
    ``autoreset=False``); the counter set to 0 before and read after, the
    last step held against ``engine.step`` then ``select_envs``. Returns
    (launches, envs held in the last step)."""
    from marlsnake_torch.core import engine
    from marlsnake_torch.envs.vector import build_vector_fns
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import StepDraws, reset_draws

    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=False, device='cuda')
    state, _ = reset_fn(reset_draws(cfg, num_envs, gen, 'cuda'))
    frozen = torch.zeros((num_envs,), dtype=torch.bool, device='cuda')
    out = None
    step_kernel.step.launches = 0
    for t in range(steps):
        actions = torch.randint(0, cfg.num_actions,
                                (num_envs, cfg.num_snakes), generator=gen,
                                device='cuda', dtype=torch.int32)
        fruit_u = torch.rand((num_envs, cfg.num_snakes), generator=gen,
                             device='cuda')
        last = (state, out, frozen)
        state, out = step_fn(state, actions, StepDraws(fruit_u, None, None),
                             hold=(frozen, out) if t > 0 else None)
        frozen = frozen | out.done_all
    torch.cuda.synchronize()
    launches = step_kernel.step.launches
    if launches != steps:
        raise AssertionError(f'{describe(cfg)}: {steps} steps but '
                             f'{launches} launches of step')
    old_state, old_out, keep = last
    want = step_kernel.select_envs(
        keep, (old_state, old_out),
        engine.step(cfg, old_state, actions, fruit_u))
    compare((state, out), want, f'{describe(cfg)} held steps, last step')
    return launches, int(keep.sum())


def time_autoreset(name: str, cfg, num_envs: int, seed: int, smi: str):
    """The auto-reset entry's times at ``num_envs`` envs of ``cfg``, on a
    state 8 steps past a reset (so that it has dead snakes and resets).
    Each of the 8 steps and the timed one are first held against the
    plain engine on the same inputs at this width (tolerance 0; raises on
    a difference). Returns (the ``kernels`` row's numbers, the (state,
    actions, draws) timed, the max abs difference at this width)."""
    from marlsnake_torch.core import engine
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import reset_draws, step_draws

    dev = torch.device('cuda')
    tables = engine.spawn_tables(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st, _ = engine.reset(cfg, tables, reset_draws(cfg, num_envs, gen, dev))
    acts = torch.randint(0, cfg.num_actions, (num_envs, cfg.num_snakes),
                         generator=gen, device=dev, dtype=torch.int32)
    d = step_draws(cfg, num_envs, gen, dev)
    where = f'{describe(cfg)} B={num_envs}'
    err, resets = 0.0, 0
    for t in range(9):
        got = step_kernel.step_autoreset(cfg, tables, st, acts, d)
        want = engine.step_autoreset(cfg, tables, st, acts, d)
        torch.cuda.synchronize()
        err = max(err, compare(got, want, f'{where} t={t}'))
        resets += int(got[1].done_all.sum())
        del want
        if t < 8:
            st = got[0]
    log(f'parity {where} (the timed width) over 9 steps: equal, {resets} '
        f'auto-resets, max_abs_err={err}')
    auto = time_entry(
        f'step_autoreset [{name}] at B={num_envs} {describe(cfg)}',
        KERNEL_NAME,
        lambda x: step_kernel.step_autoreset(cfg, tables, x, acts, d),
        lambda: engine.step_autoreset(cfg, tables, st, acts, d), st,
        kernel_traffic(cfg, st, acts, d, got), smi)
    return auto, (st, acts, d), err


def run_variant(name: str, cfg, num_envs: int, parity_envs: int, seed: int,
                smi: str) -> list:
    """One config variant through both entries: parity over 64 steps,
    a driven rollout with its launch count, and times at ``num_envs``.
    Returns the two rows of the kernels line."""
    from marlsnake_torch.core import engine
    from marlsnake_torch.ops import step_kernel

    log(f'--- variant {name}: {describe(cfg)} ---')
    err_auto = parity(cfg, parity_envs, 64, seed)
    err_step = max(parity_step(cfg, parity_envs, 64, seed + 1),
                   parity_step(cfg, parity_envs, 64, seed + 2, hold=True))
    auto_launches = drive_rollout(cfg, num_envs, 16, seed + 3)
    step_launches, held = drive_steps(cfg, num_envs, 16, seed + 4)
    log(f'{name}: rollout of 16 steps at B={num_envs}: {auto_launches} '
        f'launches of step_autoreset; 16 held steps: {step_launches} '
        f'launches of step, {held} envs held in the last; last steps equal '
        f'to the plain versions')

    auto, (st, acts, d), err_wide = time_autoreset(name, cfg, num_envs,
                                                   seed + 5, smi)
    err_auto = max(err_auto, err_wide)
    size = f'B={num_envs} {describe(cfg)}'
    plain = time_entry(
        f'step (no reset) [{name}] at {size}', STEP_KERNEL_NAME,
        lambda x: step_kernel.step(cfg, x, acts, d.fruit_u),
        lambda: engine.step(cfg, st, acts, d.fruit_u), st,
        kernel_traffic(cfg, st, acts, [d.fruit_u], step_kernel.step(
            cfg, st, acts, d.fruit_u), autoreset=False), smi)
    common = dict(route='cuda',
                  source='marlsnake_torch/csrc/step_autoreset.cu',
                  variant=describe(cfg), num_envs=num_envs)
    return [dict(auto, **common, name=f'step_autoreset[{name}]',
                 replaces='marlsnake_tpu/ops/pallas_step.py:54',
                 launches=auto_launches, max_abs_err=err_auto),
            dict(plain, **common, name=f'step[{name}]',
                 replaces='marlsnake_tpu/core/engine.py:987 (step, an XLA '
                          'path, not a Pallas kernel)',
                 launches=step_launches, max_abs_err=err_step)]


def time_push(obs_shape, rows_n: int, cap: int, gen, smi: str) -> dict:
    """Device time of one masked replay push of ``rows_n`` rows of
    ``obs_shape`` uint8 obs into a ring of ``cap``, against the bytes it
    reads and writes."""
    from marlsnake_torch.algo import replay

    ring = replay.create(cap, obs_shape, device='cuda')
    o = torch.randint(0, 2, (rows_n,) + tuple(obs_shape), generator=gen,
                      device='cuda', dtype=torch.uint8)
    a_ = torch.randint(0, 3, (rows_n,), generator=gen, device='cuda',
                       dtype=torch.int32)
    r_ = torch.rand((rows_n,), generator=gen, device='cuda')
    mk = torch.rand((rows_n,), generator=gen, device='cuda') < 0.7
    push = profile_device(
        lambda: replay.push(ring, o, a_, r_, o, mk, mask=mk), 20)
    moved = 2 * (2 * rows_n * o[0].numel() + rows_n * 9)
    device_us = push['busy_us'] / 20
    bound_us = moved / HBM_BYTES_PER_S * 1e6
    log(f'replay push of {rows_n} rows of {o[0].numel()} bytes '
        f'({rows_n // 4} envs) into {cap} slots: device {device_us:.1f} us '
        f'a push in {sum(v[1] for v in push["kernels"].values()) // 20} '
        f'kernels, host wall {push["wall_us"] / 20:.1f} us; it reads and '
        f'writes {moved} bytes -> {bound_us:.2f} us at the memory rate '
        f'({device_us / bound_us:.1f}x) [{smi}]')
    return {'rows': rows_n, 'row_bytes': o[0].numel(),
            'device_us': device_us, 'bound_us': bound_us}


def replay_parity(seed: int) -> None:
    """The ring on the card against the ring on the CPU: the same rows,
    masks and sort keys (made on the CPU from ``seed``)."""
    from marlsnake_torch.algo import replay

    gen = torch.Generator().manual_seed(seed)
    cap, rows, obs_shape = 1000, 384, (20, 20, 8)
    rings = {d: replay.create(cap, obs_shape, device=d)
             for d in ('cpu', 'cuda')}
    pushed = 0
    for _ in range(4):                      # 4 x ~270 rows wrap 1000 slots
        obs = torch.randint(0, 2, (rows,) + obs_shape, generator=gen,
                            dtype=torch.uint8)
        nxt = torch.randint(0, 2, (rows,) + obs_shape, generator=gen,
                            dtype=torch.uint8)
        act = torch.randint(0, 3, (rows,), generator=gen, dtype=torch.int32)
        rew = torch.randn((rows,), generator=gen)
        done = torch.rand((rows,), generator=gen) < 0.3
        mask = torch.rand((rows,), generator=gen) < 0.7
        pushed += int(mask.sum())
        for d, ring in rings.items():
            replay.push(ring, *(x.to(d) for x in (obs, act, rew, nxt, done)),
                        mask=mask.to(d))
    u = torch.rand((cap,), generator=gen)
    samples = {d: replay.sample(ring, 512, u.to(d))
               for d, ring in rings.items()}
    torch.cuda.synchronize()
    if pushed <= cap:
        raise AssertionError('the pushes did not wrap the ring')
    for (name, a), (_, b) in zip(rings['cpu'].fields(),
                                 rings['cuda'].fields()):
        a, b = (a, b.cpu()) if a.dim() == 0 else (a[:cap], b[:cap].cpu())
        if not torch.equal(a, b):
            raise AssertionError(f'replay ring: {name} differs')
    for i, (a, b) in enumerate(zip(samples['cpu'], samples['cuda'])):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f'replay sample: part {i} differs')
    log(f'replay on the card equals the CPU ring: {pushed} rows pushed '
        f'into {cap} slots (ptr {int(rings["cuda"].ptr)}, size '
        f'{int(rings["cuda"].size)}), a sample of 512 equal')


def replay_ppo_rollout(trainer, start, draws, traj, end) -> int:
    """A PPO rollout recorded on the card, replayed through the plain
    engine on the CPU: from ``start`` (env states, obs, agent_done on the
    CPU) the recorded actions and the same step draws must give, step by
    step, the recorded obs, valid flags, rewards and done flags, and at
    the end the env states, obs and agent_done of ``end``, all EQUAL.
    Returns the envs that auto-reset in the rollout."""
    from marlsnake_torch.core import engine
    from marlsnake_torch.rng import StepDraws

    cfg = trainer.env_cfg
    tables = engine.spawn_tables(cfg, torch.device('cpu'))
    state, obs, agent_done = start
    e, n = agent_done.shape
    resets = 0

    def equal(what, got, want, t):
        if not torch.equal(got, want):
            raise AssertionError(f'PPO replay: {what} differs at step {t}')

    for t in range(traj['action'].shape[0]):
        action = traj['action'][t]
        equal('obs', traj['obs'][t], obs.reshape(e * n, -1), t)
        equal('valid', traj['valid'][t], ~agent_done, t)
        if bool((action[agent_done] != 0).any()) or int(action.min()) < 0 \
                or int(action.max()) >= cfg.num_actions:
            raise AssertionError(f'PPO replay: actions out of range or a '
                                 f'dead agent acted at step {t}')
        state, out = engine.step_autoreset(
            cfg, tables, state, action,
            StepDraws(*(x[t].cpu() for x in draws.step)))
        equal('reward', traj['reward'][t],
              torch.where(~agent_done, out.reward, 0.0), t)
        ep_done = out.done_all
        resets += int(ep_done.sum())
        equal('next_done', traj['next_done'][t], out.done | ep_done[:, None],
              t)
        agent_done = out.done & ~ep_done[:, None]
        obs = out.obs
    end_state, end_obs, end_done = end
    for (name, a), (_, b) in zip(state.fields(), end_state.fields()):
        equal(f'final state {name}', a, b, 'end')
    equal('final obs', obs, end_obs, 'end')
    equal('final agent_done', agent_done, end_done, 'end')
    return resets


def ppo_phase(smi: str, keep: dict = None) -> dict:
    """PPO at the showcase width (PPOConfig's defaults at 256 envs: 20x20,
    4 snakes of length 5, 128 rollout steps, 4 epochs of 4 minibatches of
    32,768): three updates through PPOTrainer.update with the counters set
    to 0 before and read after; update 1's trajectory replayed on the CPU;
    one minibatch of 2,048 rows on the card against the CPU; a full
    checkpoint round trip; the bench rows and two profiler windows. The
    parameters after the three updates go into ``keep['ppo_params']``."""
    from marlsnake_torch import bench
    from marlsnake_torch.algo.ppo_trainer import (Minibatch, PPOConfig,
                                                  PPOTrainer)
    from marlsnake_torch.core.state import EnvState
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import ppo_draws

    def to_cpu(x):
        return x.to('cpu', copy=True)   # a copy, whatever the device

    def state_to_cpu(ts):
        return (EnvState(**{k: to_cpu(v) for k, v in ts.env_states.fields()}),
                to_cpu(ts.obs), to_cpu(ts.agent_done))

    def config(**kwargs):
        return PPOConfig(**{**dict(num_envs=256, save_final=False),
                            **kwargs})

    cfg = config()
    if (cfg.height, cfg.width, cfg.num_snakes, cfg.snake_length,
            cfg.rollout_steps, cfg.update_epochs, cfg.num_minibatches) != (
            20, 20, 4, 5, 128, 4, 4):
        raise AssertionError('the PPO defaults moved')
    trainer = PPOTrainer(cfg, device='cuda')
    ts = trainer.init_state()
    first = {k: v.clone() for k, v in ts.params.items()}
    start = state_to_cpu(ts)
    draws = ppo_draws(trainer.env_cfg, cfg.num_envs, cfg.rollout_steps,
                      cfg.update_epochs, trainer.generator, trainer.device)
    metrics = []
    step_kernel.step_autoreset.launches = 0
    step_kernel.step.launches = 0
    t0 = time.perf_counter()
    ts, m = trainer.update(ts, draws)
    traj = {k: to_cpu(getattr(trainer.trajectory, k))
            for k in ('obs', 'action', 'reward', 'valid', 'next_done')}
    end1 = state_to_cpu(ts)
    metrics.append(m)
    for _ in range(2):
        ts, m = trainer.update(ts)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = step_kernel.step_autoreset.launches
    step_launches = step_kernel.step.launches
    losses = [[float(getattr(m, k)) for k in (
        'loss_actor', 'loss_value', 'entropy', 'approx_kl')] for m in metrics]
    log(f'PPO path: 3 updates at {cfg.num_envs} envs x {cfg.rollout_steps} '
        f'steps in {wall:.2f} s (first with the warm-up), step_autoreset '
        f'launches={launches}, step launches={step_launches}; (actor, value, '
        f'entropy, kl) {losses}; episodes '
        f'{[int(m.episodes_collected) for m in metrics]}, mean return '
        f'{[float(m.mean_episode_return) for m in metrics]}')
    if launches != 3 * cfg.rollout_steps or step_launches != 0:
        raise AssertionError(f'{3 * cfg.rollout_steps} PPO rollout steps but '
                             f'{launches} launches of step_autoreset and '
                             f'{step_launches} of step')
    if not all(math.isfinite(x) for row in losses for x in row):
        raise AssertionError('a PPO loss is not finite')
    if abs(losses[0][2] - math.log(3)) > 0.1:
        raise AssertionError(f'entropy of the first update {losses[0][2]} '
                             f'is not within 0.1 of ln 3')
    if not any(not torch.equal(ts.params[k], first[k]) for k in first) \
            or not all(bool(torch.isfinite(v).all())
                       for v in ts.params.values()):
        raise AssertionError('the PPO parameters did not move or are not '
                             'finite')
    if keep is not None:
        keep['ppo_params'] = {k: v.detach().clone()
                              for k, v in ts.params.items()}
    resets = replay_ppo_rollout(trainer, start, draws, traj, end1)
    log(f'PPO update 1 replayed through the plain engine on the CPU: every '
        f'obs, valid flag, reward and done flag of {cfg.rollout_steps} steps '
        f'and the final states equal ({resets} auto-resets)')
    del traj, start, end1

    # one minibatch of 2,048 rows, card against CPU
    perm = torch.randperm(cfg.rollout_steps * cfg.num_envs * cfg.num_snakes,
                          device=trainer.device)
    full_mb = next(trainer.minibatches(perm))
    mb = Minibatch(*(x[:2048] for x in full_mb))
    total, _, grads = trainer.loss_and_grads(ts.params, mb)
    cpu_trainer = PPOTrainer(config(num_envs=1, rollout_steps=1),
                             device='cpu')
    cpu_total, _, cpu_grads = cpu_trainer.loss_and_grads(
        {k: v.cpu() for k, v in ts.params.items()},
        Minibatch(*(x.cpu() for x in mb)))
    loss_rel = abs(float(total) - float(cpu_total)) / abs(float(cpu_total))
    worst = 0.0
    for name, g, c in zip(ts.params, grads, cpu_grads):
        scale = float(c.abs().max())
        diff = float((g.cpu() - c).abs().max())
        worst = max(worst, diff / (1e-5 + 1e-4 * scale))
        if diff > 1e-5 + 1e-4 * scale:
            raise AssertionError(f'PPO minibatch: gradient of {name} differs '
                                 f'by {diff} (largest magnitude {scale})')
    if loss_rel > 1e-5:
        raise AssertionError(f'PPO minibatch: loss {float(total)} on the '
                             f'card, {float(cpu_total)} on the CPU')
    log(f'one PPO minibatch (2,048 rows) card against CPU: loss '
        f'{float(total)} vs {float(cpu_total)} (relative difference '
        f'{loss_rel:.3g}, limit 1e-5); the gradients use at most '
        f'{worst:.3g} of their tolerance 1e-5 + 1e-4 x max|g|')
    del cpu_trainer, cpu_grads

    # a full checkpoint round trip: one more update from each copy
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as save_dir:
        trainer.config.save_dir = save_dir
        trainer.save_checkpoint(ts, 'smoke', full=True)
        other = PPOTrainer(config(save_dir=save_dir, seed=99), device='cuda')
        ts_other = other.load_checkpoint('smoke', other.init_state(),
                                         full=True)
    # the trainer's rollout graph holds the cuDNN algorithms of its
    # capture: it runs the rollout uncaptured here, the fresh trainer
    # captures its own under deterministic cuDNN
    draws_a = ppo_draws(trainer.env_cfg, cfg.num_envs, cfg.rollout_steps,
                        cfg.update_epochs, trainer.generator, trainer.device)
    ts_a, m_a = trainer.learn(trainer.collect_plain(ts, draws_a),
                              draws_a.perm)
    ts_b, m_b = other.update(ts_other)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = deterministic
    got_a = [float(getattr(m_a, f)) for f in m_a.__dataclass_fields__]
    got_b = [float(getattr(m_b, f)) for f in m_b.__dataclass_fields__]
    if got_a != got_b or not all(torch.equal(ts_a.params[k], ts_b.params[k])
                                 for k in ts_a.params):
        raise AssertionError(f'after a full PPO checkpoint round trip the '
                             f'next update differs: {got_a} vs {got_b}')
    log(f'PPO checkpoint round trip (full) on the card: the next update is '
        f'equal from both, metrics {got_a}')
    del other, ts_other, ts_b

    # times: the bench rows, then profiler windows over 16 rollout steps
    # and over one minibatch update of 32,768 rows
    rows = {}
    for n_envs in (64, 256):
        rows[n_envs] = bench.run_ppo(n_envs, updates=3, device='cuda')
        log(f'ppo bench: {json.dumps(rows[n_envs])} [{smi}]')
    short = PPOTrainer(config(rollout_steps=16), device='cuda')
    held = [short.init_state()]
    short_draws = ppo_draws(short.env_cfg, 256, 16, 4, short.generator,
                            'cuda')

    def rollout_steps():
        held[0] = short.collect(held[0], short_draws)

    rollout_window = profile_device(rollout_steps, 1)
    log_window('profile of 16 PPO rollout steps at 256 envs (and their '
               'GAE)', rollout_window, 16, smi, also=(KERNEL_NAME,))
    state = [ts_a.params, ts_a.opt_state]

    def minibatch_update():
        _, _, g = trainer.loss_and_grads(state[0], full_mb)
        state[0], state[1] = trainer.apply_gradients(state[0], state[1], g)

    mb_window = profile_device(minibatch_update, 1)
    log_window('profile of one PPO minibatch update (32,768 rows, forward, '
               'backward, clip, Adam)', mb_window, 1, smi)
    return {'ppo_launches': launches,
            'ppo_ms_per_update': {n: r['ms_per_update']
                                  for n, r in rows.items()},
            'ppo_rollout_ms': {n: r['rollout_ms'] for n, r in rows.items()},
            'ppo_minibatch_ms': {n: r['minibatch_ms']
                                 for n, r in rows.items()},
            'ppo_env_steps_per_s': {n: r['env_steps_per_s']
                                    for n, r in rows.items()},
            'ppo_rollout_idle_share': rollout_window['idle_share'],
            'ppo_rollout_dtoh_per_step': rollout_window['dtoh'] / 16,
            'ppo_minibatch_idle_share': mb_window['idle_share']}


def fill_rounds(passable, start, cap) -> torch.Tensor:
    """Rounds of dilation each of M boards (M, H, W) needs before its
    count settles (a round adds no cell) or reaches its cap (an int or
    (M,)), that last round included: the data-dependent work of a fill."""
    m = passable.shape[0]
    dev = passable.device
    cap = torch.as_tensor(cap, device=dev).expand(m)
    vis = torch.zeros((m,) + tuple(d + 2 for d in passable.shape[1:]),
                      dtype=torch.bool, device=dev)
    s = start.long()
    vis[torch.arange(m, device=dev), s[:, 0] + 1, s[:, 1] + 1] = True
    inner = vis[:, 1:-1, 1:-1]
    count = torch.ones(m, dtype=torch.int64, device=dev)
    rounds = torch.zeros(m, dtype=torch.int64, device=dev)
    live = cap > 1
    while bool(live.any()):
        inner |= (vis[:, :-2, 1:-1] | vis[:, 2:, 1:-1] | vis[:, 1:-1, :-2]
                  | vis[:, 1:-1, 2:]) & passable
        new = inner.sum((-2, -1))
        rounds += live
        live &= (new < cap) & (new != count)
        count = new
    return rounds


def fill_traffic(passable, start, cap) -> tuple:
    """(bytes, int32 ops) of reachable_count on boards (M, H, W) bool with
    starts (M, 2) int32: each board, start and count moved once; each
    round a board needs (``fill_rounds``) FILL_WORD_OPS on each of its
    32-bit row words."""
    m, h, w = passable.shape
    words = h * -(-w // 32)
    ops = int(fill_rounds(passable, start, cap).sum()) * words * FILL_WORD_OPS
    return m * h * w + m * 2 * 4 + m * 4, ops


def plain_fill_inputs(inputs, limit: int):
    """The plain mask of ``inputs`` (obs, q, dirs, active, claims) with
    what it fills: (its MaskOut, boards (M, H, W), starts (M, 2), the
    plain fill's counts (M,)), from the one call of reachable_count_plain
    inside masked_actions_plain."""
    from marlsnake_torch.ops import safety_mask as SM
    seen, real = [], SM.reachable_count_plain

    def recorder(passable, start, lim):
        space = real(passable, start, lim)
        seen.append((passable, start, space))
        return space

    SM.reachable_count_plain = recorder
    try:
        out = SM.masked_actions_plain(*inputs, limit)
    finally:
        SM.reachable_count_plain = real
    (passable, start, space), = seen
    return (out, passable.reshape((-1,) + passable.shape[-2:]),
            start.reshape(-1, 2), space.reshape(-1))


def mask_traffic(inputs, limit: int) -> tuple:
    """(bytes, int32 ops) of the safety mask of ``inputs``: the obs, the
    other inputs and the four outputs moved once; SCAN_CELL_OPS a cell of
    every snake's obs; the fills of every (snake, move) board at the
    kernel's cap min(limit, length + eat), FILL_WORD_OPS a word a round
    (the kernel skips the boards already vetoed, so this counts more
    fill work than it does)."""
    obs, q, dirs, active, claims = inputs
    e, n, h, w, c = obs.shape
    per_snake = 3 * 4 + 2 * 4 + 1 + 4 + 8 + 8 + 1
    nbytes = (e * n * h * w * c + e * n * per_snake
              + (e * h * w if claims is not None else 0))
    _, boards, starts, _ = plain_fill_inputs(inputs, limit)
    flat = obs.reshape(e * n, h, w, c)
    length = (flat[..., 5:8] == 1).flatten(1).sum(-1)
    rows = torch.arange(e * n, device=obs.device).repeat_interleave(3)
    eat = flat[rows, starts[:, 0].long(), starts[:, 1].long(), 1] == 1
    cap = torch.clamp_max(length.repeat_interleave(3) + eat, limit)
    words = h * -(-w // 32)
    fills = int(fill_rounds(boards, starts, cap).sum()) * words
    return nbytes, SCAN_CELL_OPS * e * n * h * w + fills * FILL_WORD_OPS


def time_fill(label, passable, start, limit: int, smi) -> dict:
    """reachable_count's times at one shape: device_ms from the profiler,
    host_us, call_ms (CUDA events), the plain version's ms, the bound."""
    from marlsnake_torch.ops.floodfill import (reachable_count,
                                               reachable_count_plain)

    def fn():
        return reachable_count(passable, start, limit)

    device_ms = kernel_device_us(fn, FILL_KERNEL_NAME, 100) / 1e3
    blocks = host_us(fn)
    call_ms = event_ms(fn, 200)
    plain_ms = event_ms(lambda: reachable_count_plain(passable, start,
                                                      limit), 10)
    row = bound_row(label, device_ms, blocks, call_ms, plain_ms,
                    fill_traffic(passable, start, limit), smi)
    row['shape'] = list(passable.shape)
    return row


def time_mask(label, inputs, limit: int, smi) -> dict:
    """safety_mask's times at one shape (``inputs``: obs, q, dirs, active,
    claims), as ``time_fill``'s."""
    from marlsnake_torch.ops import safety_mask as SM

    def fn():
        return SM.safety_mask(*inputs, limit)

    device_ms = kernel_device_us(fn, MASK_KERNEL_NAME, 100) / 1e3
    blocks = host_us(fn)
    call_ms = event_ms(fn, 200)
    plain_ms = event_ms(lambda: SM.masked_actions_plain(*inputs, limit), 5)
    row = bound_row(label, device_ms, blocks, call_ms, plain_ms,
                    mask_traffic(inputs, limit), smi)
    row['shape'] = list(inputs[0].shape)
    return row


def max_abs_diff(a, b) -> float:
    """The largest |a - b| of two tensors of one shape (0.0 when empty)."""
    if not a.numel():
        return 0.0
    return (a.cpu().double() - b.cpu().double()).abs().max().item()


def same_mask(got, want, where: str) -> float:
    """Raise unless two MaskOuts are EQUAL, field by field; returns the
    largest difference (0.0)."""
    err = 0.0
    for name, a, b in zip(got._fields, got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f'{where}: {name} is {a.dtype} '
                                 f'{tuple(a.shape)}, plain {b.dtype} '
                                 f'{tuple(b.shape)}')
        err = max(err, max_abs_diff(a, b))
        if not torch.equal(a, b.to(a.device)):
            bad = (a.cpu() != b.cpu()).nonzero()[:5].tolist()
            raise AssertionError(f'{where}: {name} differs at {bad}')
    return err


def mask_rollout(cfg, num_envs: int, steps: int, seed: int, claims=0.0,
                 keep=None):
    """Inputs of the safety mask over ``steps`` steps of envs without
    reset driven by the kernel's own choices (random Q-values, directions
    carried, finished snakes inactive): yields (obs, q, dirs, active,
    claims) each step, claims a random board of density ``claims`` (None
    at 0)."""
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.ops import safety_mask as SM
    env = VectorSnakeEnv(cfg, num_envs, autoreset=False, device='cuda',
                         seed=seed)
    gen = torch.Generator(device='cuda').manual_seed(seed)
    states, obs = env.reset()
    n, h, w = cfg.num_snakes, cfg.height, cfg.width
    dirs = torch.zeros((num_envs, n, 2), dtype=torch.int32, device='cuda')
    done = torch.zeros((num_envs, n), dtype=torch.bool, device='cuda')
    for _ in range(steps):
        q = torch.randn((num_envs, n, 3), generator=gen, device='cuda')
        board = (torch.rand((num_envs, h, w), generator=gen, device='cuda')
                 < claims) if claims else None
        inputs = (obs, q, dirs, ~done, board)
        yield inputs
        out = SM.safety_mask(*inputs)
        states, step = env.step(states, out.act)
        obs, dirs, done = step.obs, out.new_dir, done | step.done


def ptxas_summary(build_log: str) -> dict:
    """Each kernel instance's registers, stack, spills and static shared
    memory from nvcc's ``-Xptxas -v`` report, by name (``masked_actions
    _kernel<1, 1, shared>``: rows a lane, words a row, where the planes
    beyond the deadly ones are); dynamic shared memory is the launch's.
    Empty when the library was built before this run."""
    import re
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r'(masked_actions_kernel|reachable_count_kernel)'
                          r'ILi(\d+)ELi(\d+)E(Lb(\d)E)?', m.group(1))
            name = None if k is None else (
                f'{k.group(1)}<{k.group(2)}, {k.group(3)}'
                + ('' if k.group(4) is None
                   else ', scratch' if k.group(5) == '1' else ', shared')
                + '>')
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            smem = re.search(r'(\d+) bytes smem', line)
            out[name].update(registers=int(m.group(1)),
                             static_smem=int(smem.group(1)) if smem else 0)
    return out


def mask_parity_phase(smi: str) -> dict:
    """Both entries of csrc/safety_mask.cu against their plain versions on
    the card, tolerance 0. reachable_count at the evaluator's 3,072 and the
    battle's 384 boards of 20x20, at 256 of 40x40 and of 11x9 and at 8 of
    216x216, each at limits 1, 7 and 60 and passable densities 0.3, 0.7
    and 0.95 (random starts, some on blocked cells). safety_mask on 8
    steps of envs driven by its own choices at 40x40x8 (64 envs), at N=1
    with a claim board (128 envs of 20x20, one snake each), at E=1
    (20x20x4), at 11x9x3 and at 10 and 11 snakes of 20x20 (30 and 32
    warps a block); on 4 steps of the evaluator's 20x20x4 obs copied to
    an odd cell offset into a larger tensor (base and snake stride 8
    bytes past a multiple of 16) and of the battle's seat 0 (a view of
    the first snake of 128 envs of 20x20x4, with a claim board); then
    once on random cells at the widest instances: 32 snakes of 20x20, 8
    of 216x216 (over 48 KB of shared memory a block) and 12 of 200x200
    (the planes beyond the deadly ones in scratch)."""
    from marlsnake_torch.core.types import EnvConfig
    from marlsnake_torch.ops import safety_mask as SM
    from marlsnake_torch.ops.floodfill import (reachable_count,
                                               reachable_count_plain)

    gen = torch.Generator(device='cuda').manual_seed(60)
    fills, capped, fill_err = 0, 0, 0.0
    for m, h, w in ((3072, 20, 20), (384, 20, 20), (256, 40, 40),
                    (256, 11, 9), (8, 216, 216)):
        for density in (0.3, 0.7, 0.95):
            passable = torch.rand((m, h, w), generator=gen,
                                  device='cuda') < density
            start = torch.stack([
                torch.randint(0, h, (m,), generator=gen, device='cuda'),
                torch.randint(0, w, (m,), generator=gen, device='cuda')], -1)
            for limit in (1, 7, 60):
                got = reachable_count(passable, start, limit)
                want = reachable_count_plain(passable, start, limit)
                fill_err = max(fill_err, max_abs_diff(got, want))
                if not torch.equal(got, want):
                    bad = (got != want).nonzero()[:5].tolist()
                    raise AssertionError(
                        f'reachable_count {m}x{h}x{w} density {density} '
                        f'limit {limit} differs at {bad}')
                fills += m
                capped += int((want == limit).sum())
    # starts off the board: row -1, row h, column -1, column w, row h + 5
    # (each seeds no cell: min(0, limit), as the JAX fill counts it)
    off_board = 0
    m, h, w = 384, 20, 20
    passable = torch.rand((m, h, w), generator=gen, device='cuda') < 0.7
    along = torch.randint(0, h, (m,), generator=gen, device='cuda')
    for row, col in ((-1, None), (h, None), (None, -1), (None, w),
                     (h + 5, None)):
        start = torch.stack([
            along if row is None else torch.full_like(along, row),
            along if col is None else torch.full_like(along, col)], -1)
        for limit in (1, 7, 60):
            got = reachable_count(passable, start, limit)
            want = reachable_count_plain(passable, start, limit)
            fill_err = max(fill_err, max_abs_diff(got, want))
            if not torch.equal(got, want) or bool(want.any()):
                raise AssertionError(
                    f'reachable_count from ({row}, {col}) off the board, '
                    f'limit {limit}: {got[:5].tolist()} against the plain '
                    f'{want[:5].tolist()} (both must be 0)')
            off_board += m
    log(f'reachable_count EQUAL to the plain version on {fills} boards '
        f'({capped} at their cap; 3,072 and 384 of 20x20, 256 of 40x40 and '
        f'11x9, 8 of 216x216; limits 1, 7, 60; densities 0.3, 0.7, 0.95) '
        f'and on {off_board} boards of 20x20 from starts off the board '
        f'(row -1, row 20, column -1, column 20, row 25: all 0)')
    fills += off_board
    cases = (('40x40x8, 64 envs', EnvConfig(height=40, width=40,
                                            num_snakes=8, snake_length=3),
              64, 0.0),
             ('N=1 with a claim board, 128 envs of 20x20',
              EnvConfig(height=20, width=20, num_snakes=1, snake_length=5),
              128, 0.05),
             ('E=1, 20x20x4', EnvConfig(height=20, width=20, num_snakes=4,
                                        snake_length=5), 1, 0.0),
             ('11x9x3, 64 envs', EnvConfig(height=11, width=9, num_snakes=3,
                                           snake_length=3), 64, 0.0),
             ('N=10, 64 envs of 20x20', EnvConfig(
                 height=20, width=20, num_snakes=10, snake_length=3), 64,
              0.0),
             ('N=11, 64 envs of 20x20', EnvConfig(
                 height=20, width=20, num_snakes=11, snake_length=3), 64,
              0.02))
    steps, mask_err = 0, 0.0
    for i, (name, cfg, num_envs, claims) in enumerate(cases):
        for inputs in mask_rollout(cfg, num_envs, 8, seed=61 + i,
                                   claims=claims):
            mask_err = max(mask_err, same_mask(
                SM.safety_mask(*inputs), SM.masked_actions_plain(*inputs),
                f'safety_mask {name}'))
            steps += 1
    # layouts: the obs at an odd cell offset into a larger tensor, and the
    # battle's seat 0 (env stride 4 snakes, snake stride unused, claims)
    layouts = ('odd cell offset, 256 envs of 20x20x4',
               'seat 0 of 128 envs of 20x20x4 with claims')
    cfg = EnvConfig(height=20, width=20, num_snakes=4, snake_length=5)
    for inputs in mask_rollout(cfg, 256, 4, seed=71):
        obs, q, dirs, active, _ = inputs
        e, n, h, w, c = obs.shape
        big = torch.zeros((e, n, h * w + 1, c), dtype=torch.uint8,
                          device='cuda')
        big[:, :, 1:] = obs.reshape(e, n, h * w, c)
        odd = big[:, :, 1:].view(e, n, h, w, c)
        assert odd.data_ptr() % 16 == 8 and odd.stride(1) % 16 == 8
        mask_err = max(mask_err, same_mask(
            SM.safety_mask(odd, q, dirs, active),
            SM.masked_actions_plain(obs, q, dirs, active),
            f'safety_mask {layouts[0]}'))
        steps += 1
    for inputs in mask_rollout(cfg, 128, 4, seed=72, claims=0.05):
        obs, q, dirs, active, board = inputs
        seat0 = (obs[:, :1], q[:, :1], dirs[:, :1], active[:, :1], board)
        mask_err = max(mask_err, same_mask(
            SM.safety_mask(*seat0), SM.masked_actions_plain(*seat0),
            f'safety_mask {layouts[1]}'))
        steps += 1
    # the widest instances: 32 snakes an env, 216x216 boards whose block
    # needs more than 48 KB of shared memory, and 12 snakes of 200x200
    # whose planes beyond the deadly ones go to scratch; random channel
    # values (0-2) in 9-byte cells, so the cells are read a byte at a time
    soups = ((16, 32, 20, 20), (4, 8, 216, 216), (2, 12, 200, 200))
    for e, n, h, w in soups:
        obs = torch.randint(0, 3, (e, n, h, w, 9), generator=gen,
                            device='cuda', dtype=torch.uint8)
        obs[..., 5] = 0
        obs[:, :, torch.randint(0, h, (1,), generator=gen,
                                device='cuda'),
            torch.randint(0, w, (1,), generator=gen, device='cuda'), 5] = 1
        units = torch.tensor([(-1, 0), (0, 1), (1, 0), (0, -1), (0, 0)],
                             dtype=torch.int32, device='cuda')
        inputs = (obs, torch.randn((e, n, 3), generator=gen, device='cuda'),
                  units[torch.randint(0, 5, (e, n), generator=gen,
                                      device='cuda')],
                  torch.rand((e, n), generator=gen, device='cuda') < 0.8,
                  torch.rand((e, h, w), generator=gen, device='cuda') < 0.1)
        mask_err = max(mask_err, same_mask(
            SM.safety_mask(*inputs), SM.masked_actions_plain(*inputs),
            f'safety_mask {e}x{n} of {h}x{w}x9'))
        steps += 1
    log(f'safety_mask EQUAL to the plain version (act, new_dir, next_pos, '
        f'head_exists) on {steps} steps: ' + '; '.join(c[0] for c in cases)
        + '; ' + '; '.join(layouts)
        + '; ' + '; '.join(f'{e} envs x {n} snakes of {h}x{w}x9 random '
                           f'cells' for e, n, h, w in soups))
    return {'reachable_count_boards': fills,
            'reachable_count_capped': capped, 'safety_mask_steps': steps,
            'reachable_count_max_abs_err': fill_err,
            'safety_mask_max_abs_err': mask_err}


def evaluator_phase(smi: str) -> dict:
    """The batched, safety-masked evaluator with the port's DQN at 20x20x4
    (the DQN trainer's env config), 256 envs, 512 steps (the JAX
    defaults): the step entry and the safety mask launched once a step
    run (whole chunks), no call of the plain mask or of any flood fill;
    then the mask on the card against its plain version on the card and
    on the CPU over 16 recorded steps; then the graph of the chunks: the
    step entry holding no env equal to no hold, the graph EQUAL to its
    uncaptured chunks (cuDNN deterministic), ms a step in turns, windows
    of 16 steps both ways; the mask and the flood fill at the main path's
    shapes."""
    from marlsnake_torch.algo.dqn_trainer import DQNConfig
    from marlsnake_torch.algo.evaluator import (build_evaluate_batch,
                                                masked_actions)
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.models.dqn import make_dqn
    from marlsnake_torch.ops import floodfill, step_kernel
    from marlsnake_torch.ops import safety_mask as SM

    cfg = DQNConfig().env_config()
    num_envs, max_steps, n = 256, 512, cfg.num_snakes
    net = make_dqn(cfg, seed=0, device='cuda')
    run = build_evaluate_batch(net, cfg, num_envs, max_steps, 60,
                               device='cuda')
    step_kernel.step.launches = 0
    step_kernel.step_autoreset.launches = 0
    SM.safety_mask.launches = 0
    floodfill.reachable_count.launches = 0
    with PlainMaskCalls() as plain:
        t0 = time.perf_counter()
        res = run(seed=31)
        reward, lifetime = float(res.mean_reward), float(res.mean_lifetime)
        first_s = time.perf_counter() - t0
    launches = step_kernel.step.launches
    auto = step_kernel.step_autoreset.launches
    masks = SM.safety_mask.launches
    fills = floodfill.reachable_count.launches
    # the loop runs whole chunks: the last one runs on after every env is
    # done, its steps holding every env still, and launches as it goes
    ran = chunked(res.steps, run.chunk_steps)
    log(f'evaluator path: {num_envs} envs of {cfg.height}x{cfg.width}x{n}, '
        f'{res.steps} of {max_steps} steps taken, {ran} run in chunks of '
        f'{run.chunk_steps}, in {first_s:.2f} s (with the warm-up and the '
        f'capture), step launches={launches}, step_autoreset launches='
        f'{auto}, safety_mask launches={masks}, reachable_count launches='
        f'{fills}, plain mask calls={plain.calls}; mean reward {reward}, '
        f'mean lifetime {lifetime}; the graph '
        f'{json.dumps(run.captured_loops()[0].stats())}')
    if launches != ran or auto != 0 or masks != ran \
            or fills != 0 or plain.calls:
        raise AssertionError(f'{ran} evaluation steps run but {launches} '
                             f'launches of step, {auto} of step_autoreset, '
                             f'{masks} of safety_mask, {fills} of '
                             f'reachable_count, plain calls {plain.calls}')
    if not (math.isfinite(reward) and math.isfinite(lifetime)
            and 0 < lifetime <= max_steps):
        raise AssertionError('evaluation result not finite or out of range')

    # the mask, card against its plain version on the card and on the CPU,
    # on 16 steps of recorded inputs
    env = VectorSnakeEnv(cfg, num_envs, autoreset=False, device='cuda',
                         seed=33)
    states, obs = env.reset()
    dirs = torch.zeros((num_envs, n, 2), dtype=torch.int32, device='cuda')
    dones = torch.zeros((num_envs, n), dtype=torch.bool, device='cuda')
    vetoed, mask_err, fill_err = 0, 0.0, 0.0
    floodfill.reachable_count.launches = 0
    for t in range(16):
        with torch.no_grad():
            q = net(obs.reshape((-1,) + obs.shape[2:])).view(num_envs, n, -1)
        inputs = (obs, q, dirs, ~dones, None)
        got = SM.safety_mask(*inputs)
        plain_out, boards, starts, plain_space = plain_fill_inputs(inputs, 60)
        mask_err = max(mask_err, same_mask(
            got, plain_out, f'safety_mask against the plain version on the '
                            f'card, step {t}'))
        same_mask(got, SM.masked_actions_plain(
            *(None if x is None else x.cpu() for x in inputs)),
            f'safety_mask against the plain version on the CPU, step {t}')
        # reachable_count's own path: the space of every post-move board
        # of the step, as a user of the entry asks for it
        space = floodfill.reachable_count(boards, starts, 60)
        fill_err = max(fill_err, max_abs_diff(space, plain_space))
        if not torch.equal(space, plain_space):
            raise AssertionError(f'reachable_count differs from the plain '
                                 f'fill of the evaluation step {t}')
        acts, new_dirs = masked_actions(obs, q, dirs, ~dones)
        if not (torch.equal(acts, got.act)
                and torch.equal(new_dirs, got.new_dir)):
            raise AssertionError('masked_actions differs from safety_mask')
        vetoed += int((acts != q.argmax(-1).int()).sum())
        states, out = env.step(states, acts)
        obs, dirs, dones = out.obs, new_dirs, dones | out.done
    fill_launches = floodfill.reachable_count.launches
    log(f'safety_mask on the card EQUAL to its plain version on the card '
        f'and on the CPU on 16 steps of {num_envs} envs x {n} snakes '
        f'({vetoed} choices differ from the unmasked argmax); '
        f'reachable_count over each step\'s {boards.shape[0]} post-move '
        f'boards EQUAL to the plain fill, {fill_launches} launches')
    if fill_launches != 16:
        raise AssertionError(f'reachable_count: 16 calls, {fill_launches} '
                             f'launches')

    # the graph: its first step's hold of no env, the graph against its
    # uncaptured chunks, times in turns, windows of 16 steps both ways
    graph = {'hold_of_none_max_abs_err': hold_of_none_check(cfg, num_envs,
                                                            seed=37)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det = build_evaluate_batch(net, cfg, num_envs, max_steps, 60,
                                   device='cuda')
        det(seed=35)                                  # the capture
        graph['equal'] = graph_equal(
            f'evaluate_batch at {num_envs} envs x {max_steps} steps',
            lambda: det(seed=36), lambda: det.uncaptured(seed=36),
            det.buffers, smi)
        graph['deterministic_capture'] = det.captured_loops()[0].stats()
        del det
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def played(fn):
        def go():
            r = fn(seed=32)
            float(r.mean_reward)
            return r.steps, chunked(r.steps, run.chunk_steps)
        return go

    graph['turns'] = in_turns(
        f'evaluate_batch at {num_envs} envs x {max_steps} steps',
        {'graph': played(run), 'uncaptured': played(run.uncaptured)}, smi)
    ms_per_step = graph['turns']['graph_ms_per_step'][-1]
    short = build_evaluate_batch(net, cfg, num_envs, 16, 60, device='cuda')
    graph['windows'] = {
        name: loop_window(f'evaluation ({name}, {num_envs} envs)',
                          lambda fn=fn: fn(seed=34), 16, smi)
        for name, fn in (('graph', short), ('uncaptured', short.uncaptured))}
    window = graph['windows']['graph']
    graph['capture'] = run.captured_loops()[0].stats()
    graph['capture_16_steps'] = short.captured_loops()[0].stats()
    log(f'evaluator graph: {json.dumps(graph)} [{smi}]')
    mask_row = time_mask(f'safety_mask at the evaluator\'s E={num_envs}, '
                         f'N={n}, 20x20', inputs, 60, smi)
    fill_row = time_fill(f'reachable_count at the evaluator\'s '
                         f'{boards.shape[0]} boards of 20x20, limit 60',
                         boards, starts, 60, smi)
    return {'evaluator_launches': launches,
            'evaluator_mask_launches': masks,
            'fill_launches': fill_launches,
            'mask_max_abs_err': mask_err,
            'fill_max_abs_err': fill_err,
            'evaluator_steps': res.steps,
            'evaluator_steps_run': ran,
            'evaluator_ms_per_step': ms_per_step,
            'evaluator_window': window,
            'evaluator_graph': graph,
            'mask_evaluator': mask_row,
            'fill_evaluator': fill_row}


def window_summary(window, steps: int) -> dict:
    """A profiler window's numbers a step
    (``marlsnake_torch.utils.profiling.per_step``)."""
    from marlsnake_torch.utils.profiling import per_step
    return per_step(window, steps)


def loop_snapshot(buffers) -> dict:
    """Clones of every tensor a chunked loop's buffers hold, by field (its
    ``StaticEnvs``' every state and output field: not the arena's bytes,
    whose alignment padding no step writes)."""
    from marlsnake_torch.utils.cuda_graph import clone_tree
    out = {}
    for name in buffers.__dataclass_fields__:
        value = getattr(buffers, name)
        if hasattr(value, 'arena'):
            value = dict(list(value.state.fields()) + list(value.out.fields()))
        if not callable(value) or isinstance(value, torch.Tensor):
            out[name] = clone_tree(value)
    return out


def hold_of_none_check(cfg, num_envs: int, seed: int) -> float:
    """The chunks' first step holds with no env's flag set: on the card,
    field for field the step without a hold (tolerance 0), at the loop's
    shape, 8 steps of random actions from a reset."""
    from marlsnake_torch.core import engine
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import reset_draws
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    envs = step_kernel.StaticEnvs(cfg, num_envs, 'cuda')
    state, obs = engine.reset(cfg, engine.spawn_tables(cfg, 'cuda'),
                              reset_draws(cfg, num_envs, gen, 'cuda'))
    envs.load(state)
    envs.out.obs.copy_(obs)
    none = torch.zeros(num_envs, dtype=torch.bool, device='cuda')
    err = 0.0
    for t in range(8):
        actions = torch.randint(0, 3, (num_envs, cfg.num_snakes),
                                generator=gen, device='cuda',
                                dtype=torch.int32)
        fruit = torch.rand((num_envs, cfg.num_snakes), generator=gen,
                           device='cuda')
        want = step_kernel.step(cfg, envs.state, actions, fruit)
        got = step_kernel.step(cfg, envs.state, actions, fruit,
                               hold=(none, envs.out))
        err = max(err, compare(got, want, f'a hold of no env at B='
                                          f'{num_envs}, step {t}'))
        envs.store(*want)
    return err


def graph_equal(label, run_graph, run_plain, buffers, smi) -> dict:
    """A chunked loop's graph against its uncaptured chunks, cuDNN
    deterministic, tolerance 0: ``run_graph()`` (a replay, the capture
    made before) and ``run_plain()`` from the same inputs return equal
    results, and the loop's ``buffers`` end equal, field for field.
    Returns {'max_abs_err': 0.0, ...} or raises."""
    got = run_graph()
    got_bufs = loop_snapshot(buffers)
    want = run_plain()
    want_bufs = loop_snapshot(buffers)
    same_tree(got, want, f'{label}: the result of the graph against its '
                         f'uncaptured chunks')
    same_tree(got_bufs, want_bufs, f'{label}: the buffers of the graph '
                                   f'against its uncaptured chunks')
    log(f'{label}: the graph EQUAL to its uncaptured chunks (result and '
        f'every buffer, cuDNN deterministic, tolerance 0) [{smi}]')
    return {'max_abs_err': 0.0, 'fields': sorted(got_bufs)}


def in_turns(label, runs: dict, smi) -> dict:
    """ms a step of the graph and of the uncaptured chunks in turns
    (graph, uncaptured, uncaptured, graph; host clock):
    ``runs[name]()`` plays the loop once and returns (steps taken, steps
    run). The graph must have been captured before."""
    out = {'graph': [], 'uncaptured': []}
    steps = {}
    for name in ('graph', 'uncaptured', 'uncaptured', 'graph'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        taken, ran = runs[name]()
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) / taken * 1e3)
        steps[name] = (taken, ran)
    row = {'graph_ms_per_step': out['graph'],
           'uncaptured_ms_per_step': out['uncaptured'],
           'steps_taken_and_run': steps['graph']}
    log(f'{label}: ms a step taken (host clock, in turns G U U G): '
        f'{json.dumps(row)} [{smi}]')
    return row


def loop_window(label, fn, steps: int, smi,
                also=(STEP_KERNEL_NAME, MASK_KERNEL_NAME)) -> dict:
    """A profiler window of ``fn()``, which runs ``steps`` steps of a
    loop: a step's device busy us, idle share, device events, graph and
    kernel launches from the host and read-backs, and the device us a
    launch and the launches of each kernel whose name holds one of
    ``also``."""
    w = profile_device(fn, 1)
    log_window(f'profile of {steps} {label} steps', w, steps, smi,
               also=also)
    mine = {k: v for k, v in w['kernels'].items()
            if any(a in k for a in also)}
    return {'busy_us_per_step': w['busy_us'] / steps,
            'wall_us_per_step': w['wall_us'] / steps,
            'idle_share': w['idle_share'],
            'device_events_per_step': sum(
                v[1] for v in w['kernels'].values()) / steps,
            'graph_launches_per_step': w['graph_launches'] / steps,
            'kernel_launches_per_step': w['kernel_launches'] / steps,
            'read_backs_per_step': w['dtoh'] / steps,
            'kernel_us_per_launch': {k: v[0] / v[1] for k, v in mine.items()},
            'kernel_launches_in_window': {k: v[1] for k, v in mine.items()}}


def chunked(steps: int, chunk: int) -> int:
    """The steps a chunked loop runs when it ends after ``steps``: whole
    chunks, the last one running on past the end."""
    return -(-steps // chunk) * chunk


def top_block(values: torch.Tensor):
    """(where each decision's values equal its maximum, the gap from that
    maximum to the largest value below it): argmax takes the block's first
    index, so two sides take the same action where their blocks agree and
    the gap exceeds their difference. Exact ties (the relu head's zeros, a
    saturated sigmoid) form one block."""
    top = values.max(-1, keepdim=True).values
    block = values == top
    below = values.masked_fill(block, float('-inf')).max(-1).values
    return block, top[..., 0] - below


def mutated_genomes(N, cfg, seed_genome, size: int, seed: int):
    """The seed genome and ``size - 1`` mutants: hidden nodes and
    connections added, activations flipped to sigmoid or tanh, weights
    perturbed (NEAT's own operators)."""
    import random
    genomes = [seed_genome]
    next_key = [cfg.num_outputs + 1000]
    rng = random.Random(seed)
    for gi in range(1, size):
        g = seed_genome.copy(gi)
        for _ in range(1 + gi % 4):
            g._mutate_add_node(cfg, rng, next_key)
            g._mutate_add_conn(cfg, rng)
        for nk in list(g.nodes):
            if rng.random() < 0.4:
                g.nodes[nk].activation = rng.choice(('sigmoid', 'tanh',
                                                     'relu'))
        g.mutate(cfg, rng, next_key)
        genomes.append(g)
    return genomes


def episode_card_vs_cpu(trainer, cpu_trainer, genomes, draws) -> dict:
    """One fitness episode of ``genomes`` through the trainers' own
    episode loop on the card and on the CPU, with the same weights and
    draws (``draws`` on the CPU, one env). Per genome, while its
    trajectory has not parted: every decision more than 1e-4 from a tie
    must be equal on both sides; a near-tie that flips parts it. Returns
    of genomes never parted must be EQUAL."""
    from marlsnake_torch.algo.neat_hybrid import PaddedNetBatch, _Head
    from marlsnake_torch.rng import EpisodeDraws, ResetDraws

    cfg = trainer.neat_cfg
    pop = len(genomes)
    rows = torch.zeros(pop, dtype=torch.long)
    sides = {}
    for tr, dev in ((trainer, 'cuda'), (cpu_trainer, 'cpu')):
        batch = PaddedNetBatch(genomes, cfg, device=dev)
        values = []

        def act(tensors, emb, batch=batch, values=values):
            v = batch.logits(emb)
            values.append(v.cpu())
            return v.argmax(-1).to(torch.int32)

        d = draws.take(rows)
        d = EpisodeDraws(ResetDraws(*(x.to(dev) for x in d.reset)),
                         d.fruit_u.to(dev))
        # the head reads its values back every step: the chunks run
        # uncaptured (the values of a chunk's tail steps are recorded too)
        captured, tr.captured = tr.captured, False
        try:
            ret = tr._episode(_Head(('recorded',), batch.tensors, act), d)
        finally:
            tr.captured = captured
        sides[dev] = (ret, values)
    (ret_g, val_g), (ret_c, val_c) = sides['cuda'], sides['cpu']
    parted = torch.zeros(pop, dtype=torch.bool)
    compared = near = 0
    for t in range(min(len(val_g), len(val_c))):
        block_c, margin = top_block(val_c[t])
        block_g, _ = top_block(val_g[t])
        act_g, act_c = val_g[t].argmax(-1), val_c[t].argmax(-1)
        clear = (margin > 1e-4) & (block_c == block_g).all(-1)
        live = ~parted[:, None].expand_as(clear)
        if bool((live & clear & (act_g != act_c)).any()):
            raise AssertionError(f'fitness episode: a decision more than '
                                 f'1e-4 from a tie differs at step {t}')
        compared += int((live & clear).sum())
        near += int((live & ~clear).sum())
        parted |= (live & ~clear & (act_g != act_c)).any(-1)
    if len(val_g) != len(val_c) and not bool(parted.any()):
        raise AssertionError('fitness episode: lengths differ but no '
                             'decision flipped')
    kept = ~parted
    if not np.array_equal(ret_g[kept.numpy()], ret_c[kept.numpy()]):
        raise AssertionError('fitness episode: returns of genomes whose '
                             'every decision agreed differ')
    return {'steps': [len(val_g), len(val_c)], 'decisions_compared': compared,
            'near_ties': near, 'genomes_parted': int(parted.sum())}


def evolution_phase(smi: str, tmp: str) -> dict:
    """NEAT and ES over the reference-width DQN at full width (20x20,
    4 snakes of length 5, DEFAULT_REWARD, 512-step episodes; float32, TF32
    off): HybridNEATTrainer at NeatConfig()'s pop 100 for 3 generations
    (the first speciation gives every genome a species of its own, so
    generation 1 is 100 elites and generation 2 the first with mutants),
    HeadESTrainer at pop 128 with 4 fitness and 8 validation episodes for
    2 generations; the step entry's launches equal the env steps taken
    (the counters set to 0 before each run, read after); common random
    numbers, checkpoints, a fitness episode and the sweeps card against
    CPU; times of each generation's parts and a profiler window of 16
    fitness steps of each trainer."""
    import copy
    from marlsnake_torch.algo import neat as N
    from marlsnake_torch.algo import neat_hybrid as H
    from marlsnake_torch.models.dqn import make_dqn
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import episode_draws

    env_cfg = H._default_env_cfg()
    net = make_dqn(env_cfg, seed=0, device='cuda')
    neat_cfg = N.NeatConfig()
    if (neat_cfg.pop_size, neat_cfg.num_inputs, env_cfg.height,
            env_cfg.num_snakes, env_cfg.snake_length) != (100, 128, 20, 4, 5):
        raise AssertionError('the NEAT defaults moved')
    tr = H.HybridNEATTrainer(net, env_cfg, neat_cfg, episode_steps=512,
                             result_file=os.path.join(tmp, 'neat.pkl'),
                             seed=0, device='cuda')
    gens = []
    inner = tr.eval_genomes
    # speciation and reproduction: from the end of one evaluation to the
    # start of the next, or of the return
    repro = {'s': 0.0, 'end': None}

    def eval_genomes(genomes, cfg, *args):
        before, steps = dict(tr.seconds), tr.env_steps
        t0 = time.perf_counter()
        if repro['end'] is not None:
            repro['s'] += t0 - repro['end']
        inner(genomes, cfg, *args)
        torch.cuda.synchronize()
        repro['end'] = time.perf_counter()
        gens.append({'eval_s': repro['end'] - t0,
                     'steps': tr.env_steps - steps,
                     'genomes': [g for _, g in genomes],
                     **{k: v - before.get(k, 0.0)
                        for k, v in tr.seconds.items()}})

    tr.eval_genomes = eval_genomes
    step_kernel.step.launches = 0
    step_kernel.step_autoreset.launches = 0
    t0 = time.perf_counter()
    best = tr.run(num_generations=3, verbose=True)
    torch.cuda.synchronize()
    repro['s'] += time.perf_counter() - repro['end']
    wall = time.perf_counter() - t0
    launches = step_kernel.step.launches
    auto = step_kernel.step_autoreset.launches
    neat_steps = tr.env_steps
    log(f'NEAT path: 3 generations of {neat_cfg.pop_size} genomes, '
        f'{neat_steps} env steps, step launches={launches}, '
        f'step_autoreset launches={auto}, best fitness {best.fitness}, '
        f'{wall:.2f} s (with the warm-up)')
    if launches != neat_steps or auto != 0 or neat_steps == 0:
        raise AssertionError(f'NEAT: {neat_steps} env steps but '
                             f'{launches} launches of step and {auto} of '
                             f'step_autoreset')
    neat_gens = [dict({k: rec.get(k, 0.0) * 1e3 for k in (
        'eval_s', 'episodes', 'batch_build', 'checkpoint')},
        steps=rec['steps']) for rec in gens]
    # speciation and reproduction follow each generation's evaluation
    repro_total = repro['s']
    hidden = [sum(1 for k in g.nodes if k not in neat_cfg.output_keys)
              for g in gens[-1]['genomes']]
    gen1 = H.PaddedNetBatch(gens[-1]['genomes'], neat_cfg, device='cuda')
    log(f'NEAT generations (ms: eval_genomes, its episodes, PaddedNetBatch '
        f'builds, checkpoint writes; env steps): {json.dumps(neat_gens)}; '
        f'speciation '
        f'and reproduction {repro_total * 1e3:.1f} ms over all three; '
        f'{tr.calls.get("checkpoint", 0)} checkpoint writes; generation 2: '
        f'{sum(h > 0 for h in hidden)} genomes with hidden nodes (up to '
        f'{max(hidden)}), batch m={gen1.m} sweeps={gen1.num_sweeps} [{smi}]')
    if max(hidden) == 0:
        raise AssertionError('generation 2 has no mutated topology')

    # the result checkpoint loads, and its net is its genome
    data = H.load_hybrid_raw(tr.result_file)
    saved = data['neat_genome']
    if saved.fitness != tr.best_fitness or data['neat_config'] != neat_cfg:
        raise AssertionError('the NEAT result file does not hold the best '
                             'genome')
    ffn = N.FeedForwardNetwork.create(saved, data['neat_config'])
    emb = torch.randn((1, 4, 128), generator=torch.Generator().manual_seed(
        3)) * 2
    want = torch.tensor([ffn.activate(e.tolist()) for e in emb[0]])
    got = H.PaddedNetBatch([saved], neat_cfg, device='cuda').logits(
        emb.cuda())[0].cpu()
    if not torch.allclose(got, want.to(got.dtype), rtol=1e-5, atol=1e-5):
        raise AssertionError('the saved genome\'s net differs from its '
                             'padded sweeps')
    for name, arr in H.dqn_from_flax(data['dqn_params'],
                                     (20, 20)).items():
        if not torch.equal(arr, net.state_dict()[name].cpu()):
            raise AssertionError(f'the saved dqn_params differ at {name}')

    # common random numbers: four clones of the seed genome
    tr.result_file = os.path.join(tmp, 'clones.pkl')
    seed_genome = H.fc3_to_genome(net, neat_cfg)
    clones = [(i, copy.deepcopy(seed_genome)) for i in range(4)]
    tr.eval_genomes = inner
    inner(clones, neat_cfg)
    clone_fits = [g.fitness for _, g in clones]
    if len(set(clone_fits)) != 1:
        raise AssertionError(f'clones scored {clone_fits}')
    log(f'NEAT result file loads (fitness {saved.fitness}); its net equals '
        f'its padded sweeps; dqn_params equal the DQN; four clones of the '
        f'seed genome score {clone_fits[0]} each')

    # one fitness episode of 8 genomes, card against CPU
    cpu_tr = H.HybridNEATTrainer(
        {k: v.cpu() for k, v in net.state_dict().items()}, env_cfg,
        neat_cfg, episode_steps=512, result_file=os.path.join(tmp, 'c.pkl'),
        device='cpu')
    eight = mutated_genomes(N, neat_cfg, seed_genome, 8, seed=4)
    d8 = episode_draws(env_cfg, 1, 512, torch.Generator().manual_seed(5),
                       'cpu')
    t0 = time.perf_counter()
    episode_check = episode_card_vs_cpu(tr, cpu_tr, eight, d8)
    log(f'one fitness episode of 8 genomes (the seed and mutants with '
        f'hidden sigmoid/tanh nodes) card against CPU: '
        f'{json.dumps(episode_check)}, decisions more than 1e-4 from a tie '
        f'equal, returns of unparted genomes equal '
        f'({time.perf_counter() - t0:.1f} s)')
    del cpu_tr

    # sweep_values at pop 100 (generation 2's topologies), card vs CPU
    gen1_cpu = H.PaddedNetBatch(gens[-1]['genomes'], neat_cfg, device='cpu')
    emb = torch.randn((100, 4, 128), generator=torch.Generator().manual_seed(
        6)) * 2
    got, want = gen1.logits(emb.cuda()).cpu(), gen1_cpu.logits(emb)
    sweep_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f'sweep_values at pop 100: card against CPU '
                             f'max abs difference {sweep_err}')
    log(f'sweep_values at pop 100 (m={gen1.m}, {gen1.num_sweeps} sweeps) '
        f'card against CPU: max abs difference {sweep_err} (limit 1e-5 + '
        f'1e-5 x |value|)')

    # --- ES at full width ---
    def es_trainer(result):
        return H.HeadESTrainer(net, env_cfg, episode_steps=512, pop_size=128,
                               fitness_episodes=4, seed=0,
                               result_file=os.path.join(tmp, result),
                               device='cuda')

    es = es_trainer('es.pkl')
    step_kernel.step.launches = 0
    step_kernel.step_autoreset.launches = 0
    t0 = time.perf_counter()
    best_theta, best_val, hist = es.run(num_generations=2, val_episodes=8)
    torch.cuda.synchronize()
    es_wall = time.perf_counter() - t0
    es_launches = step_kernel.step.launches
    auto = step_kernel.step_autoreset.launches
    es_steps = es.env_steps
    # fitness episodes at B=129, validation at B=8
    es_launch = {str(k): v for k, v in es.env_steps_by_width.items()}
    log(f'ES path: 2 generations of {es.pop_size} + 1 members, '
        f'{es_steps} env steps, step launches={es_launches} (env steps by '
        f'width: {json.dumps(es_launch)}), step_autoreset '
        f'launches={auto}, {es_wall:.2f} s; history {json.dumps(hist)}')
    if es_launches != es_steps or auto != 0 \
            or set(es_launch) != {'129', '8'}:
        raise AssertionError(f'ES: {es_steps} env steps ({es_launch} by '
                             f'width) but {es_launches} launches of step, '
                             f'{auto} of step_autoreset')
    es_times = {k: es.seconds[k] * 1e3
                for k in ('fitness', 'validation', 'checkpoint')}
    log(f'ES times over 2 generations (ms; validation includes the seed\'s '
        f'before generation 0): {json.dumps(es_times)}; the rest of the '
        f'wall (ranks, update, host) '
        f'{(es_wall * 1e3 - sum(es_times.values())):.1f} ms [{smi}]')
    ma, mb, dmean, dstd = es.holdout_compare(es._seed_theta, es._seed_theta,
                                             episodes=8, block=8)
    if not (ma == mb and dmean == 0.0 and dstd == 0.0):
        raise AssertionError(f'holdout_compare(seed, seed) = '
                             f'{(ma, mb, dmean, dstd)}')
    twin = es_trainer('es_twin.pkl')
    twin_hist = twin.run(num_generations=1, verbose=False, val_episodes=8)[2]
    if twin_hist[0]['theta_fitness'] != hist[0]['theta_fitness']:
        raise AssertionError(f'two ES trainers of one seed: theta_fitness '
                             f'{twin_hist[0]["theta_fitness"]} vs '
                             f'{hist[0]["theta_fitness"]}')
    log(f'ES: holdout_compare(seed, seed) over 8 episodes = '
        f'{(ma, mb, dmean, dstd)}; a second trainer of the same seed gives '
        f'theta_fitness {twin_hist[0]["theta_fitness"]} in generation 0')

    # times: profiler windows of at least 16 fitness steps
    windows = {}
    for label, runner in (
            ('neat', lambda t: t._episode(H.neat_head(gen1), t._draws(
                1).take(torch.zeros(100, dtype=torch.long)))),
            ('es', lambda t: t._run(
                *es._member_batch(es._seed_theta,
                                  torch.zeros((64, 128, 3), device='cuda'),
                                  torch.zeros((64, 3), device='cuda')),
                t._draws(1).take(torch.zeros(129, dtype=torch.long))))):
        short = (H.HybridNEATTrainer if label == 'neat' else H.HeadESTrainer)(
            net, env_cfg, episode_steps=16, device='cuda',
            result_file=os.path.join(tmp, 'short.pkl'))
        counts = []

        def fitness_steps(short=short, runner=runner, counts=counts):
            # whole episodes (reset included) until 16 steps are taken
            before = short.env_steps
            while short.env_steps - before < 16:
                runner(short)
            counts.append(short.env_steps - before)

        window = profile_device(fitness_steps, 1)
        steps = counts[-1]
        windows[label] = dict(window, steps=steps)
        log_window(f'profile of {steps} fitness steps [{label}]', window,
                   steps, smi, also=(STEP_KERNEL_NAME,))
    # host clock, after generation 0 (which holds the first calls' set-up)
    fitness_ms = {'neat': sum(g.get('episodes', 0.0) for g in gens[1:])
                  * 1e3 / max(sum(g['steps'] for g in gens[1:]), 1),
                  'es': es.seconds['fitness'] * 1e3
                  / max(es_launch['129'], 1),
                  'neat_window': windows['neat']['wall_us'] / 1e3
                  / windows['neat']['steps'],
                  'es_window': windows['es']['wall_us'] / 1e3
                  / windows['es']['steps']}
    log(f'ms per fitness step (host clock: NEAT generations 1-2, ES fitness '
        f'episodes, and the profiled windows with their resets): '
        f'{json.dumps(fitness_ms)}; launches of step a fitness step: '
        f'{(launches + es_launches) / (neat_steps + es_steps)} [{smi}]')
    return {
        'neat_launches': launches, 'neat_env_steps': neat_steps,
        'neat_ms_by_generation': neat_gens,
        'neat_reproduction_ms_three_generations': repro_total * 1e3,
        'neat_checkpoint_writes': tr.calls.get('checkpoint', 0),
        'es_launches': es_launches,
        'es_launches_by_width': es_launch,
        'es_ms_two_generations': es_times, 'es_wall_ms': es_wall * 1e3,
        'fitness_ms_per_step': fitness_ms,
        'fitness_launches_per_step': (launches + es_launches)
        / (neat_steps + es_steps),
        'fitness_window': {k: {'busy_us_per_step': w['busy_us'] / w['steps'],
                               'idle_share': w['idle_share'],
                               'dtoh_per_step': w['dtoh'] / w['steps']}
                           for k, w in windows.items()},
        'fitness_episode_card_vs_cpu': episode_check,
        'sweep_max_abs_err': sweep_err}


class CallCounter:
    """Counts the calls of module functions while active (``targets()``,
    (module, name) pairs): ``calls`` is their total."""

    def targets(self):
        raise NotImplementedError

    def __enter__(self):
        self.saved, self.calls = [], 0
        for mod, name in self.targets():
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def counted(*args, _fn=fn, **kwargs):
                self.calls += 1
                return _fn(*args, **kwargs)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class PlainEngineCalls(CallCounter):
    """Counts calls of the plain engine's steps (engine.step and
    engine.step_autoreset) while active: on the card every step must be a
    launch of the kernel."""

    def targets(self):
        from marlsnake_torch.core import engine
        return ((engine, 'step'), (engine, 'step_autoreset'))


class PlainMaskCalls(CallCounter):
    """Counts calls of the plain mask and of both plain flood fills while
    active: on the card every masked step must be one launch of the safety
    mask kernel."""

    def targets(self):
        from marlsnake_torch.ops import floodfill, safety_mask
        return ((safety_mask, 'masked_actions_plain'),
                (safety_mask, '_snake_moves'),
                (safety_mask, 'reachable_count_plain'),
                (floodfill, 'reachable_count_plain'))


def adapter_phase(smi: str, tmp: str) -> dict:
    """The wrapper layer on the card: make('Snake-v1') at 20x20x4 plays a
    random episode to its end (one step launch at B=1 a step, no call of
    the plain engine, the last step EQUAL to it); make_snake(num_envs=8)
    (one auto-reset launch a step; the auto-reset entry against the plain
    engine at B=8); DQNEvaluator over 2 episodes; render_winner on the NEAT
    phase's checkpoint; the step entry against engine.step at B=1, B=100
    and B=129."""
    from marlsnake_torch.algo.evaluator import DQNEvaluator
    from marlsnake_torch.algo.neat_hybrid import _default_env_cfg, render_winner
    from marlsnake_torch.core import engine
    from marlsnake_torch.envs.env import SnakeEnv
    from marlsnake_torch.envs.wrappers import GymAdapter, make, make_snake
    from marlsnake_torch.models.dqn import make_dqn
    from marlsnake_torch.ops import safety_mask as SM
    from marlsnake_torch.ops import step_kernel

    env = make('Snake-v1', device='cuda', seed=0)
    cfg = env.cfg
    gen = torch.Generator().manual_seed(40)
    obs = env.reset()
    step_kernel.step.launches = 0
    step_kernel.step_autoreset.launches = 0
    steps = 0
    t0 = time.perf_counter()
    with PlainEngineCalls() as plain:
        dones = [False]
        while not all(dones):
            acts = torch.randint(0, 3, (cfg.num_snakes,), generator=gen)
            before = (env.state, env.env.generator.get_state(), acts)
            obs, rews, dones, info = env.step(acts.tolist())
            steps += 1
            if steps > cfg.max_episode_steps:
                raise AssertionError('the adapter episode did not end')
    wall = time.perf_counter() - t0
    launches = step_kernel.step.launches
    if launches != steps or plain.calls != 0 \
            or step_kernel.step_autoreset.launches != 0:
        raise AssertionError(f'GymAdapter: {steps} steps, {launches} step '
                             f'launches, {plain.calls} plain-engine calls')
    if 'rank' not in info or sorted(info['rank'])[0] != 1:
        raise AssertionError(f'GymAdapter: no rank at the end: {info}')
    state, gstate, acts = before
    g2 = torch.Generator(device='cuda')
    g2.set_state(gstate)
    fruit_u = torch.rand((1, cfg.num_snakes), generator=g2, device='cuda')
    want_state, want_out = engine.step(cfg, state, acts.view(1, -1).cuda(),
                                       fruit_u)
    compare((env.state,), (want_state,), 'GymAdapter last step')
    for name, got in (('obs', obs), ('reward', np.asarray(rews, np.float32)),
                      ('done', np.asarray(dones))):
        if not np.array_equal(got, getattr(want_out, name)[0].cpu().numpy()):
            raise AssertionError(f'GymAdapter last step: {name} differs')
    log(f'GymAdapter (make Snake-v1, 20x20x4): a random episode of {steps} '
        f'steps, {launches} step launches at B=1, 0 plain-engine calls, '
        f'last step equal to engine.step, rank {info["rank"]}; '
        f'{wall / steps * 1e3:.3f} ms a step [{smi}]')

    venv, obs_shape, _, _ = make_snake(num_envs=8, device='cuda', seed=1)
    obs = venv.reset()
    step_kernel.step_autoreset.launches = 0
    step_kernel.step.launches = 0
    for _ in range(64):
        obs, rews, dones, info = venv.step(torch.randint(
            0, 3, (8, 4), generator=gen).numpy())
    vlaunches = step_kernel.step_autoreset.launches
    if vlaunches != 64 or step_kernel.step.launches != 0 \
            or obs.shape != obs_shape:
        raise AssertionError(f'make_snake(num_envs=8): 64 steps, '
                             f'{vlaunches} step_autoreset launches')
    log(f'make_snake(num_envs=8): 64 steps, {vlaunches} step_autoreset '
        f'launches, obs {obs.shape}')
    # the auto-reset entry at the VectorAdapter's width and config
    err_auto = parity(venv.cfg, 8, 64, seed=43)

    net = make_dqn(cfg, seed=0, device='cuda')
    evaluator = DQNEvaluator(GymAdapter(SnakeEnv(cfg, device='cuda'), seed=2),
                             net)
    step_kernel.step.launches = 0
    SM.safety_mask.launches = 0
    t0 = time.perf_counter()
    with PlainEngineCalls() as plain, PlainMaskCalls() as plain_mask:
        reward, life = evaluator.evaluate(num_episodes=2, max_steps=256,
                                          verbose=False)
    ev_wall = time.perf_counter() - t0
    ev_launches = step_kernel.step.launches
    ev_masks = SM.safety_mask.launches
    if not (math.isfinite(reward) and 0 < life <= 256) or ev_launches == 0 \
            or plain.calls != 0 or ev_masks != ev_launches \
            or plain_mask.calls != 0:
        raise AssertionError(f'DQNEvaluator: reward {reward}, lifetime '
                             f'{life}, {ev_launches} launches, {ev_masks} '
                             f'safety_mask launches, {plain_mask.calls} '
                             f'plain mask calls')
    ev_ms = ev_wall / ev_launches * 1e3
    window = profile_device(lambda: evaluator.evaluate(
        num_episodes=1, max_steps=16, verbose=False), 1)
    log(f'DQNEvaluator: 2 episodes, {ev_launches} steps (step launches at '
        f'B=1), {ev_masks} safety_mask launches at E=1, N=4, no plain mask '
        f'call, mean reward {reward}, mean lifetime {life}; {ev_ms:.3f} ms '
        f'a step (host clock, with the warm-up) [{smi}]')
    log_window('profile of a DQNEvaluator episode of up to 16 steps (reset '
               'included)', window, 16, smi,
               also=(STEP_KERNEL_NAME, MASK_KERNEL_NAME))
    dqn_inputs = next(
        inputs for t, inputs in enumerate(mask_rollout(cfg, 1, 8, seed=45))
        if t == 7)
    mask_row = time_mask('safety_mask at DQNEvaluator\'s E=1, N=4, 20x20',
                         dqn_inputs, 60, smi)

    step_kernel.step.launches = 0
    rew, rlife = render_winner(os.path.join(tmp, 'neat.pkl'), render=False,
                               episodes=1, max_steps=128, device='cuda')
    rw_launches = step_kernel.step.launches
    if not math.isfinite(rew) or rw_launches == 0:
        raise AssertionError('render_winner did not play')
    log(f'render_winner on the NEAT checkpoint: mean reward {rew}, mean '
        f'lifetime {rlife}, {rw_launches} step launches')

    ncfg = _default_env_cfg()
    # the step entry at the widths of GymAdapter (1), NEAT (100), ES (129)
    err = max(parity_step(ncfg, 1, 256, seed=41),
              parity_step(ncfg, 100, 64, seed=44),
              parity_step(ncfg, 129, 64, seed=42))
    return {'gym_adapter_launches': launches,
            'gym_adapter_ms_per_step': wall / steps * 1e3,
            'vector_adapter_launches': vlaunches,
            'dqn_evaluator_launches': ev_launches,
            'dqn_evaluator_mask_launches': ev_masks,
            'dqn_evaluator_ms_per_step': ev_ms,
            'dqn_evaluator_window': window_summary(window, 16),
            'mask_dqn_evaluator': mask_row,
            'render_winner_launches': rw_launches,
            'step_max_abs_err_b1_b100_b129': err,
            'step_autoreset_max_abs_err_b8': err_auto}


def recorded_battle(net, opponents, cfg, num_envs, max_steps, device,
                    draws):
    """``build_battle_batch``'s run with a record of every step: the
    decision values of each seat (seat 0's Q-values, the PPO's logits,
    the NEAT head's output values; None for the greedy seat), the actions
    stepped and the seats done after the step. Returns (rewards,
    lifetimes, record) on the CPU."""
    from marlsnake_torch.algo import battle_batch as BB
    record, pending = [], {}
    real_seat0, real_fns = BB.masked_seat0, BB.build_vector_fns

    def seat0(obs0, q0, dir0, alive0, flood_limit=60):
        pending[0] = q0.cpu()
        return real_seat0(obs0, q0, dir0, alive0, flood_limit)

    def vector_fns(cfg, autoreset=True, device='cuda'):
        reset_fn, step_fn = real_fns(cfg, autoreset, device)

        def step(states, actions, draws, hold=None):
            states, out = step_fn(states, actions, draws, hold=hold)
            record.append({'actions': actions.cpu(), 'done': out.done.cpu(),
                           'values': [pending.pop(i, None)
                                      for i in range(cfg.num_snakes)]})
            return states, out
        return reset_fn, step

    for seat, op in enumerate(opponents, 1):
        if isinstance(op, BB.BatchedPPO):
            def ppo(x, inner=op.net, seat=seat):
                out = inner(x)
                pending[seat] = out[0].cpu()
                return out
            op.net = ppo
        elif isinstance(op, BB.BatchedNEAT):
            def acts(emb, batch=op.batch, seat=seat):
                values = batch.logits(emb)
                pending[seat] = values[0].cpu()
                return values.argmax(-1).to(torch.int32)
            op.batch.acts = acts
    BB.masked_seat0, BB.build_vector_fns = seat0, vector_fns
    try:
        run = BB.build_battle_batch(net, cfg, opponents, num_envs,
                                    max_steps, device=device)
        # the record reads every step back: the chunks run uncaptured
        rew, life = run.uncaptured(draws=draws)
    finally:
        BB.masked_seat0, BB.build_vector_fns = real_seat0, real_fns
    return rew.cpu(), life.cpu(), record


def battle_card_vs_cpu(card, cpu, episodes: int) -> dict:
    """The first ``episodes`` episodes of a recorded battle on the card
    against the same episodes replayed on the CPU (``recorded_battle``
    twice). Per episode, while it has not parted, for every seat alive
    before the step: a decision whose values are more than 1e-4 apart
    pairwise (the greedy seat's always) must be equal on both sides; a
    decision nearer a tie is counted, and parts its episode if it flips.
    Rewards and lifetimes of episodes never parted must be EQUAL."""
    (rew_g, life_g, rec_g), (rew_c, life_c, rec_c) = card, cpu
    k = episodes
    parted = torch.zeros(k, dtype=torch.bool)
    done = torch.zeros_like(rec_c[0]['done'])
    compared = near = 0
    for t in range(min(len(rec_g), len(rec_c))):
        act_g, act_c = rec_g[t]['actions'][:k], rec_c[t]['actions']
        for seat, values in enumerate(rec_c[t]['values']):
            if values is None:
                clear = torch.ones(k, dtype=torch.bool)
            else:
                gaps = (values[:, :, None] - values[:, None, :]).abs()
                gaps = gaps.masked_fill(torch.eye(3, dtype=torch.bool),
                                        float('inf'))
                clear = gaps.flatten(1).min(-1).values > 1e-4
            live = ~parted & ~done[:, seat]
            differ = act_g[:, seat] != act_c[:, seat]
            if bool((live & clear & differ).any()):
                raise AssertionError(f'battle replay: a decision of seat '
                                     f'{seat} more than 1e-4 from a tie '
                                     f'differs at step {t}')
            compared += int((live & clear).sum())
            near += int((live & ~clear).sum())
            parted |= live & ~clear & differ
        done = done | rec_c[t]['done']
    kept = ~parted
    if len(rec_g) != len(rec_c) and bool(kept.all()) \
            and int(life_g[:k].max()) == int(life_g.max()):
        raise AssertionError('battle replay: lengths differ but no '
                             'decision flipped')
    if not (torch.equal(rew_g[:k][kept], rew_c[kept])
            and torch.equal(life_g[:k][kept], life_c[kept])):
        raise AssertionError('battle replay: rewards or lifetimes of '
                             'episodes whose every decision agreed differ')
    return {'episodes': k, 'steps': [len(rec_g), len(rec_c)],
            'decisions_compared': compared, 'near_ties': near,
            'episodes_parted': int(parted.sum())}


def battle_phase(smi: str, tmp: str, ppo_params: dict) -> dict:
    """The battle arenas at full width (the battle CLI's config: 20x20, 4
    snakes of length 5): build_battle_batch with 128 envs for up to 512
    steps, the masked DQN (the reference width, seeded weights) against
    the PPO phase's trained net, the NEAT phase's winner and Greedy; the
    step entry's launches equal the steps run (whole chunks), no
    plain-engine call;
    16 of the episodes replayed on the CPU decision by decision; ms per
    step in turns graph against uncaptured chunks, the graph EQUAL to the
    chunks (cuDNN deterministic), profiler windows of 16 steps both ways
    and the flood fill at the battle's shape. Then the host BattleArena,
    one episode of up to 128 steps at B=1: one step launch a step."""
    import random
    from marlsnake_torch.algo import battle_batch as BB
    from marlsnake_torch.algo.battle import BattleArena
    from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw
    from marlsnake_torch.algo.opponents import (GreedyAgent, NEATAgent,
                                                PPOAgent)
    from marlsnake_torch.core.types import EnvConfig
    from marlsnake_torch.envs.wrappers import make
    from marlsnake_torch.models.dqn import make_dqn
    from marlsnake_torch.models.ppo import ActorCritic
    from marlsnake_torch.ops import floodfill, step_kernel
    from marlsnake_torch.ops import safety_mask as SM
    from marlsnake_torch.rng import BattleDraws, ResetDraws, battle_draws

    cfg = EnvConfig(height=20, width=20, num_snakes=4, snake_length=5)
    num_envs, max_steps, replayed = 128, 512, 16
    data = load_hybrid_raw(os.path.join(tmp, 'neat.pkl'))
    names = ['DQN (Main)', 'PPO', 'Hybrid NEAT', 'Greedy Bot']

    def side(device):
        net = make_dqn(cfg, seed=0, device=device)
        ppo = ActorCritic((20, 20), assume_binary_obs=True, device=device)
        ppo.load_state_dict(ppo_params)
        return net, [BB.BatchedPPO(ppo),
                     BB.BatchedNEAT(data['dqn_params'], data['neat_genome'],
                                    data['neat_config'], cfg, device=device),
                     BB.BatchedGreedy()]

    net, opponents = side('cuda')
    kinds = [op.draws for op in opponents]
    draws = battle_draws(cfg, kinds, num_envs, max_steps,
                         torch.Generator(device='cuda').manual_seed(50),
                         'cuda')
    run = BB.build_battle_batch(net, cfg, opponents, num_envs, max_steps,
                                device='cuda')
    # warm-up: a battle of 4 steps at the same shapes
    BB.build_battle_batch(net, cfg, opponents, num_envs, 4,
                          device='cuda')(seed=49)
    step_kernel.step.launches = 0
    step_kernel.step_autoreset.launches = 0
    SM.safety_mask.launches = 0
    floodfill.reachable_count.launches = 0
    torch.cuda.synchronize()
    with PlainEngineCalls() as plain, PlainMaskCalls() as plain_mask:
        t0 = time.perf_counter()
        rew, life = run(draws=draws)
        rew, life = rew.cpu(), life.cpu()
        wall = time.perf_counter() - t0
    steps = int(life.max())
    launches = step_kernel.step.launches
    auto = step_kernel.step_autoreset.launches
    masks = SM.safety_mask.launches
    fills = floodfill.reachable_count.launches
    # whole chunks: the last one runs on after every env is done
    ran = chunked(steps, run.chunk_steps)
    log(f'battle path (build_battle_batch): {num_envs} envs of 20x20x4, '
        f'{steps} of {max_steps} steps taken, {ran} run in chunks of '
        f'{run.chunk_steps}, step launches={launches}, '
        f'step_autoreset launches={auto}, safety_mask launches={masks}, '
        f'reachable_count launches={fills}, plain-engine calls='
        f'{plain.calls}, plain mask calls={plain_mask.calls}; '
        f'{wall / steps * 1e3:.3f} ms a battle step in its first call '
        f'(host clock, the capture included); the graph '
        f'{json.dumps(run.captured_loops()[0].stats())} [{smi}]')
    if launches != ran or auto != 0 or plain.calls != 0 \
            or masks != ran or fills != 0 or plain_mask.calls != 0:
        raise AssertionError(f'battle: {ran} steps run but {launches} step '
                             f'launches, {auto} step_autoreset launches, '
                             f'{masks} safety_mask launches, {fills} '
                             f'reachable_count launches, {plain.calls} '
                             f'plain-engine calls, {plain_mask.calls} '
                             f'plain mask calls')
    if not (bool(torch.isfinite(rew).all()) and rew.shape == (num_envs, 4)
            and bool((life >= 1).all()) and steps <= max_steps):
        raise AssertionError('battle result not finite or out of range')
    log(BB.summarize(rew, life, names))

    # the same battle recorded, on the card and on the CPU (16 episodes)
    card = recorded_battle(*side('cuda'), cfg, num_envs, max_steps, 'cuda',
                           draws)
    again = run.uncaptured(draws=draws)
    if not (torch.equal(card[0], again[0].cpu())
            and torch.equal(card[1], again[1].cpu())):
        raise AssertionError('battle: two runs of the same draws on the '
                             'card differ')
    few = torch.arange(replayed, device='cuda')
    cpu_draws = BattleDraws(
        ResetDraws(*(x[few].cpu() for x in draws.reset)),
        draws.fruit_u[:, few].cpu(),
        tuple(None if x is None else x[:, few].cpu() for x in draws.seat))
    t0 = time.perf_counter()
    cpu = recorded_battle(*side('cpu'), cfg, replayed, max_steps, 'cpu',
                          cpu_draws)
    replay = battle_card_vs_cpu(card, cpu, replayed)
    log(f'battle: {replayed} episodes replayed on the CPU decision by '
        f'decision: {json.dumps(replay)}; decisions more than 1e-4 from a '
        f'tie equal, rewards and lifetimes of unparted episodes equal '
        f'({time.perf_counter() - t0:.1f} s)')

    # the graph: its first step's hold of no env, the graph against its
    # uncaptured chunks, times in turns, windows of 16 steps both ways
    graph = {'hold_of_none_max_abs_err': hold_of_none_check(cfg, num_envs,
                                                            seed=52)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det = BB.build_battle_batch(net, cfg, opponents, num_envs,
                                    max_steps, device='cuda')
        det(seed=53)                                  # the capture
        graph['equal'] = graph_equal(
            f'build_battle_batch at {num_envs} envs x {max_steps} steps',
            lambda: det(draws=draws), lambda: det.uncaptured(draws=draws),
            det.buffers, smi)
        graph['deterministic_capture'] = det.captured_loops()[0].stats()
        del det
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def played(fn):
        def go():
            _, lives = fn(draws=draws)
            taken = int(lives.max())
            return taken, chunked(taken, run.chunk_steps)
        return go

    graph['turns'] = in_turns(
        f'build_battle_batch at {num_envs} envs x {max_steps} steps',
        {'graph': played(run), 'uncaptured': played(run.uncaptured)}, smi)
    ms_per_step = graph['turns']['graph_ms_per_step'][-1]
    short = BB.build_battle_batch(net, cfg, opponents, num_envs, 16,
                                  device='cuda')
    graph['windows'] = {
        name: loop_window(f'battle ({name}, {num_envs} envs)',
                          lambda fn=fn: fn(seed=51), 16, smi)
        for name, fn in (('graph', short), ('uncaptured', short.uncaptured))}
    window = graph['windows']['graph']
    graph['capture'] = run.captured_loops()[0].stats()
    graph['capture_16_steps'] = short.captured_loops()[0].stats()
    log(f'battle graph: {json.dumps(graph)} [{smi}]')

    # the last step's seat-0 inputs of 16 uncaptured steps, for the times
    # of the mask and the fill
    seat0, kept = BB.masked_seat0, []

    def keep_seat0(obs0, q0, dir0, alive0, flood_limit=60):
        kept[:] = [(obs0[:, None], q0[:, None], dir0[:, None],
                    alive0[:, None], None)]
        return seat0(obs0, q0, dir0, alive0, flood_limit)

    BB.masked_seat0 = keep_seat0
    try:
        short.uncaptured(seed=51)
    finally:
        BB.masked_seat0 = seat0
    inputs = kept[0]
    mask_row = time_mask(f'safety_mask at the battle\'s E={num_envs}, N=1 '
                         f'(seat 0 alone), 20x20', inputs, 60, smi)
    _, boards, starts, _ = plain_fill_inputs(inputs, 60)
    fill_row = time_fill(f'reachable_count at the battle\'s '
                         f'{boards.shape[0]} boards of 20x20, limit 60',
                         boards, starts, 60, smi)

    # the host arena: one episode at B=1
    env = make('Snake-v1', device='cuda', num_snakes=4, height=20,
               width=20, snake_length=5, seed=3)
    rng = random.Random(3)
    ppo_host = ActorCritic((20, 20), assume_binary_obs=True, device='cuda')
    ppo_host.load_state_dict(ppo_params)
    arena = BattleArena(env, net, None, [
        PPOAgent(1, ppo_host),
        NEATAgent(2, data['dqn_params'], data['neat_genome'],
                  data['neat_config'], cfg, device='cuda'),
        GreedyAgent(3, rng)], display_names=names)
    env_steps = [0]
    inner_step = env.step

    def counted_step(actions, **kwargs):
        env_steps[0] += 1
        return inner_step(actions, **kwargs)

    env.step = counted_step
    step_kernel.step.launches = 0
    SM.safety_mask.launches = 0
    with PlainEngineCalls() as plain, PlainMaskCalls() as plain_mask:
        t0 = time.perf_counter()
        host_rew, host_life = arena.run_battle(num_episodes=1,
                                               max_steps=128, verbose=False)
        host_wall = time.perf_counter() - t0
    host_launches = step_kernel.step.launches
    host_masks = SM.safety_mask.launches
    host_ms = host_wall / env_steps[0] * 1e3
    log(f'host BattleArena (make Snake-v1, 20x20x4, PPO / NEAT / Greedy '
        f'host agents): {env_steps[0]} steps, {host_launches} step launches '
        f'at B=1, {host_masks} safety_mask launches (one a step seat 0 '
        f'began alive), {plain.calls} plain-engine calls, '
        f'{plain_mask.calls} plain mask calls, mean rewards '
        f'{host_rew.tolist()}, lifetimes {host_life.tolist()}; '
        f'{host_ms:.3f} ms a step (host clock, with the warm-up) [{smi}]')
    if host_launches != env_steps[0] or plain.calls != 0 \
            or host_masks != int(host_life[0]) or plain_mask.calls != 0 \
            or not np.isfinite(host_rew).all():
        raise AssertionError(f'host arena: {env_steps[0]} steps, '
                             f'{host_launches} launches, {host_masks} '
                             f'safety_mask launches, {plain.calls} '
                             f'plain-engine calls, {plain_mask.calls} plain '
                             f'mask calls')
    return {'battle_launches': launches, 'battle_mask_launches': masks,
            'battle_steps': steps,
            'battle_steps_run': ran,
            'battle_ms_per_step': ms_per_step,
            'battle_window': window,
            'battle_graph': graph,
            'mask_battle': mask_row,
            'fill_battle': fill_row,
            'battle_replay': replay,
            'arena_launches': host_launches,
            'arena_mask_launches': host_masks,
            'arena_ms_per_step': host_ms}


def cli_phase(smi: str, tmp: str, ppo_params: dict,
              device: str = 'cuda') -> dict:
    """Every subcommand of ``python -m marlsnake_torch.cli`` once on the
    card at small counts, in a directory of its own: ``train`` (2
    episodes, 32 envs) writes the checkpoint that ``eval``, ``battle``
    (host and batched; with the PPO phase's net written in the reference
    layout and the NEAT phase's winner), ``neat`` and ``es`` load;
    ``train-ppo`` and ``demo``. Launches of both entries counted per
    subcommand, no plain-engine call."""
    import contextlib
    import io
    from marlsnake_torch import cli
    from marlsnake_torch.models.weights import actor_critic_to_reference
    from marlsnake_torch.ops import safety_mask as SM
    from marlsnake_torch.ops import step_kernel

    work = os.path.join(tmp, 'cli')
    os.makedirs(work)
    ppo_path = os.path.join(work, 'ppo_ref.pt')
    torch.save({'model_state_dict': actor_critic_to_reference(ppo_params)},
               ppo_path)
    lineup = ['--ppo-checkpoint', ppo_path,
              '--hybrid-pickle', os.path.join(tmp, 'neat.pkl')]
    runs = [
        ('train', ['--episodes', '2', '--num-envs', '32', '--no-log'],
         'Ep     2 | Mean Reward:'),
        ('eval', ['--no-render', '--episodes', '1'],
         'FINAL RESULTS OVER 1 EPISODES:'),
        ('battle', ['--no-render', '--episodes', '1'] + lineup,
         'Hybrid NEAT          | '),
        ('battle --batched', ['--episodes', '32'] + lineup, '| n=32'),
        ('neat', ['--generations', '1', '--pop-size', '16',
                  '--fitness-episodes', '1', '--result-file', 'neat.pkl'],
         'Loaded checkpoint: final'),
        ('es', ['--generations', '1', '--pop-size', '8',
                '--fitness-episodes', '1', '--val-episodes', '4',
                '--holdout-episodes', '4', '--result-file', 'es.pkl'],
         'holdout (4 fresh paired episodes): seed '),
        ('train-ppo', ['--updates', '1', '--num-envs', '16',
                       '--rollout-steps', '16', '--no-log'],
         'update    1 | return'),
        ('demo', [], 'demo: ')]
    counts = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for name, extra, expect in runs:
            argv = name.split() + extra + ['--device', device]
            step_kernel.step.launches = 0
            step_kernel.step_autoreset.launches = 0
            SM.safety_mask.launches = 0
            out = io.StringIO()
            with PlainEngineCalls() as plain, PlainMaskCalls() as pmask, \
                    contextlib.redirect_stdout(out):
                t0 = time.perf_counter()
                cli.main(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            text = out.getvalue()
            counts[name] = {'step': step_kernel.step.launches,
                            'step_autoreset':
                                step_kernel.step_autoreset.launches,
                            'safety_mask': SM.safety_mask.launches,
                            'seconds': seconds}
            loads = name in ('eval', 'battle', 'battle --batched', 'neat',
                             'es')
            autoreset = name == 'train-ppo'
            # eval and the batched battle mask every step; the host battle
            # every step seat 0 began alive
            masked = counts[name]['safety_mask']
            if name in ('eval', 'battle --batched'):
                mask_ok = masked == counts[name]['step']
            elif name == 'battle':
                mask_ok = 0 < masked <= counts[name]['step']
            else:
                mask_ok = True
            if expect not in text or plain.calls != 0 or pmask.calls != 0 \
                    or not mask_ok \
                    or (loads and 'Loaded checkpoint: final' not in text) \
                    or counts[name]['step' if not autoreset
                                    else 'step_autoreset'] == 0 \
                    or counts[name]['step_autoreset' if not autoreset
                                    else 'step'] != 0:
                log(text[-3000:])
                raise AssertionError(f'cli {name}: {counts[name]}, '
                                     f'{plain.calls} plain-engine calls')
            tail = [line for line in text.splitlines()
                    if line.strip()][-6:]
            log(f'cli {name} on the card: {seconds:.2f} s, step launches '
                f'{counts[name]["step"]}, step_autoreset launches '
                f'{counts[name]["step_autoreset"]}, safety_mask launches '
                f'{masked}; last lines: '
                f'{json.dumps(tail)}')
    finally:
        os.chdir(cwd)
    if counts['train-ppo']['step_autoreset'] != 16:
        raise AssertionError('cli train-ppo: one auto-reset launch a '
                             'rollout step expected')
    return counts


def same_tree(a, b, where: str) -> None:
    """Raise unless ``a`` and ``b`` hold equal tensors (dtype, shape and
    every bit) and equal other leaves, through dataclasses, dicts, lists
    and tuples; a replay ring is compared over its ``capacity`` rows (the
    spare row takes every masked-out write, in no fixed order)."""
    from marlsnake_torch.algo.replay import ReplayBuffer
    if isinstance(a, ReplayBuffer):
        cap = a.capacity
        for (name, x), (_, y) in zip(a.fields(), b.fields()):
            same_tree(x if x.dim() == 0 else x[:cap],
                      y if y.dim() == 0 else y[:cap], f'{where}.{name}')
    elif isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f'{where} differs')
    elif hasattr(a, '__dataclass_fields__'):
        for name in a.__dataclass_fields__:
            same_tree(getattr(a, name), getattr(b, name), f'{where}.{name}')
    elif isinstance(a, dict):
        for k in a:
            same_tree(a[k], b[k], f'{where}[{k}]')
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f'{where}[{i}]')
    elif a != b:
        raise AssertionError(f'{where}: {a} against {b}')


def mean_of_cpu_grads(cpu_trainer, records, where: str) -> float:
    """The all-reduced gradient of the first update of each rank
    (``records``: the runner's 'record' of each, its first call) against
    the mean of the
    ranks' gradients computed on the CPU from the same arguments (the
    minibatch and the parameters): within 1e-5 + 1e-4 x max|g|, the
    tolerance of one TD update card against CPU. Returns the largest share
    of that tolerance used."""
    grads = []
    for rec in records:
        out = cpu_trainer.loss_and_grads(*rec['args'][0])
        grads.append(out[1] if isinstance(out[1], list) else out[2])
    worst = 0.0
    for rec in records:
        reduced = rec['reduced'][0][:-1]
        for i, (got, *local) in enumerate(zip(reduced, *grads)):
            want = sum(local) / len(local)
            scale = float(want.abs().max())
            diff = float((got - want).abs().max())
            worst = max(worst, diff / (1e-5 + 1e-4 * scale))
            if diff > 1e-5 + 1e-4 * scale:
                raise AssertionError(f'{where}: the all-reduced gradient '
                                     f'{i} is {diff} from the CPU mean '
                                     f'(largest magnitude {scale})')
    return worst


def parallel_phase(smi: str, tmp: str) -> dict:
    """Data-parallel DQN and PPO (``marlsnake_torch/parallel``) at full
    width on the one card: world 1 on NCCL in this process, EQUAL to the
    single-device trainers at the same draws (cuDNN deterministic); two
    gloo ranks sharing the card (``parallel.runner``), whose parameters
    must stay bit-equal and whose first all-reduced gradients must be the
    mean of the ranks' gradients on the CPU; the local cluster; the
    scaling harness at world 1 and 2; times and collectives. Every rank's
    launches must equal its own env steps."""
    from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    from marlsnake_torch.core.types import EnvConfig
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.parallel import distributed
    from marlsnake_torch.parallel.dqn_dp import DistributedDQN
    from marlsnake_torch.parallel.mesh import make_mesh
    from marlsnake_torch.parallel.ppo_dp import DistributedPPO
    from marlsnake_torch.parallel.runner import run_job
    from marlsnake_torch.rng import ppo_draws, reset_draws, train_draws
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    dqn_kwargs = dict(num_envs=256, snake_length=3, max_steps_per_episode=256)
    ppo_kwargs = dict(num_envs=256, save_final=False)
    scale_env = dict(height=20, width=20, num_snakes=4, snake_length=3)
    out = {}

    # both entries against the plain engine at the widths a rank of this
    # phase gives them, each rank's config: K1 at DistributedPPO's 128
    # envs a gloo rank and the scaling harness's 512, the step entry at
    # DistributedDQN's 128 (with its hold)
    out['max_abs_err'] = {
        'step_autoreset ppo B=128': parity(
            PPOConfig(**ppo_kwargs).env_config(), 128, 64, seed=51),
        'step_autoreset scaling B=512': parity(
            EnvConfig(**scale_env), 512, 64, seed=52),
        'step dqn B=128 hold': parity_step(
            DQNConfig(**dqn_kwargs).env_config(), 128, 64, seed=53,
            hold=True)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    def collectives(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        return (result, distributed.collective_counts(prof),
                distributed.collective_times(prof))

    # --- world 1 on NCCL, in this process ---
    distributed.initialize('file://' + os.path.join(tmp, 'rendezvous-w1'),
                           1, 0, backend='nccl', device='cuda')
    try:
        mesh = make_mesh(1)
        if mesh.group is None or torch.distributed.get_backend() != 'nccl':
            raise AssertionError('world 1 runs without an NCCL group')
        (_, warm_s) = timed(mesh.barrier)    # NCCL makes its communicator
        out['nccl_first_collective_ms'] = warm_s * 1e3
        ddqn = DistributedDQN(DQNConfig(**dqn_kwargs), mesh)
        single = DQNTrainer(DQNConfig(**dqn_kwargs), device='cuda')
        cfg, ecfg = single.config, single.env_cfg
        ts_dp, ts = ddqn.init_state(), single.init_state()
        same_tree(ts_dp, ts, 'DistributedDQN init')
        gen = torch.Generator(device='cuda')
        gen.manual_seed(41)
        times = {'dp': [], 'single': []}
        dp_launches, dp_steps = 0, []
        for ep in range(2):
            reset = reset_draws(ecfg, cfg.num_envs, gen, 'cuda')
            draws = train_draws(ecfg, cfg.num_envs, cfg.max_steps_per_episode,
                                cfg.buffer_size, cfg.batch_size, gen, 'cuda')
            before = step_kernel.step.launches
            (ts_dp, m_dp), sec = timed(
                lambda: ddqn.train_episode(ts_dp, draws, reset))
            dp_launches += step_kernel.step.launches - before
            dp_steps.append(int(m_dp.episode_length))
            times['dp'].append(sec * 1e3)
            (ts, m), sec = timed(lambda: single.train_episode(ts, draws,
                                                              reset))
            times['single'].append(sec * 1e3)
            same_tree(ts_dp, ts, f'DistributedDQN episode {ep}')
            same_tree(m_dp, m, f'DistributedDQN metrics {ep}')
            if m.updates <= 0 or not bool(torch.isfinite(m.mean_loss)):
                raise AssertionError('world-1 DQN: no update or a loss '
                                     'that is not finite')
        if dp_launches != sum(dp_steps):
            raise AssertionError(f'world-1 DQN: {sum(dp_steps)} env steps '
                                 f'but {dp_launches} launches of step')
        out['dqn_world1'] = {
            'ms_per_episode': times['dp'],
            'single_ms_per_episode': times['single'],
            'ms_per_step': [t / n for t, n in zip(times['dp'], dp_steps)],
            'single_ms_per_step': [t / n for t, n in zip(times['single'],
                                                         dp_steps)],
            'env_steps': dp_steps, 'step_launches': dp_launches,
            'cudnn_deterministic': True}
        log(f'DistributedDQN at world 1 (NCCL), {cfg.num_envs} envs of '
            f'20x20x4, 2 episodes: EQUAL to DQNTrainer at the same draws '
            f'(parameters, target, Adam, ring, epsilon, metrics); '
            f'{sum(dp_steps)} env steps, {dp_launches} step launches; '
            f'{json.dumps(out["dqn_world1"])} [{smi}]')

        # a short episode from the warm ring, under the profiler
        short = DistributedDQN(DQNConfig(**dict(
            dqn_kwargs, max_steps_per_episode=16)), mesh)
        (_, m_short), counts, ctimes = collectives(
            lambda: short.train_episode(ts_dp))
        out['dqn_world1_collectives'] = dict(
            counts, steps=int(m_short.episode_length),
            updates=m_short.updates, **ctimes)
        log(f'collectives of a 16-step DistributedDQN episode at world 1 '
            f'(warm ring; 1 before the first step, 1 a step, 1 an update, '
            f'2 for the metrics): {json.dumps(out["dqn_world1_collectives"])}'
            f' [{smi}]')
        del ddqn, single, short, ts_dp, ts
        torch.cuda.empty_cache()

        dppo = DistributedPPO(PPOConfig(**ppo_kwargs), mesh)
        psingle = PPOTrainer(PPOConfig(**ppo_kwargs), device='cuda')
        pcfg = psingle.config
        pts_dp, pts = dppo.init_state(), psingle.init_state()
        same_tree(pts_dp, pts, 'DistributedPPO init')
        ptimes = {'dp': [], 'single': []}
        k1_launches = 0
        for u in range(2):
            draws = ppo_draws(psingle.env_cfg, pcfg.num_envs,
                              pcfg.rollout_steps, pcfg.update_epochs, gen,
                              'cuda')
            before = step_kernel.step_autoreset.launches
            (pts_dp, pm_dp), sec = timed(
                lambda: dppo.train_update(pts_dp, draws))
            k1_launches += step_kernel.step_autoreset.launches - before
            ptimes['dp'].append(sec * 1e3)
            (pts, pm), sec = timed(lambda: psingle.update(pts, draws))
            ptimes['single'].append(sec * 1e3)
            same_tree(pts_dp, pts, f'DistributedPPO update {u}')
            same_tree(pm_dp, pm, f'DistributedPPO metrics {u}')
        if k1_launches != 2 * pcfg.rollout_steps:
            raise AssertionError(f'world-1 PPO: {2 * pcfg.rollout_steps} '
                                 f'rollout steps but {k1_launches} launches '
                                 f'of step_autoreset')
        (_, _), pcounts, ptimes_c = collectives(
            lambda: dppo.train_update(pts_dp))
        out['ppo_world1'] = {
            'ms_per_update': ptimes['dp'],
            'single_ms_per_update': ptimes['single'],
            'step_autoreset_launches': k1_launches,
            'collectives_per_update': dict(pcounts, **ptimes_c)}
        log(f'DistributedPPO at world 1 (NCCL), {pcfg.num_envs} envs x '
            f'{pcfg.rollout_steps} steps, 2 updates: EQUAL to '
            f'PPOTrainer.update at the same draws; {k1_launches} '
            f'step_autoreset launches; {json.dumps(out["ppo_world1"])} '
            f'[{smi}]')
        del dppo, psingle, pts_dp, pts
        torch.cuda.empty_cache()

        cfg_s = EnvConfig(**scale_env)
        out['scaling_world1'] = {
            'step_time': distributed.per_device_step_time(
                cfg_s, envs_per_device=512, num_steps=64, mesh=mesh),
            'scaling': distributed.scaling_efficiency(
                cfg_s, envs_per_device=512, num_steps=64, mesh=mesh)}
        log(f'scaling at world 1 (NCCL), 512 envs of 20x20x4 a rank, 64 '
            f'steps: {json.dumps(out["scaling_world1"])} [{smi}]')
    finally:
        torch.distributed.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic

    # --- two gloo ranks on the one card ---
    half = dict(dqn_kwargs)                          # 2 x 128 envs
    t0 = time.perf_counter()
    ranks = run_job({'device': 'cuda', 'backend': 'gloo', 'tasks': [
        {'kind': 'dqn', 'config': half, 'episodes': 2, 'check': 1},
        {'kind': 'dqn', 'config': dict(half, max_steps_per_episode=16),
         'episodes': 1, 'profile': True, 'check': 0},
        {'kind': 'ppo', 'config': ppo_kwargs, 'updates': 1, 'check': 1,
         'profile': True},
        {'kind': 'scaling', 'env': scale_env, 'envs_per_device': 512,
         'num_steps': 64}]}, 2, tmp, timeout=600)
    job_s = time.perf_counter() - t0
    dqn = [r[0] for r in ranks]
    for ep in range(2):
        a, b = (res['states'][ep] for res in dqn)
        same_tree(a.params, b.params, f'gloo DQN episode {ep}: parameters '
                  f'across ranks')
        m = dqn[0]['metrics'][ep]
        if m.updates <= 0 or not bool(torch.isfinite(m.mean_loss)):
            raise AssertionError('gloo DQN: no update or a loss that is not '
                                 'finite')
    for r, res in enumerate(dqn + [x[1] for x in ranks]):
        for steps, (step_n, auto_n) in zip(res['env_steps'],
                                           res['launches']):
            if step_n != steps or auto_n != 0:
                raise AssertionError(f'gloo DQN rank {r % 2}: {steps} env '
                                     f'steps but {step_n} step and {auto_n} '
                                     f'step_autoreset launches')
    ppo = [r[2] for r in ranks]
    a, b = (res['states'][0] for res in ppo)
    same_tree(a.params, b.params, 'gloo PPO: parameters across ranks')
    for r, res in enumerate(ppo):
        if res['launches'][0] != (0, res['env_steps'][0]) \
                or res['env_steps'][0] != PPOConfig().rollout_steps:
            raise AssertionError(f'gloo PPO rank {r}: {res["env_steps"]} '
                                 f'env steps, launches {res["launches"]}')
        pm = res['metrics'][0]
        if not all(math.isfinite(float(getattr(pm, k))) for k in (
                'loss_actor', 'loss_value', 'entropy', 'approx_kl')):
            raise AssertionError('gloo PPO: a loss is not finite')
    dqn_worst = mean_of_cpu_grads(
        DQNTrainer(DQNConfig(**dict(half, num_envs=128)), device='cpu'),
        [res['record'] for res in dqn], 'gloo DQN first update')
    ppo_worst = mean_of_cpu_grads(
        PPOTrainer(PPOConfig(**dict(ppo_kwargs, num_envs=1,
                                    rollout_steps=1)), device='cpu'),
        [res['record'] for res in ppo], 'gloo PPO first minibatch')
    out['gloo_world2'] = {
        'job_seconds': job_s,
        'dqn_episode_seconds': [res['seconds'] for res in dqn],
        'dqn_env_steps': [res['env_steps'] for res in dqn],
        'dqn_updates': [m.updates for m in dqn[0]['metrics']],
        'dqn_episode_length': [m.episode_length
                               for m in dqn[0]['metrics']],
        'dqn_step_launches': [[n for n, _ in res['launches']]
                              for res in dqn],
        'dqn_collectives_16_steps': [dict(x[1]['collectives'],
                                          steps=x[1]['env_steps'][0],
                                          updates=x[1]['metrics'][0].updates,
                                          **x[1]['collective_times'])
                                     for x in ranks],
        'ppo_update_seconds': [res['seconds'][0] for res in ppo],
        'ppo_step_autoreset_launches': [res['launches'][0][1]
                                        for res in ppo],
        'ppo_collectives': [dict(res['collectives'],
                                 **res['collective_times']) for res in ppo],
        'grad_tolerance_used': {'dqn': dqn_worst, 'ppo': ppo_worst},
        'scaling': ranks[0][3]}
    log(f'two gloo ranks on one card (2 x 128 envs): DQN 2 episodes and '
        f'PPO 1 update, parameters bit-equal across ranks, launches equal '
        f'each rank\'s env steps, first all-reduced gradients within '
        f'{dqn_worst:.3g} (DQN) and {ppo_worst:.3g} (PPO) of their '
        f'tolerance 1e-5 + 1e-4 x max|g| of the CPU mean; '
        f'{json.dumps(out["gloo_world2"])} [{smi}]')

    t0 = time.perf_counter()
    cluster = distributed.launch_local_cluster(2, device='cuda',
                                               backend='gloo')
    if not all(r['updates'] > 0 for r in cluster):
        raise AssertionError(f'local cluster made no update: {cluster}')
    out['cluster'] = {'seconds': time.perf_counter() - t0,
                      'results': cluster}
    log(f'launch_local_cluster(2, cuda, gloo): digests equal; '
        f'{json.dumps(out["cluster"])} [{smi}]')
    out['seconds'] = time.perf_counter() - t_phase
    log(f'parallel phase: {out["seconds"]:.1f} s')
    return out


def chunked_steps(trainer, metrics) -> int:
    """The env steps a DQN episode of ``metrics`` ran: whole chunks of
    ``trainer.chunk_steps``, the last one running on after the episode's
    last env finished."""
    return chunked(int(metrics.episode_length), trainer.chunk_steps)


def first_difference(a, b, where: str):
    """The name of the first field where ``a`` and ``b`` differ (as
    ``same_tree`` compares them), or None."""
    try:
        same_tree(a, b, where)
    except AssertionError as err:
        return str(err)
    return None


def graph_phase(smi: str) -> dict:
    """The captured loops (``utils/cuda_graph.py``): the DQN episode's
    chunks, the PPO rollout and the bench rollout, each held against its
    uncaptured body, then timed.

    Equality, cuDNN deterministic, tolerance 0: two DQN episodes at 256
    envs for update_every 1 and 4 and the fused update (every field of the
    state, ring over its capacity rows, and the metrics), three PPO
    updates at 256 envs (the state, the trajectory, the metrics) and 64
    bench steps at 4096 envs (the states and the checksum), each from the
    same state with the same draws. The step counters must equal the
    steps the graphs ran. Times in turns (graph, uncaptured, uncaptured,
    graph): ms per DQN step at 32 and 256 envs, ms per PPO update and its
    rollout at 64 and 256 envs, bench env-steps/s at 4096 envs. Profiler
    windows of 16 steps of each path, graph and uncaptured. What each
    capture cost once: seconds and the bytes of its pool."""
    from marlsnake_torch import bench
    from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    from marlsnake_torch.core.types import EnvConfig
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import (ppo_draws, reset_draws, rollout_draws,
                                     train_draws)
    from marlsnake_torch.utils.cuda_graph import clone_tree

    t_phase = time.perf_counter()
    out = {'equal': {}, 'captures': {}}

    def dqn_config(**kwargs):
        return DQNConfig(**{**dict(num_envs=256, snake_length=3,
                                   max_steps_per_episode=256), **kwargs})

    def check_equal(got, want, what):
        bad = first_difference(got, want, what)
        if bad is not None:
            raise AssertionError(f'graph against its uncaptured body: {bad}')

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # --- DQN: two episodes each way, from the same warm state ---
        for label, mode in (('every-1', {}), ('every-4',
                                              dict(update_every=4)),
                            ('fused', dict(fused_act_update=True))):
            tr = DQNTrainer(dqn_config(**mode), device='cuda')
            cfg, ecfg, k = tr.config, tr.env_cfg, tr.chunk_steps
            ts, _ = tr.train_episode(tr.init_state())   # warm ring, capture
            gen = torch.Generator(device='cuda')
            gen.manual_seed(61)
            episodes = [(train_draws(ecfg, cfg.num_envs,
                                     cfg.max_steps_per_episode,
                                     cfg.buffer_size, tr.update_batch, gen,
                                     'cuda'),
                         reset_draws(ecfg, cfg.num_envs, gen, 'cuda'))
                        for _ in range(2)]
            runs = {}
            for name, fn in (('graph', tr.train_episode),
                             ('uncaptured', tr.train_episode_plain)):
                step_kernel.step.launches = 0
                cur, metrics = ts, []
                for draws, reset in episodes:
                    cur, m = fn(cur, draws, reset)
                    metrics.append(m)
                torch.cuda.synchronize()
                run = sum(chunked_steps(tr, m) for m in metrics)
                if step_kernel.step.launches != run:
                    raise AssertionError(
                        f'DQN {label} {name}: {run} steps run, '
                        f'{step_kernel.step.launches} step launches')
                runs[name] = (cur, metrics, run)
            check_equal(runs['graph'][:2], runs['uncaptured'][:2],
                        f'DQN {label}')
            lengths = [int(m.episode_length) for m in runs['graph'][1]]
            loop, = tr.captured_loops()
            out['equal'][f'dqn {label}'] = {
                'episode_length': lengths,
                'updates': [m.updates for m in runs['graph'][1]],
                'steps_run': runs['graph'][2], 'chunk_steps': k,
                'wasted_steps': runs['graph'][2] - sum(lengths)}
            out['captures'][f'dqn {label}'] = loop.stats()
            log(f'DQN {label} at 256 envs, 2 episodes: graph EQUAL to the '
                f'uncaptured chunks (cuDNN deterministic, every field); '
                f'{json.dumps(out["equal"][f"dqn {label}"])}; capture '
                f'{json.dumps(loop.stats())} [{smi}]')
            del tr, ts, runs, episodes
            torch.cuda.empty_cache()

        # --- PPO: three updates each way ---
        tr = PPOTrainer(PPOConfig(num_envs=256, save_final=False),
                        device='cuda')
        cfg = tr.config
        ts, _ = tr.update(tr.init_state())               # capture
        gen = torch.Generator(device='cuda')
        gen.manual_seed(62)
        updates = [ppo_draws(tr.env_cfg, cfg.num_envs, cfg.rollout_steps,
                             cfg.update_epochs, gen, 'cuda')
                   for _ in range(3)]
        runs = {}
        for name, collect in (('graph', tr.collect),
                              ('uncaptured', tr.collect_plain)):
            step_kernel.step_autoreset.launches = 0
            cur, record = ts, []
            for draws in updates:
                cur = collect(cur, draws)
                traj = clone_tree(tr.trajectory)
                cur, m = tr.learn(cur, draws.perm)
                record.append((traj, m))
            torch.cuda.synchronize()
            if step_kernel.step_autoreset.launches != 3 * cfg.rollout_steps:
                raise AssertionError(
                    f'PPO {name}: {step_kernel.step_autoreset.launches} '
                    f'launches for {3 * cfg.rollout_steps} rollout steps')
            runs[name] = (cur, record)
        check_equal(runs['graph'], runs['uncaptured'], 'PPO')
        loop = tr.rollout_loop()[1]
        out['equal']['ppo'] = {'updates': 3, 'rollout_steps':
                               cfg.rollout_steps}
        out['captures']['ppo rollout'] = loop.stats()
        log(f'PPO at 256 envs, 3 updates: the rollout graph EQUAL to its '
            f'uncaptured body (states, trajectories, metrics; cuDNN '
            f'deterministic); capture {json.dumps(loop.stats())} [{smi}]')
        del tr, ts, runs, updates
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # --- bench: 64 steps at 4096 envs each way ---
    big = EnvConfig(height=20, width=20, num_snakes=4, snake_length=3,
                    spawn_mode='procedural')
    env = VectorSnakeEnv(big, 4096, device='cuda', seed=63)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(64)
    roll = bench.Rollout(env, 64)
    states, _ = roll.random(env.reset()[0], gen)           # capture
    actions, draws = rollout_draws(big, 4096, 64, gen, 'cuda')
    got = roll(states, actions, draws)
    want = roll(states, actions, draws, captured=False)
    check_equal(got, want, 'bench rollout')
    out['equal']['bench'] = {'steps': 64, 'num_envs': 4096,
                             'checksum': float(got[1])}
    out['captures']['bench rollout (64 steps)'] = roll.loop.stats()
    log(f'bench rollout, 64 steps at 4096 envs: graph EQUAL to its '
        f'uncaptured body (states and checksum {float(got[1])}); capture '
        f'{json.dumps(roll.loop.stats())} [{smi}]')
    del env, roll, states, got, want, actions, draws
    torch.cuda.empty_cache()

    # --- times, in turns: graph, uncaptured, uncaptured, graph ---
    turns = (True, False, False, True)
    out['dqn'] = {}
    for n_envs in (32, 256):
        rows = [bench.run_train(n_envs, 1, episodes=2, device='cuda',
                                captured=c) for c in turns]
        out['dqn'][n_envs] = {
            'graph_ms_per_step': [r['ms_per_step'] for r in rows if
                                  r['captured']],
            'uncaptured_ms_per_step': [r['ms_per_step'] for r in rows
                                       if not r['captured']],
            'rows': rows}
        for r in rows:
            log(f'train bench (in turns): {json.dumps(r)} [{smi}]')
    out['ppo'] = {}
    for n_envs in (64, 256):
        rows = [bench.run_ppo(n_envs, updates=3, device='cuda', captured=c)
                for c in turns]
        out['ppo'][n_envs] = {
            key: [r[field] for r in rows if r['captured'] == c]
            for key, field, c in (
                ('graph_ms_per_update', 'ms_per_update', True),
                ('uncaptured_ms_per_update', 'ms_per_update', False),
                ('graph_rollout_ms', 'rollout_ms', True),
                ('uncaptured_rollout_ms', 'rollout_ms', False))}
        for r in rows:
            log(f'ppo bench (in turns): {json.dumps(r)} [{smi}]')
    rows = [bench.run(num_envs=4096, num_steps=256, iters=2, device='cuda',
                      captured=c) for c in turns]
    out['bench'] = {
        'graph_env_steps_per_s': [r['value'] for r in rows if r['captured']],
        'uncaptured_env_steps_per_s': [r['value'] for r in rows
                                       if not r['captured']]}
    for r in rows:
        log(f'bench (in turns): {json.dumps(r)} [{smi}]')

    # --- profiler windows of 16 steps, graph and uncaptured ---
    out['windows'] = {}

    def window(label, fn, also):
        out['windows'][label] = loop_window(label, fn, 16, smi, also)

    for n_envs in (32, 256):
        tr = DQNTrainer(dqn_config(num_envs=n_envs,
                                   max_steps_per_episode=16), device='cuda')
        held = [tr.train_episode(tr.init_state())[0]]
        for _ in range(12):                       # a warm ring
            held[0] = tr.train_episode(held[0])[0]
        for name, fn in (('graph', tr.train_episode),
                         ('uncaptured', tr.train_episode_plain)):
            lengths = []

            def episode():
                held[0], m = fn(held[0])
                lengths.append((int(m.episode_length), m.updates))

            window(f'DQN training ({name}, {n_envs} envs)', episode,
                   (STEP_KERNEL_NAME,))
            out['windows'][f'DQN training ({name}, {n_envs} envs)'][
                'steps_and_updates'] = lengths[-1]
        del tr, held
    for name, captured in (('graph', True), ('uncaptured', False)):
        tr = PPOTrainer(PPOConfig(num_envs=256, rollout_steps=16,
                                  save_final=False), device='cuda')
        held = [tr.init_state()]
        draws = ppo_draws(tr.env_cfg, 256, 16, 4, tr.generator, 'cuda')
        collect = tr.collect if captured else tr.collect_plain

        def rollout():
            held[0] = collect(held[0], draws)

        window(f'PPO rollout ({name}, 256 envs, with GAE)', rollout,
               (KERNEL_NAME,))
        del tr, held
    env = VectorSnakeEnv(big, 4096, device='cuda', seed=65)
    roll = bench.Rollout(env, 16)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(66)
    for name, captured in (('graph', True), ('uncaptured', False)):
        held = [env.reset()[0]]

        def steps():
            held[0], _ = roll.random(held[0], gen, captured)

        window(f'bench ({name}, 4096 envs)', steps, (KERNEL_NAME,))
    del env, roll, held
    torch.cuda.empty_cache()
    out['seconds'] = time.perf_counter() - t_phase
    log(f'graph phase: {out["seconds"]:.1f} s')
    return out


def tracer_phase(smi: str) -> dict:
    """The program's tracer on the card (``utils/profiling.py``,
    ``csrc/stamp.cu``).

    ``TRACER_STAMPS`` stamps back to back in one captured graph: every one
    nonzero, none before the one it follows, their steps on a tick (their
    greatest common divisor) of at most 1,024 ns; the stamp kernel's
    launches are the warm-up's and the replay's, none at the capture. Then
    two DQN episodes at 256 envs from one warm state with the same draws,
    the tracer off and then on (cuDNN deterministic): the state, the ring
    and the metrics EQUAL (tolerance 0); no stamp launched with the tracer
    off; on, the chunk graph captured once more with four marks a step
    and the chunk's two. Last, one more episode each way under
    ``profiling.trace``: device-to-host copies an episode step (the
    tracer's one read of its ring comes after the profile), and the
    traced trace's phase track: its phases, and how far each phase's
    length between its stamps' kernels lies from its length between the
    stamps themselves (median and p95, ns)."""
    from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
    from marlsnake_torch.ops import stamp
    from marlsnake_torch.rng import reset_draws, train_draws
    from marlsnake_torch.utils import profiling
    from marlsnake_torch.utils.cuda_graph import CapturedLoop, chunk_steps
    from marlsnake_torch.utils.profiling import tracer

    out = {}
    n = TRACER_STAMPS
    slots = torch.zeros(n, dtype=torch.int64, device='cuda')
    loop = CapturedLoop(lambda: [stamp.stamp(slots, i) for i in range(n)],
                        'cuda')
    stamp.stamp.launches = 0
    loop()                       # the warm-up's stamps, then the capture
    slots.zero_()
    loop()
    t = slots.tolist()
    steps = [b - a for a, b in zip(t, t[1:])]
    tick = math.gcd(*steps)
    if min(t) <= 0 or min(steps) < 0 or not 0 < tick <= 1024:
        raise AssertionError(f'back-to-back stamps: first {t[:4]}, steps '
                             f'{steps[:8]}, tick {tick} ns')
    if stamp.stamp.launches != 2 * n:
        raise AssertionError(f'{stamp.stamp.launches} stamp launches for '
                             f'a warm-up and a replay of {n}')
    out['back_to_back'] = {
        'stamps': n, 'tick_ns': tick,
        'smallest_step_ns': min((d for d in steps if d > 0), default=None),
        'median_step_ns': sorted(steps)[len(steps) // 2],
        'equal_neighbours': sum(d == 0 for d in steps) / len(steps),
        'first_mod_tick_ns': t[0] % tick}
    log(f'tracer: {n} back-to-back stamps in one graph, nonzero, in '
        f'order: {json.dumps(out["back_to_back"])} [{smi}]')
    del loop, slots

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tr = DQNTrainer(DQNConfig(num_envs=256, snake_length=3,
                                  max_steps_per_episode=256), device='cuda')
        cfg, ecfg = tr.config, tr.env_cfg
        ts, _ = tr.train_episode(tr.init_state())   # warm ring, capture
        gen = torch.Generator(device='cuda')
        gen.manual_seed(64)
        episodes = [(train_draws(ecfg, cfg.num_envs,
                                 cfg.max_steps_per_episode, cfg.buffer_size,
                                 tr.update_batch, gen, 'cuda'),
                     reset_draws(ecfg, cfg.num_envs, gen, 'cuda'))
                    for _ in range(3)]
        runs = {}
        for on in (False, True):
            if on:
                tracer.enable('cuda')
            stamp.stamp.launches = 0
            cur, metrics = ts, []
            for draws, reset in episodes[:2]:
                cur, m = tr.train_episode(cur, draws, reset)
                metrics.append(m)
            torch.cuda.synchronize()
            if not on and stamp.stamp.launches:
                raise AssertionError(f'{stamp.stamp.launches} stamps '
                                     f'launched with the tracer off')
            got = tracer.flush()
            tracer.disable()
            runs[on] = (cur, metrics, got)
        bad = first_difference(runs[True][:2], runs[False][:2],
                               'DQN traced')
        if bad is not None:
            raise AssertionError(f'traced against untraced: {bad}')
        chunk, = tr.captured_loops()
        k = chunk_steps(cfg.max_steps_per_episode, cfg.update_every)
        acts = sum(s['name'] == 'dqn.act' for s in runs[True][2]['stamps'])
        run = sum(-(-int(m.episode_length) // k) * k
                  for m in runs[True][1])
        if (chunk.traced_graph is None or chunk.marks != 4 * k + 2
                or acts != run):
            raise AssertionError(f'traced chunk: {chunk.marks} marks, '
                                 f'{acts} act stamps for {run} steps run')
        out['dqn'] = {'episodes': 2, 'steps_run': run,
                      'marks_a_chunk': chunk.marks}
        log(f'tracer: 2 DQN episodes at 256 envs traced EQUAL to untraced '
            f'(cuDNN deterministic, every field); {json.dumps(out["dqn"])}')

        draws, reset = episodes[2]
        dtoh = {}
        for on in (False, True):
            if on:
                tracer.enable('cuda')
            with tempfile.TemporaryDirectory() as d:
                with profiling.trace(d):
                    _, m = tr.train_episode(ts, draws, reset)
                    torch.cuda.synchronize()
                tracer.disable()
                with open(os.path.join(d, 'trace.json')) as fp:
                    events = json.load(fp)['traceEvents']
            dtoh['traced' if on else 'untraced'] = sum(
                'Memcpy DtoH' in e.get('name', '') for e in events
                if e.get('ph') == 'X') / int(m.episode_length)
        track = [e for e in events if e.get('pid') == 'marlsnake phases'
                 and e.get('ph') == 'X']
        off = sorted(abs(e['dur'] * 1e3 - e['args']['stamp_ns'])
                     for e in track)
        if dtoh['traced'] != dtoh['untraced'] or not track:
            raise AssertionError(f'read-backs a step {dtoh}, '
                                 f'{len(track)} phases in the track')
        out['profiled'] = {
            'dtoh_per_step': dtoh, 'track_phases': len(track),
            'kernel_against_stamp_ns': {
                'median': off[len(off) // 2],
                'p95': off[min(len(off) - 1, int(0.95 * len(off)))]}}
        log(f'tracer: one profiled episode each way: '
            f'{json.dumps(out["profiled"])} [{smi}]')
    finally:
        torch.backends.cudnn.deterministic = deterministic
        tracer.disable()
    return out


def showcase_phase(smi: str, tmp: str) -> dict:
    """The learning-curve programs (``marlsnake_torch/examples/
    train_showcase.py``) and the battle program (``marlsnake_torch/tools/
    battle_batch_run.py``) at their full widths, each run's launch
    counters set to 0 before it and read after.

    First both step entries against the plain engine, tolerance 0, at the
    shapes and configs the programs give them: the auto-reset entry at
    run_ppo's (B=128) and run_ppo20's (B=256) configs, the step entry
    with its hold at run_dqn's (B=32) and the battle's (B=128, 20x20x4,
    length 3).

    DQN: run_dqn's config (10x10x2, 32 envs, 128 steps, batch 256, ring
    50,000), 12 episodes chained through the program from a fresh state
    (the ring turns warm in the first), every chunk a replay of the one
    graph captured for all of them; then the same 12 through
    ``train_episode_plain`` from the same state and draws. cuDNN
    deterministic, tolerance 0: the state (parameters, target, Adam
    state, ring, epsilon, counters) and every row EQUAL; the step entry's
    launches equal the steps the chunks ran. PPO: 3 updates of run_ppo's
    config (128 envs) through the program against the uncaptured rollout
    (state, trajectories, metrics EQUAL; the auto-reset entry launched
    once a rollout step), then 2 updates of run_ppo20's (256 envs); ms
    per update. The battle program's ``main`` at 128 envs x 512 steps of
    20x20 with 4 snakes of length 3, on the NEAT phase's checkpoint in
    ``tmp`` (the flax-init DQN of seed 0, not a trained one): the step
    entry and the mask launched once a loop step (warm-up and profiler
    window included), no auto-reset launch; ms per step and a profiler
    window of 16 steps."""
    from marlsnake_torch.algo.dqn_trainer import DQNTrainer
    from marlsnake_torch.algo.ppo_trainer import PPOTrainer
    from marlsnake_torch.examples import train_showcase as S
    from marlsnake_torch.ops import safety_mask as SM
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import ppo_draws, reset_draws, train_draws
    from marlsnake_torch.tools import battle_batch_run as R
    from marlsnake_torch.utils.cuda_graph import clone_tree

    t_phase = time.perf_counter()
    out = {}

    def zero_counts():
        step_kernel.step.launches = 0
        step_kernel.step_autoreset.launches = 0
        SM.safety_mask.launches = 0

    def counts():
        torch.cuda.synchronize()
        return (step_kernel.step.launches,
                step_kernel.step_autoreset.launches,
                SM.safety_mask.launches)

    def check_equal(got, want, what):
        bad = first_difference(got, want, what)
        if bad is not None:
            raise AssertionError(f'showcase: captured against uncaptured: '
                                 f'{bad}')

    # --- both step entries against the plain engine at this phase's
    # shapes and configs (each run's rewards, the DQN's and the battle's
    # hold), tolerance 0 ---
    out['max_abs_err'] = {
        'step_autoreset run_ppo B=128': parity(
            S.ppo_config(0).env_config(), 128, 64, seed=81),
        'step_autoreset run_ppo20 B=256': parity(
            S.ppo20_config(0, 2, tmp).env_config(), 256, 64, seed=82),
        'step run_dqn B=32 hold': parity_step(
            S.dqn_config(0, tmp).env_config(), 32, 64, seed=83, hold=True),
        'step battle B=128 hold': parity_step(
            R.battle_config(), 128, 64, seed=84, hold=True)}
    if any(out['max_abs_err'].values()):
        raise AssertionError(f'showcase parity: {out["max_abs_err"]}')

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # --- DQN: 12 episodes through the program, then uncaptured ---
        tr = DQNTrainer(S.dqn_config(0, tmp), device='cuda')
        cfg, ecfg = tr.config, tr.env_cfg
        gen = torch.Generator(device='cuda')
        gen.manual_seed(71)
        draws = [(reset_draws(ecfg, cfg.num_envs, gen, 'cuda'),
                  train_draws(ecfg, cfg.num_envs, cfg.max_steps_per_episode,
                              cfg.buffer_size, tr.update_batch, gen, 'cuda'))
                 for _ in range(12)]
        start = tr.init_state()

        def uncaptured():
            ts = start
            for ep, (reset, d) in enumerate(draws, 1):
                ts, m = tr.train_episode_plain(ts, d, reset)
                yield ep, ts, m

        runs = {}
        for name, episodes in (('graph', S.dqn_episodes(tr, start, 12,
                                                        draws)),
                               ('uncaptured', uncaptured())):
            zero_counts()
            t0 = time.perf_counter()
            rows, run, live = [], 0, 0
            for ep, ts, m in episodes:
                rows.append(S.dqn_row(ep, ts, m, 0.0))
                run += chunked_steps(tr, m)
                live += int(m.episode_length)
            step, auto, mask = counts()
            seconds = time.perf_counter() - t0
            if (step, auto, mask) != (run, 0, 0):
                raise AssertionError(
                    f'showcase DQN {name}: {run} steps run, launches: step '
                    f'{step}, step_autoreset {auto}, safety_mask {mask}')
            runs[name] = (ts, rows)
            out[f'dqn_{name}'] = {'seconds': seconds, 'steps_run': run,
                                  'live_steps': live,
                                  'ms_per_live_step': 1e3 * seconds / live,
                                  'step_launches': step}
        check_equal(runs['graph'], runs['uncaptured'], 'DQN 12 episodes')
        loops = tr.captured_loops()
        if len(loops) != 1 or not loops[0].replays:
            raise AssertionError(f'showcase DQN: {len(loops)} captured '
                                 f'loops; the cold and the warm ring must '
                                 f'replay one graph')
        rows = runs['graph'][1]
        if not all(math.isfinite(v) for r in rows for v in r.values()) \
                or rows[-1]['loss'] <= 0.0 or int(runs['graph'][0].buffer
                                                  .size) < cfg.min_buffer_size:
            raise AssertionError(f'showcase DQN rows: {rows}')
        out['dqn_rows'] = rows
        out['dqn_capture'] = loops[0].stats()
        log(f'showcase DQN (run_dqn config: 10x10x2, 32 envs, ring '
            f'50,000, batch 256), 12 episodes: the graph EQUAL to the '
            f'uncaptured chunks (cuDNN deterministic; state, ring, epsilon '
            f'and rows), one graph for the cold and the warm ring '
            f'({json.dumps(loops[0].stats())}); graph '
            f'{json.dumps(out["dqn_graph"])}, uncaptured '
            f'{json.dumps(out["dqn_uncaptured"])} [{smi}]')
        for r in rows:
            log(f'  showcase dqn row {json.dumps(r)}')
        del tr, start, draws, runs
        torch.cuda.empty_cache()

        # --- PPO: 3 updates through the program, then uncaptured ---
        tr = PPOTrainer(S.ppo_config(0, 3), device='cuda')
        cfg = tr.config
        gen = torch.Generator(device='cuda')
        gen.manual_seed(72)
        draws = [ppo_draws(tr.env_cfg, cfg.num_envs, cfg.rollout_steps,
                           cfg.update_epochs, gen, 'cuda') for _ in range(3)]
        start = tr.init_state()
        runs = {}
        for name in ('graph', 'uncaptured'):
            zero_counts()
            record, times, cur = [], [], start
            t0 = time.perf_counter()
            if name == 'graph':
                for _, cur, m in S.ppo_updates(tr, start, 3, draws):
                    record.append((clone_tree(tr.trajectory), m))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            else:
                for d in draws:
                    cur = tr.collect_plain(cur, d)
                    traj = clone_tree(tr.trajectory)
                    cur, m = tr.learn(cur, d.perm)
                    record.append((traj, m))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            step, auto, mask = counts()
            if (step, auto, mask) != (0, 3 * cfg.rollout_steps, 0):
                raise AssertionError(
                    f'showcase PPO {name}: launches step {step}, '
                    f'step_autoreset {auto} for {3 * cfg.rollout_steps} '
                    f'rollout steps, safety_mask {mask}')
            runs[name] = (cur, record)
            out[f'ppo_{name}'] = {
                'ms_per_update': [1e3 * (b - a) for a, b in
                                  zip([0.0] + times[:-1], times)],
                'step_autoreset_launches': auto}
        check_equal(runs['graph'], runs['uncaptured'], 'PPO 3 updates')
        rows = [S.ppo_row(u, m, 0.0)
                for u, (_, m) in enumerate(runs['graph'][1], 1)]
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f'showcase PPO rows: {rows}')
        out['ppo_rows'] = rows
        log(f'showcase PPO (run_ppo config: 10x10x2, 128 envs, 64 steps), '
            f'3 updates: the rollout graph EQUAL to its uncaptured body '
            f'(states, trajectories, metrics; cuDNN deterministic); graph '
            f'{json.dumps(out["ppo_graph"])}, uncaptured '
            f'{json.dumps(out["ppo_uncaptured"])}; rows {json.dumps(rows)} '
            f'[{smi}]')
        del tr, start, draws, runs
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # --- PPO at 20x20x4: 2 updates through the program ---
    tr = PPOTrainer(S.ppo20_config(0, 2, tmp), device='cuda')
    zero_counts()
    times, t0 = [], time.perf_counter()
    rows = []
    for u, _, m in S.ppo_updates(tr, tr.init_state(), 2):
        rows.append(S.ppo_row(u, m, 0.0))
        times.append(time.perf_counter() - t0)
    step, auto, mask = counts()
    if (step, auto, mask) != (0, 2 * tr.config.rollout_steps, 0) or not all(
            math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f'showcase PPO20: launches step {step}, '
                             f'step_autoreset {auto}, safety_mask {mask}; '
                             f'rows {rows}')
    out['ppo20'] = {'ms_per_update': [1e3 * (b - a) for a, b in
                                      zip([0.0] + times[:-1], times)],
                    'step_autoreset_launches': auto, 'rows': rows}
    log(f'showcase PPO20 (run_ppo20 config: 20x20x4, length 5, 256 envs, '
        f'128 steps), 2 updates: {json.dumps(out["ppo20"])} [{smi}]')
    del tr
    torch.cuda.empty_cache()

    # --- the battle program: 128 envs x 512 steps ---
    zero_counts()
    summary = R.main(['--hybrid', os.path.join(tmp, 'neat.pkl'),
                      '--out', os.path.join(tmp, 'battle_run'),
                      '--profile-steps', '16'])
    step, auto, mask = counts()
    # the warm-up battle, the battle (each in whole chunks of 8, the last
    # running on after every env is done), the window's two battles
    want = summary['warmup_steps_run'] + summary['steps_run'] + 2 * 16
    if summary['steps_run'] != chunked(summary['steps'], 8):
        raise AssertionError(f'battle program: {summary}')
    if (step, auto, mask) != (want, 0, want):
        raise AssertionError(f'battle program: {summary["steps"]} steps, '
                             f'launches: step {step}, step_autoreset {auto}, '
                             f'safety_mask {mask} (want {want})')
    if not all(math.isfinite(v) for v in summary['mean_reward']) \
            or (smi and summary['card'] != smi):
        raise AssertionError(f'battle program: {summary}')
    with open(summary['table']) as f:
        log(f.read())
    out['battle'] = {k: v for k, v in summary.items() if k != 'table'}
    out['battle']['step_launches'] = step
    out['battle']['mask_launches'] = mask
    log(f'showcase battle program: {json.dumps(out["battle"])} [{smi}]')
    out['seconds'] = time.perf_counter() - t_phase
    log(f'showcase phase: {out["seconds"]:.1f} s')
    return out


# the config matrix's configs that K1 had not met on the card before it
# (bench_table.py's tags), each with its env count for the reduced parity
# run
BENCH_TABLE_NEW_K1 = {
    '20x20cross_x8_framestack4': 512,
    '30x30walls_x8_framestack4': 512,
    '20x20cross_x8_framestack4_packedobs': 512,
    '30x30walls_x8_framestack4_packedobs': 512,
    '40x40ml2_x4': 512,
    '10x10x1': 1024,
    '20x20x4_vision5_procedural': 1024,
    '20x20x4_full_obs_procedural_both': 1024,
}


def acting_opt_breakdown(smi: str) -> dict:
    """Where the device time of the config matrix's ``_opt`` acting row
    goes: a profiler window of one replay of its graph (64 steps at 4096
    envs of 20x20x4), K1's part of it, and a window of 64 of the row's
    re-encodes (``bench.acting_input``: ``engine.encode_frame`` from the
    grid, then the zero channels) on the same envs, uncaptured. The env
    step still writes its uint8 obs, which this row does not read: its
    bytes a step and their least time at the memory rate are beside."""
    from marlsnake_torch import bench
    from marlsnake_torch import bench_table as BT
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.rng import step_draws_seq

    cfg, n, steps = BT.ACTING_CONFIG, BT.ACTING_ENVS, 64
    env = VectorSnakeEnv(cfg, n, device='cuda', seed=0)
    states, obs = env.reset()
    loop = bench.ActingRollout(env, bench.acting_net(cfg, True, env.device),
                               steps, True, states, obs)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1)
    draws = step_draws_seq(cfg, n, steps, gen, env.device)
    graph = profile_device(lambda: float(loop(draws)), 1)
    k1_us = sum(v[0] for k, v in graph['kernels'].items()
                if KERNEL_NAME in k)

    @torch.no_grad()
    def reencode():
        for _ in range(steps):
            bench.acting_input(cfg, loop.envs.state, loop.envs.out.obs,
                               True)

    enc = profile_device(reencode, 1)
    obs_bytes = loop.envs.out.obs.numel()
    out = {'graph_busy_us_per_step': graph['busy_us'] / steps,
           'graph_idle_share': graph['idle_share'],
           'k1_us_per_step': k1_us / steps,
           'reencode_us_per_step': enc['busy_us'] / steps,
           'reencode_share': enc['busy_us'] / graph['busy_us'],
           'k1_share': k1_us / graph['busy_us'],
           'obs_write_bytes_per_step': obs_bytes,
           'obs_write_bound_us_per_step': obs_bytes / HBM_BYTES_PER_S * 1e6}
    log(f'_opt acting row at {n} envs ({steps}-step graph): '
        f'{json.dumps(out)} [{smi}]')
    log_window('profile of one replay of the _opt acting graph', graph,
               steps, smi, also=(KERNEL_NAME,))
    log_window(f'profile of {steps} _opt re-encodes, uncaptured', enc,
               steps, smi)
    return out


def bench_table_phase(smi: str) -> dict:
    """The config matrix (``marlsnake_torch/bench_table.py``): K1 against
    the plain engine over 64 steps (tolerance 0) at each config of
    ``BENCH_TABLE_NEW_K1``, at a reduced env count and at the table's,
    with its shared memory an env; then one short timed block of every row of the table (the
    auto-reset entry's launches set to 0 before a row and read after:
    every step of every call, replays included), with its graph's pool
    and the allocator's peak; where the ``_opt`` acting row's device
    time goes (``acting_opt_breakdown``); then K1's device_ms, bytes,
    bound and % of bound at the new configs at the table's env counts,
    on inputs first held against the plain engine (``time_autoreset``)."""
    from marlsnake_torch import bench_table as BT
    from marlsnake_torch.ops import step_kernel

    configs = {tag: (n, cfg) for tag, n, cfg, _ in BT.CONFIGS}
    errs = {}
    for i, (tag, parity_envs) in enumerate(BENCH_TABLE_NEW_K1.items()):
        cfg = configs[tag][1]
        log(f'--- bench_table config {tag}: {describe(cfg)}, '
            f'{step_kernel.smem_per_env(cfg)} B of shared memory an env ---')
        # at a reduced env count, then at the table's own
        errs[tag] = max(parity(cfg, parity_envs, 64, seed=300 + i),
                        parity(cfg, configs[tag][0], 64, seed=340 + i))
        torch.cuda.empty_cache()

    rows, launches = [], {}
    for row in BT.table():
        step_kernel.step_autoreset.launches = 0
        t0 = time.perf_counter()
        measured = BT.measure_row(row, 'cuda', iters=1, blocks=1)
        torch.cuda.synchronize()
        launches[row.tag] = step_kernel.step_autoreset.launches
        calls = 2 if row.kind == 'acting' else 3
        if launches[row.tag] != calls * row.scan_steps:
            raise AssertionError(f'bench_table {row.tag}: '
                                 f'{launches[row.tag]} launches for '
                                 f'{calls * row.scan_steps} steps')
        log(f'bench_table row ({time.perf_counter() - t0:.1f} s, '
            f'{launches[row.tag]} launches of step_autoreset): '
            f'{json.dumps(measured)} [{smi}]')
        rows.append(measured)
        torch.cuda.empty_cache()

    acting_opt = acting_opt_breakdown(smi)
    torch.cuda.empty_cache()

    timed = []
    for i, tag in enumerate(BENCH_TABLE_NEW_K1):
        n, cfg = configs[tag]
        auto, _, err_wide = time_autoreset(f'bt:{tag}', cfg, n, 320 + i,
                                           smi)
        errs[tag] = max(errs[tag], err_wide)
        timed.append(dict(
            auto, name=f'step_autoreset[bt:{tag}]', route='cuda',
            source='marlsnake_torch/csrc/step_autoreset.cu',
            replaces='marlsnake_tpu/ops/pallas_step.py:54',
            variant=describe(cfg), num_envs=n, launches=launches[tag],
            max_abs_err=errs[tag], max_abs_err_at_num_envs=err_wide,
            parity_envs=BENCH_TABLE_NEW_K1[tag],
            smem_per_env=step_kernel.smem_per_env(cfg)))
        torch.cuda.empty_cache()
    return {'max_abs_err': errs, 'launches': launches, 'rows': rows,
            'acting_opt': acting_opt, 'kernel_rows': timed}


def flagship_phase(smi: str, tmp: str) -> dict:
    """Evolution at the flagship scale over the trained DQN
    (``artifacts/hybrid_neat_20x20.pkl``'s ``dqn_params``; 20x20x4,
    length 5, DEFAULT_REWARD, 512-step episodes): first the step entry
    against the plain engine at the programs' widths (B=100, 257, 32,
    128; tolerance 0); then ``tools/neat_flagship.py``'s program for 2
    generations at pop 100, K=4, and ``tools/es_flagship.py``'s for 2
    generations at pop 256, K=4, 32 validation episodes and a holdout of
    64, each with the step entry launched once an env step (the counter
    set to 0 before and read after, against the program's env steps,
    which it reports by width); one fitness
    episode of 8 genomes on the trained features card against CPU; and
    16-step profiler windows of a trained fitness step at B=100 and
    B=257."""
    from marlsnake_torch.algo import neat as N
    from marlsnake_torch.algo import neat_hybrid as H
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import episode_draws
    from marlsnake_torch.tools import es_flagship as EF
    from marlsnake_torch.tools import neat_flagship as NF

    hybrid = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          NF.HYBRID)
    env_cfg = H._default_env_cfg()
    errs = {f'step B={b}': parity_step(env_cfg, b, 64, seed=400 + i)
            for i, b in enumerate((100, 257, 32, 128))}

    # each program's env steps by the episodes' env count
    want_widths = {'neat': {'100'}, 'es': {'257', '32', '128'}}
    runs = {}
    for name, program, kwargs in (
            ('neat', NF.run, dict(generations=2)),
            ('es', EF.run, dict(generations=2, holdout=64))):
        step_kernel.step.launches = 0
        step_kernel.step_autoreset.launches = 0
        t0 = time.perf_counter()
        summary = program(out=os.path.join(tmp, name), hybrid=hybrid,
                          device='cuda', **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = step_kernel.step.launches
        auto = step_kernel.step_autoreset.launches
        widths = summary['env_steps_by_width']
        log(f'{name} flagship program, 2 generations: {wall:.1f} s, '
            f'{summary["env_steps"]} env steps ({json.dumps(widths)} by '
            f'width), step launches={launches}, step_autoreset '
            f'launches={auto}; summary {json.dumps(summary)} [{smi}]')
        if launches != summary['env_steps'] or auto != 0 \
                or set(widths) != want_widths[name]:
            raise AssertionError(f'{name} flagship: '
                                 f'{summary["env_steps"]} env steps '
                                 f'({widths} by width) but {launches} '
                                 f'launches of step and {auto} of '
                                 f'step_autoreset')
        runs[name] = dict(summary, wall_s=wall, launches=launches,
                          launches_by_width=widths)

    # one fitness episode of 8 genomes on the trained features, card
    # against CPU
    dqn_params = NF.load_dqn_params(hybrid)
    neat_cfg = NF.neat_config()
    tr = H.HybridNEATTrainer(dqn_params, neat_cfg=neat_cfg,
                             episode_steps=512,
                             result_file=os.path.join(tmp, 'f.pkl'),
                             device='cuda')
    cpu_tr = H.HybridNEATTrainer(dqn_params, neat_cfg=neat_cfg,
                                 episode_steps=512,
                                 result_file=os.path.join(tmp, 'fc.pkl'),
                                 device='cpu')
    seed_genome = H.fc3_to_genome(tr.net, neat_cfg)
    eight = mutated_genomes(N, neat_cfg, seed_genome, 8, seed=41)
    d8 = episode_draws(env_cfg, 1, 512, torch.Generator().manual_seed(42),
                       'cpu')
    t0 = time.perf_counter()
    episode_check = episode_card_vs_cpu(tr, cpu_tr, eight, d8)
    log(f'one fitness episode of 8 genomes on the trained features (the '
        f'fc3 seed and mutants) card against CPU: '
        f'{json.dumps(episode_check)} ({time.perf_counter() - t0:.1f} s)')
    del cpu_tr

    # profiler windows of 16 trained fitness steps at B=100 and B=257
    hundred = H.PaddedNetBatch(mutated_genomes(N, neat_cfg, seed_genome,
                                               100, seed=43), neat_cfg,
                               device='cuda')
    windows = {}
    for label, width, make in (
            ('neat', 100, lambda: H.HybridNEATTrainer(
                dqn_params, neat_cfg=neat_cfg, episode_steps=16,
                result_file=os.path.join(tmp, 's.pkl'), device='cuda')),
            ('es', 257, lambda: H.HeadESTrainer(
                dqn_params, neat_cfg=neat_cfg, episode_steps=16,
                pop_size=256, result_file=os.path.join(tmp, 's.pkl'),
                device='cuda'))):
        short = make()
        rows = torch.zeros(width, dtype=torch.long)
        if label == 'neat':
            def one(short=short, rows=rows):
                short._episode(H.neat_head(hundred),
                               short._draws(1).take(rows))
        else:
            zeros_k = torch.zeros((128, 128, 3), device='cuda')
            zeros_b = torch.zeros((128, 3), device='cuda')

            def one(short=short, rows=rows, zk=zeros_k, zb=zeros_b):
                short._run(*short._member_batch(short._seed_theta, zk, zb),
                           short._draws(1).take(rows))
        for mode, captured in (('graph', True), ('uncaptured', False)):
            short.captured = captured
            windows[f'B={width} {mode}'] = dict(
                loop_window(f'trained fitness ({mode}, B={width}) [{label}]',
                            one, 16, smi),
                capture=list(short.captured_loops().values())[0].stats())

    # the fitness graphs of 512-step episodes: each against its
    # uncaptured chunks (a trainer that captured under deterministic
    # cuDNN), then graph against uncaptured in turns (another trainer)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(44)
    eps_k = torch.randn((128, 128, 3), generator=gen, device='cuda')
    eps_b = torch.randn((128, 3), generator=gen, device='cuda')
    graphs = {}
    for label, width in (('neat', 100), ('es', 257)):
        def make(label=label):
            if label == 'neat':
                t = H.HybridNEATTrainer(
                    dqn_params, neat_cfg=neat_cfg, episode_steps=512,
                    result_file=os.path.join(tmp, 'g.pkl'), device='cuda')
                return t, H.neat_head(hundred)
            t = H.HeadESTrainer(
                dqn_params, neat_cfg=neat_cfg, episode_steps=512,
                pop_size=256, result_file=os.path.join(tmp, 'g.pkl'),
                device='cuda')
            return t, H._Head(('es',), t._member_batch(t._seed_theta, eps_k,
                                                       eps_b), H._es_acts)

        rows = torch.zeros(width, dtype=torch.long)
        draws = [episode_draws(env_cfg, 1, 512, gen, 'cuda').take(rows)
                 for _ in range(3)]

        def episode(t, head, d, captured):
            t.captured = captured
            before = t.env_steps
            ret = torch.as_tensor(t._episode(head, d))
            return ret, t.env_steps - before

        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            det, head = make()
            episode(det, head, draws[0], True)             # the capture
            buffers, _ = det._loops[(width,) + head.key]
            row = {'equal': graph_equal(
                f'{label} fitness episode at B={width} x 512 steps',
                lambda: episode(det, head, draws[1], True),
                lambda: episode(det, head, draws[1], False), buffers, smi)}
            del det, buffers
        finally:
            torch.backends.cudnn.deterministic = deterministic
        tr_t, head = make()
        episode(tr_t, head, draws[0], True)                # the capture

        def played(captured, t=tr_t, head=head):
            def go():
                _, ran = episode(t, head, draws[2], captured)
                return ran, ran
            return go

        row['turns'] = in_turns(
            f'{label} fitness episode at B={width} x 512 steps (ms a step '
            f'run)', {'graph': played(True), 'uncaptured': played(False)},
            smi)
        # a second bucket of the same trainer (NEAT: the seed's clones,
        # another sweep count; ES: the validation width) captures into the
        # trainer's one pool: its pool_bytes is what the pool grew by
        tr_t.captured = True
        if label == 'neat':
            clones = H.PaddedNetBatch([seed_genome] * width, neat_cfg,
                                      device='cuda')
            tr_t._episode(H.neat_head(clones), draws[2])
        else:
            tr_t.validate(tr_t._seed_theta, 32)
        row['capture'] = {str(k): v.stats()
                          for k, v in tr_t.captured_loops().items()}
        graphs[label] = row
        log(f'{label} fitness graph at B={width}: {json.dumps(row)} [{smi}]')
        del tr_t
        torch.cuda.empty_cache()
    return {'max_abs_err': errs, 'runs': runs,
            'fitness_episode_card_vs_cpu': episode_check,
            'fitness_windows': windows, 'fitness_graphs': graphs}


def distill_phase(smi: str, tmp: str) -> dict:
    """The DAgger distillation (``marlsnake_torch/tools/distill_acting.py``)
    at the committed student's width: conv (32, 64), fc (128), bfloat16,
    E=256, batches of 4,096, the trained teacher of
    ``artifacts/hybrid_neat_20x20.pkl``. First K1 against the plain
    engine over one 32-step greedy rollout of the student with the
    iteration's own draws (tolerance 0); then the program's ``run`` for 3
    outer iterations, K1 launched once a rollout step (the counters set
    to 0 before and read after, no plain-engine call); one outer
    iteration card against CPU at a narrow size (4 envs, 4 SGD steps of
    256, float32 students, TF32 off, cuDNN deterministic): the visited
    obs, the env states, the labels and the agreement EQUAL, the loss and
    the parameters within 1e-5; then a profiler window of one full-width
    iteration (device busy, idle share, K1's device us a launch) and the
    allocator's peak."""
    from marlsnake_torch.algo import optim
    from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw
    from marlsnake_torch.core import engine
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import distill_draws
    from marlsnake_torch.tools import distill_acting as D
    from marlsnake_torch.algo.neat_hybrid import msgpack_unpack
    from marlsnake_torch.models.weights import distilled_dqn_from_flax

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    hybrid = os.path.join(root, D.HYBRID)
    teacher_params = load_hybrid_raw(hybrid)['dqn_params']
    cfg = D.env_config()
    conv, fc, e = D.COMMITTED['conv'], D.COMMITTED['fc'], 256
    dev = torch.device('cuda')
    out = {}

    def setup(seed):
        teacher = D.make_teacher(teacher_params, cfg, dev)
        student = D.make_student(cfg, conv, fc, dev)
        params = {k: v.detach() for k, v in student.named_parameters()}
        env = VectorSnakeEnv(cfg, e, device=dev, seed=seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        return teacher, student, params, env, env.reset(), gen

    # --- K1 against the plain engine over one iteration's rollout ---
    _, student, params, env, (states, obs), gen = setup(91)
    draws = distill_draws(cfg, e, D.ROLLOUT_STEPS, D.SGD_STEPS, D.BATCH,
                          gen, dev)
    tables = engine.spawn_tables(cfg, dev)
    err, resets = 0.0, 0
    with torch.no_grad():
        for t in range(D.ROLLOUT_STEPS):
            acts = D.greedy(student, params, obs.flatten(0, 1)).to(
                torch.int32).view(e, cfg.num_snakes)
            d = draws.step_at(t)
            want = engine.step_autoreset(cfg, tables, states, acts, d)
            got = env.step(states, acts, d)
            err = max(err, compare(got, want, f'distill rollout t={t}'))
            resets += int(got[1].done_all.sum())
            states, obs = got[0], got[1].obs
    if resets == 0:
        raise AssertionError('no auto-reset in the distill rollout')
    out['max_abs_err'] = err
    log(f'distill: K1 against the plain engine over a 32-step greedy '
        f'rollout of the student at E={e} with its draws: equal, {resets} '
        f'auto-resets, max_abs_err={err}')
    del env, states, obs, draws

    # --- the program: 3 outer iterations at full width ---
    step_kernel.step.launches = 0
    step_kernel.step_autoreset.launches = 0
    with PlainEngineCalls() as plain:
        summary = D.run(3, e, conv, fc, out=os.path.join(tmp, 'distill'),
                        hybrid=hybrid, device='cuda')
        torch.cuda.synchronize()
    launches = step_kernel.step_autoreset.launches
    want = 3 * D.ROLLOUT_STEPS
    if (launches, step_kernel.step.launches, plain.calls) != (want, 0, 0):
        raise AssertionError(
            f'distill program: step_autoreset {launches} launches for '
            f'{want} rollout steps, step {step_kernel.step.launches}, '
            f'plain engine {plain.calls} calls')
    if not (0.0 <= summary['agreement'] <= 1.0
            and math.isfinite(summary['loss'])) or summary['card'] != smi:
        raise AssertionError(f'distill program: {summary}')
    with open(summary['student'], 'rb') as f:
        written = distilled_dqn_from_flax(msgpack_unpack(f.read()))
    if {k: tuple(v.shape) for k, v in written.items()} != {
            k: tuple(v.shape) for k, v in student.state_dict().items()}:
        raise AssertionError('the written student is not the student')
    out['launches'] = launches
    out['program'] = {k: v for k, v in summary.items()
                      if k not in ('student', 'meta')}
    log(f'distill program (3 iterations, E={e}, conv {conv}, fc {fc}): '
        f'step_autoreset launches {launches}, no plain-engine call; '
        f'{json.dumps(out["program"])} [{smi}]')

    # --- one iteration, card against CPU, narrow ---
    out['card_vs_cpu'] = distill_card_vs_cpu(teacher_params)
    log(f'distill one iteration card against CPU (4 envs, 32 steps, 4 '
        f'SGD steps of 256, float32, cuDNN deterministic): obs, states, '
        f'data, labels and agreement equal, loss and parameters within '
        f'1e-5: {json.dumps(out["card_vs_cpu"])}')

    # --- a profiler window of one full-width iteration ---
    teacher, student, params, env, (states, obs), gen = setup(94)
    held = [params, optim.adam_init(list(params.values())), states, obs]

    def iteration():
        draws = distill_draws(cfg, e, D.ROLLOUT_STEPS, D.SGD_STEPS, D.BATCH,
                              gen, dev)
        res = D.outer_iteration(env, teacher, student, held[0], held[1],
                                held[2], held[3], draws)
        held[:] = [res.params, res.opt_state, res.states, res.obs]

    torch.cuda.reset_peak_memory_stats()
    window = profile_device(iteration, 1)
    k1 = [v for k, v in window['kernels'].items() if KERNEL_NAME in k]
    out['window'] = {k: window[k] for k in ('busy_us', 'span_us',
                                            'idle_share', 'wall_us',
                                            'dtoh', 'kernel_launches')}
    out['window']['device_events'] = sum(v[1] for v in
                                         window['kernels'].values())
    out['k1_device_us_per_launch'] = (sum(v[0] for v in k1)
                                      / sum(v[1] for v in k1))
    out['k1_launches_in_window'] = sum(v[1] for v in k1)
    out['max_memory_allocated'] = torch.cuda.max_memory_allocated()
    log_window('profile of one outer iteration of the distillation (E=256, '
               'conv 32,64, fc 128)', window, 1, smi, also=(KERNEL_NAME,))
    log(f'distill: K1 {out["k1_device_us_per_launch"]:.2f} us a launch at '
        f'E={e} in the window ({out["k1_launches_in_window"]} launches), '
        f'allocator peak {out["max_memory_allocated"]} B [{smi}]')
    out['seconds'] = time.perf_counter() - t_phase
    log(f'distill phase: {out["seconds"]:.1f} s')
    return out


def distill_card_vs_cpu(teacher_params) -> dict:
    """One outer iteration of the distillation on the card against the
    same on the CPU, narrow (4 envs, 32 rollout steps, 4 SGD steps of
    256, the committed student's widths in float32, the trained
    teacher): the card's ``outer_iteration`` EQUAL to its own parts
    (cuDNN deterministic), and the parts card against CPU: the visited
    obs, env states and labels EQUAL, each step's gradients within
    1e-5 + 1e-4 x max|g| (a TD update's tolerance), the loss and the
    parameters after the 4 steps within 1e-5, the agreement EQUAL."""
    from marlsnake_torch.algo import optim
    from marlsnake_torch.algo.dqn_trainer import mean_of
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.rng import distill_draws
    from marlsnake_torch.tools import distill_acting as D

    cfg = D.env_config()
    conv, fc = D.COMMITTED['conv'], D.COMMITTED['fc']
    # The card's iteration through ``outer_iteration`` and again in its
    # parts (EQUAL, cuDNN deterministic), the parts on the CPU beside
    # them. Where a gradient component is within rounding of zero on both
    # sides (|g| < Adam's eps, 1e-8), Adam's update lr * g / (|g| + eps)
    # is no longer sign-like: it magnifies the two sides' rounding
    # difference there by up to lr / eps = 3e4. The CPU chain takes the
    # card's gradient at those components (counted), its own elsewhere.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        narrow, eps = 4, 1e-8
        cpu_env = VectorSnakeEnv(cfg, narrow, device='cpu', seed=92)
        start = cpu_env.reset()
        cpu_draws = distill_draws(cfg, narrow, D.ROLLOUT_STEPS, 4, 256,
                                  torch.Generator().manual_seed(93), 'cpu')
        sides = {}
        for where in ('cpu', 'cuda'):
            def to(x, where=where):
                return x.to(where)
            student = D.make_student(cfg, conv, fc, where, torch.float32)
            sides[where] = dict(
                env=VectorSnakeEnv(cfg, narrow, device=where),
                teacher=D.make_teacher(teacher_params, cfg, where),
                student=student,
                params={k: v.detach() for k, v in
                        student.named_parameters()},
                states=start[0].replace(**{k: to(v) for k, v in
                                           start[0].fields()}),
                obs=to(start[1]),
                draws=type(cpu_draws)(
                    type(cpu_draws.step)(*map(to, cpu_draws.step)),
                    to(cpu_draws.idx)))
        card = sides['cuda']
        whole = D.outer_iteration(
            card['env'], card['teacher'], card['student'], card['params'],
            optim.adam_init(list(card['params'].values())), card['states'],
            card['obs'], card['draws'])
        for sd in sides.values():
            with torch.no_grad():
                sd['states'], sd['obs'], sd['data'] = D.rollout(
                    sd['env'], sd['student'], sd['params'], sd['states'],
                    sd['obs'], sd['draws'])
                sd['q'] = sd['teacher'](sd['data'])
                sd['labels'] = sd['q'].argmax(-1)
        cpu = sides['cpu']
        for name in ('states', 'obs', 'data', 'labels'):
            same_tree(whole._asdict()[name], card[name],
                      f'distill card: outer_iteration against its parts: '
                      f'{name}')
            got = card[name]
            got = (got.replace(**{k: v.cpu() for k, v in got.fields()})
                   if name == 'states' else got.cpu())
            same_tree(got, cpu[name], f'distill card against CPU: {name}')

        chains = {'card': card['params'], 'cpu': cpu['params']}
        opts = {k: optim.adam_init(list(v.values()))
                for k, v in chains.items()}
        losses = {k: [] for k in chains}
        substituted, grad_use = 0, 0.0
        for rows in cpu_draws.idx:
            grads = {}
            for k, sd in (('card', card), ('cpu', cpu)):
                r = rows.to(sd['data'].device)
                loss, grads[k] = D.loss_and_grads(
                    sd['student'], chains[k], sd['data'][r],
                    sd['labels'][r], sd['q'][r])
                losses[k].append(loss.cpu())
            mixed = []
            for a, b in zip(grads['cpu'], grads['card']):
                b = b.cpu()
                grad_use = max(grad_use, float((a - b).abs().max())
                               / (1e-5 + 1e-4 * float(a.abs().max())))
                tiny = (a.abs() < eps) & (b.abs() < eps)
                substituted += int((tiny & (a != b)).sum())
                mixed.append(torch.where(tiny, b, a))
            grads['cpu'] = mixed
            for k in chains:
                chains[k], opts[k] = D.adam_step(chains[k], opts[k],
                                                 grads[k])
        same_tree(chains['card'], whole.params,
                  'distill card: outer_iteration against its parts: params')
        loss = {k: float(mean_of(torch.stack(v))) for k, v in
                losses.items()}
        if loss['card'] != float(whole.loss):
            raise AssertionError('distill card: outer_iteration against its '
                                 'parts: loss')

        with torch.no_grad():
            cpu_agree = float(mean_of((D.greedy(
                cpu['student'], chains['cpu'], cpu['data'])
                == cpu['labels']).to(torch.float32)))
        result = {
            'envs': narrow, 'sgd_steps': 4, 'batch': 256,
            'agreement': float(whole.agreement), 'loss': loss['card'],
            'loss_abs_diff': abs(loss['card'] - loss['cpu']),
            'param_max_abs_diff': max(
                float((chains['card'][n].cpu() - v).abs().max())
                for n, v in chains['cpu'].items()),
            'substituted_components': substituted,
            'grad_share_of_tolerance': grad_use}
        if (grad_use > 1.0 or result['loss_abs_diff'] > 1e-5
                or result['param_max_abs_diff'] > 1e-5
                or cpu_agree != float(whole.agreement)):
            raise AssertionError(
                f'distill card against CPU: gradients at {grad_use} of '
                f'1e-5 + 1e-4 x max|g|, loss and parameters within 1e-5, '
                f'agreement {float(whole.agreement)} against {cpu_agree}')
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return result



def demos_phase(smi: str) -> dict:
    """The two rollout demos (``marlsnake_torch/examples/demo.py`` and
    ``vector_rollout.py``) at their defaults: first K1 against the plain
    engine over the demo's first 64 steps at B=1024 with its own actions
    and draws (tolerance 0); then each program's ``main``, K1 launched
    once a step of its two rollouts (the counters set to 0 before and
    read after, no plain-engine call), and their env-steps/s."""
    from marlsnake_torch.core import engine
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.examples import demo
    from marlsnake_torch.examples import vector_rollout as V
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import rollout_draws

    out = {}
    cfg = demo.demo_config()
    env = VectorSnakeEnv(cfg, 1024, device='cuda')
    states, _ = env.reset(0)
    actions, draws = rollout_draws(cfg, 1024, 256, env.generator, 'cuda')
    tables = engine.spawn_tables(cfg, torch.device('cuda'))
    err, resets = 0.0, 0
    for t in range(64):
        d = draws.at(t)
        want = engine.step_autoreset(cfg, tables, states, actions[t], d)
        got = env.step(states, actions[t], d)
        err = max(err, compare(got, want, f'demo t={t}'))
        resets += int(got[1].done_all.sum())
        states = got[0]
    if resets == 0:
        raise AssertionError('no auto-reset in the demo parity run')
    out['max_abs_err'] = err
    log(f'demo: K1 against the plain engine over the first 64 steps at '
        f'B=1024 (20x20x4, length 5) with its draws: equal, {resets} '
        f'auto-resets, max_abs_err={err}')
    del env, states, actions, draws

    for name, program, want in (('demo', demo.main, 2 * 256),
                                ('vector_rollout', V.main, 2 * V.STEPS)):
        step_kernel.step.launches = 0
        step_kernel.step_autoreset.launches = 0
        with PlainEngineCalls() as plain:
            summary = program([])
            torch.cuda.synchronize()
        launches = step_kernel.step_autoreset.launches
        if (launches, step_kernel.step.launches, plain.calls) != (want, 0,
                                                                  0):
            raise AssertionError(f'{name}: step_autoreset {launches} '
                                 f'launches for {want} steps, step '
                                 f'{step_kernel.step.launches}, plain '
                                 f'engine {plain.calls} calls')
        if summary['card'] != smi or not summary['env_steps_per_s'] > 0:
            raise AssertionError(f'{name}: {summary}')
        out[name] = dict(summary, launches=launches)
        log(f'{name}: {json.dumps(out[name])} [{smi}]')
    if not (out['demo']['fruits'] > 0 and out['demo']['deaths'] > 0
            and math.isfinite(out['vector_rollout']['mean_reward'])):
        raise AssertionError(f'demos: {out}')
    return out


def masked_paths(smi: str, steps: int = 128) -> dict:
    """ms per step (host clock) and a profiler window of 16 steps (device
    events, busy us, idle share a step) of the three masked paths, through
    their public entry points alone, which the parent tree's package has
    too (``--masked-paths DIR``): evaluate_batch at 256 envs of 20x20x4
    (the DQN trainer's env config), build_battle_batch at 128 envs of
    20x20x4 (length 5) against an untrained PPO, Greedy and Random, and
    DQNEvaluator at B=1 (20x20x4, length 5); up to ``steps`` steps each
    after a short warm-up, DQN weights from seed 0."""
    from marlsnake_torch.algo import battle_batch as BB
    from marlsnake_torch.algo.dqn_trainer import DQNConfig
    from marlsnake_torch.algo.evaluator import (DQNEvaluator,
                                                build_evaluate_batch)
    from marlsnake_torch.core.types import EnvConfig
    from marlsnake_torch.envs.env import SnakeEnv
    from marlsnake_torch.envs.wrappers import GymAdapter
    from marlsnake_torch.models.dqn import make_dqn
    from marlsnake_torch.models.ppo import ActorCritic

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {}

    def timed(name, run, short):
        short(0)   # warm-up at the same shapes
        run(0)     # a loop of the port's chunks captures on its first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        taken = run(1)
        wall = time.perf_counter() - t0
        counted = [0]
        window = profile_device(lambda: counted.__setitem__(0, short(2)), 1)
        result[name] = dict(window_summary(window, counted[0]),
                            ms_per_step=wall / taken * 1e3, steps=taken,
                            window_steps=counted[0])
        log(f'{name}: {wall / taken * 1e3:.3f} ms a step over {taken} '
            f'steps; window of {counted[0]} steps: '
            f'{json.dumps(result[name])} [{smi}]')

    cfg = DQNConfig().env_config()
    net = make_dqn(cfg, seed=0, device='cuda')
    ev_long = build_evaluate_batch(net, cfg, 256, steps, 60, device='cuda')
    ev_short = build_evaluate_batch(net, cfg, 256, 16, 60, device='cuda')

    def evaluate(fn, seed):
        r = fn(seed=seed)
        float(r.mean_reward)
        return r.steps

    timed('evaluate_batch (256 envs)', lambda seed: evaluate(ev_long, seed),
          lambda seed: evaluate(ev_short, seed))

    bcfg = EnvConfig(height=20, width=20, num_snakes=4, snake_length=5)
    bnet = make_dqn(bcfg, seed=0, device='cuda')
    torch.manual_seed(0)
    ppo = ActorCritic((20, 20), assume_binary_obs=True, device='cuda')
    lineup = [BB.BatchedPPO(ppo), BB.BatchedGreedy(), BB.BatchedRandom()]
    b_long = BB.build_battle_batch(bnet, bcfg, lineup, 128, steps,
                                   device='cuda')
    b_short = BB.build_battle_batch(bnet, bcfg, lineup, 128, 16,
                                    device='cuda')

    def battle(fn, seed):
        _, life = fn(seed=seed)
        return int(life.max())

    timed('build_battle_batch (128 envs)', lambda seed: battle(b_long, seed),
          lambda seed: battle(b_short, seed))

    env = GymAdapter(SnakeEnv(bcfg, device='cuda'), seed=2)
    evaluator = DQNEvaluator(env, bnet)
    env_steps, inner = [0], env.step

    def counted_step(actions, **kwargs):
        env_steps[0] += 1
        return inner(actions, **kwargs)

    env.step = counted_step

    def episode(max_steps):
        env_steps[0] = 0
        evaluator.evaluate(num_episodes=1, max_steps=max_steps,
                           verbose=False)
        return env_steps[0]

    timed('DQNEvaluator (B=1)', lambda seed: episode(steps),
          lambda seed: episode(16))
    return result


def mask_kernel_times(smi: str) -> dict:
    """Both safety-mask entries timed (``time_mask``, ``time_fill``) at the
    shapes of the masked paths, on the 8th step of envs driven by the
    mask's own choices (``mask_rollout``), through the public entries that
    a parent tree's package has too: the evaluator's E=256 x N=4 and
    DQNEvaluator's E=1 x N=4 of 20x20 (the DQN trainer's env config), the
    battle's seat 0 (E=128, N=1: a view of the first snake of 20x20x4,
    length 5), and the fill of the first and the last's post-move boards
    (3,072 and 384)."""
    from marlsnake_torch.algo.dqn_trainer import DQNConfig
    from marlsnake_torch.core.types import EnvConfig

    def eighth(cfg, num_envs, seed):
        return next(inputs for t, inputs in enumerate(
            mask_rollout(cfg, num_envs, 8, seed=seed)) if t == 7)

    cfg = DQNConfig().env_config()
    evaluator = eighth(cfg, 256, 81)
    dqn_evaluator = eighth(cfg, 1, 82)
    obs, q, dirs, active, _ = eighth(
        EnvConfig(height=20, width=20, num_snakes=4, snake_length=5), 128,
        83)
    seat0 = (obs[:, :1], q[:, :1], dirs[:, :1], active[:, :1], None)
    rows = {}
    for name, inputs in (('E=256, N=4', evaluator), ('E=128, N=1', seat0),
                         ('E=1, N=4', dqn_evaluator)):
        rows[f'masked_actions {name}'] = time_mask(
            f'safety_mask at {name}, 20x20', inputs, 60, smi)
    for inputs in (evaluator, seat0):
        _, boards, starts, _ = plain_fill_inputs(inputs, 60)
        rows[f'reachable_count {boards.shape[0]} boards'] = time_fill(
            f'reachable_count at {boards.shape[0]} boards of 20x20, limit 60',
            boards, starts, 60, smi)
    return rows


def mask_phase_times(smi: str) -> dict:
    """Where masked_actions' time goes: its device time (torch.profiler)
    when built to return after its first k phases (``-DMARLSNAKE_MASK_PHASES
    =k``: 0 the launch alone, 1 the load and scan, 2 the vetoes, 3 the
    fills, 4 the claims and outputs, the whole kernel) at the evaluator's
    E=256 x N=4 and DQNEvaluator's E=1 x N=4 of 20x20, on the inputs of
    ``mask_kernel_times``. The cut copies are built, one nvcc each, all at
    once, into build/mask_phases/."""
    from marlsnake_torch.algo.dqn_trainer import DQNConfig
    from marlsnake_torch.ops import cuda_build, mask_kernel
    from marlsnake_torch.ops import safety_mask as SM

    out = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), 'mask_phases')
    os.makedirs(out, exist_ok=True)
    procs = []
    for k in range(4):
        path = os.path.join(out, f'safety_mask_phases{k}.so')
        procs.append((path, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
             f'-DMARLSNAKE_MASK_PHASES={k}', '-o', path, mask_kernel.SOURCE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for path, proc in procs:
        log_text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {path}:\n{log_text}')
        libs.append(mask_kernel.bind_library(path))
    libs.append(mask_kernel.load_library())
    cfg = DQNConfig().env_config()
    shapes = {}
    for name, num_envs, seed in (('E=256, N=4', 256, 81), ('E=1, N=4', 1, 82)):
        shapes[name] = next(inputs for t, inputs in enumerate(
            mask_rollout(cfg, num_envs, 8, seed=seed)) if t == 7)
    phases = ('launch', 'load and scan', 'vetoes', 'fills',
              'claims and outputs')
    real = mask_kernel.load_library
    result = {}
    try:
        for name, inputs in shapes.items():
            row = {}
            for phase, lib in zip(phases, libs):
                mask_kernel.load_library = lambda lib=lib: lib
                row[phase] = kernel_device_us(
                    lambda: SM.safety_mask(*inputs), MASK_KERNEL_NAME, 100)
            result[name] = row
            log(f'masked_actions at {name}, 20x20, device us up to the end '
                f'of each phase: {json.dumps(row)} [{smi}]')
    finally:
        mask_kernel.load_library = real
    return result


def masked_paths_main(root: str, phases: bool = False) -> int:
    """``python3 chip_smoke.py --masked-paths [DIR]``: ``masked_paths`` and
    ``mask_kernel_times`` against the marlsnake_torch package in DIR
    (default: this checkout; the package must have the profiler window
    and card label of ``utils/profiling.py``, ``device_profile`` and
    ``card_label``), one JSON line; ``--mask-phases``: then
    ``mask_phase_times`` of this checkout's kernel."""
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    import marlsnake_torch
    from marlsnake_torch.utils.profiling import card_label
    smi = card_label('cuda:0')
    log(smi)
    package = os.path.dirname(os.path.abspath(marlsnake_torch.__file__))
    log(f'package: {package}')
    result = masked_paths(smi)
    kernels = mask_kernel_times(smi)
    log(json.dumps({'masked_paths': result, 'mask_kernels': kernels,
                    'package': package, 'device': smi}))
    if phases:
        log(json.dumps({'mask_phases': mask_phase_times(smi),
                        'device': smi}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    # the port only: no module of JAX or of the JAX package is imported
    from marlsnake_torch import bench
    from marlsnake_torch.algo import replay
    from marlsnake_torch.algo.acting import select_actions
    from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
    from marlsnake_torch.core import engine
    from marlsnake_torch.core.types import EnvConfig
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.models.dqn import make_dqn
    from marlsnake_torch.ops import cuda_build, mask_kernel, step_kernel
    from marlsnake_torch.ops.obs_pack import unpack_obs
    from marlsnake_torch.rng import reset_draws, step_draws, train_draws
    from marlsnake_torch.utils.profiling import card_label

    # --- 1. the card ---
    smi = card_label('cuda:0')
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {kind} count {torch.cuda.device_count()}')

    # --- 2. build: one nvcc a source, started together ---
    t0 = time.perf_counter()
    built = cuda_build.build(step_kernel.SOURCE, mask_kernel.SOURCE)
    step_kernel.load_library()
    mask_kernel.load_library()
    log(f'build: {time.perf_counter() - t0:.2f} s -> '
        f'{", ".join(os.path.relpath(p) for p, _ in built)}')
    for line in built[0][1].splitlines():
        log(f'  nvcc: {line}')
    # the safety mask's 48 instances: registers, stack, spills, smem
    ptxas = ptxas_summary(built[1][1])
    for name, info in ptxas.items():
        log(f'  ptxas {name}: {json.dumps(info)}')
    # the instances a 20x20 board runs (its planes all fit shared memory)
    for name in ('masked_actions_kernel<1, 1, shared>',
                 'reachable_count_kernel<1, 1>'):
        if not ptxas:
            log('  ptxas: the library was built before, no report')
            break
        if ptxas[name]['spill_stores'] or ptxas[name]['spill_loads']:
            raise AssertionError(f'{name} (20x20) spills: {ptxas[name]}')
    log('  dynamic shared memory of a masked_actions block: ' + ', '.join(
        f'{n} snakes of {h}x{w} {mask_kernel.smem_per_env(n, h, w)} B + '
        f'{mask_kernel.extra_planes_bytes(n, h, w)} B of other planes'
        for n, h, w in ((4, 20, 20), (1, 20, 20), (8, 40, 40)))
        + '; reachable_count uses none')

    # --- 3. kernel against the plain version ---
    small = dict(height=10, width=10, num_snakes=2, snake_length=3)
    big = dict(height=20, width=20, num_snakes=4, snake_length=3)
    wide = dict(height=40, width=40, num_snakes=8, snake_length=3)
    err = max(parity(EnvConfig(**small), 64, 64, seed=1),
              parity(EnvConfig(**small, done_mode='any'), 64, 64, seed=2),
              parity(EnvConfig(**big), 4096, 64, seed=3),
              parity(EnvConfig(**wide), 1024, 64, seed=4))
    # ... and both entries of the safety mask against theirs
    mask_parity = mask_parity_phase(smi)

    # --- 4. the main path: acting rollout at full width ---
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f'tf32: cudnn={torch.backends.cudnn.allow_tf32} '
        f'matmul={torch.backends.cuda.matmul.allow_tf32}')
    cfg = EnvConfig(**big)
    num_envs, steps, eps = 4096, 16, 0.1
    env = VectorSnakeEnv(cfg, num_envs, device='cuda', seed=7)
    net = make_dqn(cfg, seed=0, device='cuda')
    gen = torch.Generator(device=env.device)
    gen.manual_seed(8)
    states, obs = env.reset()
    dones = torch.zeros((num_envs, cfg.num_snakes), dtype=torch.bool,
                        device=env.device)
    step_kernel.step_autoreset.launches = 0
    for t in range(steps):
        actions = select_actions(net, obs, dones, eps, gen, cfg.num_actions)
        last = (states, actions, step_draws(cfg, num_envs, env.generator,
                                            env.device))
        states, out = env.step(*last)
        obs, dones = out.obs, out.done
    torch.cuda.synchronize()
    launches = step_kernel.step_autoreset.launches
    log(f'main path: {steps} acting steps, {num_envs} envs, '
        f'step_autoreset launches={launches}')
    if launches != steps:
        raise AssertionError(f'expected {steps} kernel launches on the main '
                             f'path, counted {launches}')
    # what came out: the last step equals the plain version; obs one-hot
    tables = engine.spawn_tables(cfg, env.device)
    compare((states, out), engine.step_autoreset(cfg, tables, *last),
            'main path last step')
    if obs.shape != (num_envs,) + cfg.obs_shape or obs.dtype != torch.uint8:
        raise AssertionError(f'obs {obs.dtype} {tuple(obs.shape)}')
    if int(obs.max()) > 1:
        raise AssertionError('obs is not one-hot')
    with torch.no_grad():
        q = net(obs.reshape((-1,) + cfg.obs_shape[1:]))
    if q.shape != (num_envs * cfg.num_snakes, cfg.num_actions) \
            or not bool(torch.isfinite(q).all()):
        raise AssertionError('Q-values are not finite or of wrong shape')
    log(f'main path ok: obs {tuple(obs.shape)}, q {tuple(q.shape)} finite, '
        f'{int(out.done_all.sum())} envs reset in the last step')

    # --- 5. times of the acting rollout ---
    s, a, d = last
    outputs = step_kernel.step_autoreset(cfg, tables, s, a, d)
    auto = time_entry(
        f'step_autoreset at B={num_envs} 20x20x4', KERNEL_NAME,
        lambda st: step_kernel.step_autoreset(cfg, tables, st, a, d),
        lambda: engine.step_autoreset(cfg, tables, s, a, d), s,
        kernel_traffic(cfg, s, a, d, outputs), smi)
    auto['device_us_by_pacing'] = pacing_probe(
        f'step_autoreset at B={num_envs} 20x20x4', KERNEL_NAME,
        lambda st: step_kernel.step_autoreset(cfg, tables, st, a, d), s, smi)
    flat_obs = obs.reshape((-1,) + cfg.obs_shape[1:])
    with torch.no_grad():
        forward_ms = event_ms(lambda: net(flat_obs), 10)
    log(f'acting forward ({num_envs * cfg.num_snakes} agents, fp32): '
        f'{forward_ms:.5f} ms [{smi}]')
    b = bench.run(num_envs=4096, num_steps=256, iters=4, device='cuda',
                  spawn_mode='pool')
    log(f'bench: {json.dumps(b)} [{smi}]')

    bench_env = VectorSnakeEnv(cfg, num_envs, device='cuda', seed=9)
    bench_states, _ = bench_env.reset()
    bench_gen = torch.Generator(device=bench_env.device)
    bench_gen.manual_seed(10)
    held = [bench_states]
    bench_roll = bench.Rollout(bench_env, 16)

    def bench_steps():
        held[0], r = bench_roll.random(held[0], bench_gen)

    window = profile_device(bench_steps, 1)
    log_window('profile of 16 bench steps', window, 16, smi,
               also=(KERNEL_NAME,))
    bench_idle = window['idle_share']
    del bench_env, bench_states, held, outputs, last, s, states, out, obs
    del bench_roll
    torch.cuda.empty_cache()

    # --- 6. the entry without auto-reset against engine.step ---
    step_err = max(
        parity_step(EnvConfig(**small), 64, 64, seed=11),
        parity_step(EnvConfig(**small, done_mode='any'), 64, 64, seed=12),
        parity_step(EnvConfig(**big), 4096, 64, seed=13),
        parity_step(EnvConfig(**wide), 1024, 64, seed=14))

    # ... and at the training path's own shape and config, with its hold
    train_env_cfg = DQNConfig(snake_length=3).env_config()
    train_step_err = max(
        parity_step(train_env_cfg, 256, 64, seed=17),
        parity_step(train_env_cfg, 256, 64, seed=18, hold=True))
    step_err = max(
        step_err,
        parity_step(EnvConfig(**small, done_mode='any'), 64, 64, seed=19,
                    hold=True),
        parity_step(EnvConfig(**wide), 1024, 64, seed=20, hold=True),
        # an odd board: rows that are no multiple of 16 or 4 bytes
        parity_step(EnvConfig(height=11, width=9, num_snakes=3,
                              snake_length=3), 64, 64, seed=21, hold=True))

    # --- 7. the replay ring, card against CPU ---
    replay_parity(seed=15)

    # --- 8. the training path at full width ---
    def train_config(**kwargs):
        return DQNConfig(**{**dict(num_envs=256, snake_length=3,
                                   max_steps_per_episode=256), **kwargs})

    trainer = DQNTrainer(train_config(), device='cuda')
    tcfg = trainer.config
    if trainer.env_cfg != train_env_cfg:
        raise AssertionError('the step entry was held against its plain '
                             'version at another config than the '
                             "trainer's")
    if (tcfg.height, tcfg.width, tcfg.num_snakes, tcfg.batch_size,
            tcfg.buffer_size, tcfg.min_buffer_size) != (20, 20, 4, 512,
                                                        10_000, 1536):
        raise AssertionError('the training defaults moved')
    ts = trainer.init_state()
    first = {k: v.clone() for k, v in ts.params.items()}
    step_kernel.step.launches = 0
    env_steps, episodes = 0, []
    for _ in range(2):
        ts, m = trainer.train_episode(ts)
        env_steps += chunked_steps(trainer, m)
        episodes.append(m)
    torch.cuda.synchronize()
    train_launches = step_kernel.step.launches
    last_m = episodes[-1]
    train_graph, = trainer.captured_loops()
    log(f'training path: 2 episodes at {tcfg.num_envs} envs, '
        f'{[int(m.episode_length) for m in episodes]} steps, '
        f'{[m.updates for m in episodes]} updates, mean loss '
        f'{[float(m.mean_loss) for m in episodes]}, mean reward '
        f'{[float(m.mean_reward) for m in episodes]}, step launches='
        f'{train_launches} over {env_steps} steps run in chunks of '
        f'{trainer.chunk_steps} (the last chunk of an episode runs on '
        f'after its last env), ring size {int(ts.buffer.size)}; the '
        f'chunk graph {json.dumps(train_graph.stats())}')
    if train_launches != env_steps or train_graph.replays == 0:
        raise AssertionError(f'{env_steps} env steps on the training path '
                             f'but {train_launches} kernel launches, '
                             f'{train_graph.replays} graph replays')
    if last_m.updates <= 0 or ts.global_step != sum(m.updates
                                                    for m in episodes):
        raise AssertionError('no optimizer update in the second episode')
    if not all(bool(torch.isfinite(m.mean_loss)) for m in episodes) \
            or float(last_m.mean_loss) <= 0.0:
        raise AssertionError('the training loss is not finite and positive')
    # size == min(pushed, capacity): until the ring is full the write
    # pointer equals the size, and the first step of each episode alone
    # pushes every agent
    size, ptr = int(ts.buffer.size), int(ts.buffer.ptr)
    at_least = min(2 * tcfg.num_envs * tcfg.num_snakes, tcfg.buffer_size)
    if not (at_least <= size <= tcfg.buffer_size) \
            or (size < tcfg.buffer_size and ptr != size):
        raise AssertionError(f'ring size {size}, ptr {ptr}')
    if not any(not torch.equal(ts.params[k], first[k]) for k in first):
        raise AssertionError('the parameters did not change')
    if not all(torch.equal(ts.target_params[k], first[k]) for k in first):
        raise AssertionError('the target parameters changed before a sync')
    if not all(bool(torch.isfinite(v).all()) for v in ts.params.values()):
        raise AssertionError('parameters are not finite')
    log('training path ok: launches equal the env steps the chunk graphs '
        'ran, updates made, loss finite, parameters moved, target '
        'parameters unchanged')

    # --- 9. one TD update, card against CPU ---
    u = torch.rand((tcfg.buffer_size,), generator=trainer.generator,
                   device='cuda')
    batch = replay.sample(ts.buffer, tcfg.batch_size, u)
    loss, grads, _ = trainer.loss_and_grads(ts.params, ts.target_params,
                                            batch)
    cpu_trainer = DQNTrainer(train_config(), device='cpu')
    cpu_loss, cpu_grads, _ = cpu_trainer.loss_and_grads(
        {k: v.cpu() for k, v in ts.params.items()},
        {k: v.cpu() for k, v in ts.target_params.items()},
        tuple(x.cpu() for x in batch))
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    worst = 0.0
    for name, g, c in zip(ts.params, grads, cpu_grads):
        scale = float(c.abs().max())
        diff = float((g.cpu() - c).abs().max())
        worst = max(worst, diff / (1e-5 + 1e-4 * scale))
        if diff > 1e-5 + 1e-4 * scale:
            raise AssertionError(f'TD update: gradient of {name} differs '
                                 f'by {diff} (largest magnitude {scale})')
    if loss_rel > 1e-5:
        raise AssertionError(f'TD update: loss {float(loss)} on the card, '
                             f'{float(cpu_loss)} on the CPU')
    log(f'one TD update (batch {tcfg.batch_size}) card against CPU: loss '
        f'{float(loss)} vs {float(cpu_loss)} (relative difference '
        f'{loss_rel:.3g}, limit 1e-5); the gradients use at most '
        f'{worst:.3g} of their tolerance 1e-5 + 1e-4 x max|g|')
    del cpu_trainer, cpu_grads

    # --- 10. a full checkpoint round trip on the card ---
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as save_dir:
        trainer.config.save_dir = save_dir
        trainer.save_checkpoint(ts, 'smoke', full=True)
        other = DQNTrainer(train_config(save_dir=save_dir, seed=99),
                           device='cuda')
        ts_other, _ = other.load_checkpoint('smoke', other.init_state(),
                                            full=True)
    # the trainer's graph holds the cuDNN algorithms of its capture (not
    # deterministic): it runs its chunks uncaptured here, the fresh
    # trainer captures its own under deterministic cuDNN
    ts, m_a = trainer.train_episode_plain(ts)
    ts_other, m_b = other.train_episode(ts_other)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = deterministic
    got_a = (m_a.episode_length, m_a.updates, float(m_a.mean_reward),
             float(m_a.mean_loss))
    got_b = (m_b.episode_length, m_b.updates, float(m_b.mean_reward),
             float(m_b.mean_loss))
    if got_a != got_b or not all(torch.equal(ts.params[k],
                                             ts_other.params[k])
                                 for k in ts.params):
        raise AssertionError(f'after a full checkpoint round trip the next '
                             f'episode differs: {got_a} vs {got_b}')
    log(f'checkpoint round trip (full) on the card: the next episode is '
        f'equal from both (uncaptured from the saved trainer, a graph in '
        f'the loaded one), (length, updates, mean reward, mean loss) = '
        f'{got_a}')
    del other, ts_other

    # --- 11. times of the training path ---
    tenv = trainer.env_cfg
    gen = torch.Generator(device='cuda')
    gen.manual_seed(16)
    tables_t = engine.spawn_tables(tenv, torch.device('cuda'))
    step_rows = {}
    for b_envs in (256, 4096):
        st, _ = engine.reset(tenv, tables_t,
                             reset_draws(tenv, b_envs, gen, 'cuda'))
        acts = torch.randint(0, 3, (b_envs, 4), generator=gen,
                             device='cuda', dtype=torch.int32)
        fruit_u = torch.rand((b_envs, 4), generator=gen, device='cuda')
        st, outp = step_kernel.step(tenv, st, acts, fruit_u)
        step_rows[b_envs] = time_entry(
            f'step (no reset) at B={b_envs} 20x20x4', STEP_KERNEL_NAME,
            lambda x: step_kernel.step(tenv, x, acts, fruit_u),
            lambda: engine.step(tenv, st, acts, fruit_u), st,
            kernel_traffic(tenv, st, acts, [fruit_u], (st, outp),
                           autoreset=False), smi)
        step_rows[b_envs]['device_us_by_pacing'] = pacing_probe(
            f'step (no reset) at B={b_envs} 20x20x4', STEP_KERNEL_NAME,
            lambda x: step_kernel.step(tenv, x, acts, fruit_u), st, smi)
        # the same rolling loop while the entry holds envs still
        held_us = {}
        for label, keep in (
                ('none', torch.zeros(b_envs, dtype=torch.bool,
                                     device='cuda')),
                ('half', torch.arange(b_envs, device='cuda') % 2 == 0),
                ('all', torch.ones(b_envs, dtype=torch.bool,
                                   device='cuda'))):
            pair = [(st, outp)]

            def roll_held():
                pair[0] = step_kernel.step(tenv, pair[0][0], acts, fruit_u,
                                           hold=(keep, pair[0][1]))

            held_us[label] = kernel_device_us(roll_held, STEP_KERNEL_NAME,
                                              100)
        step_rows[b_envs]['device_us_holding'] = held_us
        log(f'step (no reset) at B={b_envs} holding envs still, device us '
            f'a launch by share of envs held (torch.profiler, rolling): '
            f'{json.dumps(held_us)} [{smi}]')
    del st, outp, pair

    packed_env = EnvConfig(**big, obs_format='packed')
    pushes = [time_push(shape, rows_n, cap, gen, smi)
              for shape in (tenv.obs_shape[1:], packed_env.obs_shape[1:])
              for rows_n, cap in ((1024, 10_000), (16384, 32768))]

    for n_envs in (32, 256):
        for every in (1, 4):
            row = bench.run_train(n_envs, every, episodes=2, device='cuda')
            log(f'train bench: {json.dumps(row)} [{smi}]')

    windows = {}
    for n_envs in (32, 256):
        short = DQNTrainer(train_config(num_envs=n_envs,
                                        max_steps_per_episode=16),
                           device='cuda')
        held_ts = [ts]                              # with its warm ring
        lengths = []

        def train_steps():
            held_ts[0], m = short.train_episode(held_ts[0])
            lengths.append((int(m.episode_length), m.updates))

        window = profile_device(train_steps, 1)
        steps_n, updates_n = lengths[-1]
        windows[n_envs] = dict(window, steps=steps_n)
        log_window(f'profile of {steps_n} training steps ({updates_n} '
                   f'updates) at {n_envs} envs', window, steps_n, smi,
                   also=(STEP_KERNEL_NAME, 'index', 'Memcpy', 'RadixSort',
                         'multi_tensor'))
        # the step's parts, each alone (CUDA events around repeats)
        st, o = short._reset_env(reset_draws(tenv, n_envs, gen, 'cuda'))
        d = train_draws(tenv, n_envs, 2, tcfg.buffer_size, tcfg.batch_size,
                        gen, 'cuda').at(0)
        zeros = torch.zeros((n_envs, 4), dtype=torch.bool, device='cuda')
        acts = short._select_actions(ts.params, o, zeros, ts.epsilon, d)
        pairs = [step_kernel.step(tenv, st, acts, d.fruit_u)]
        half = torch.arange(n_envs, device='cuda') % 2 == 0
        batch = replay.sample(ts.buffer, tcfg.batch_size, d.sample_u)
        parts = {
            'acting forward + choice': (lambda: short._select_actions(
                ts.params, o, zeros, ts.epsilon, d), 20),
            'env step (kernel)': (lambda: step_kernel.step(
                tenv, pairs[0][0], acts, d.fruit_u), 100),
            'env step holding half the envs (kernel)': (
                lambda: step_kernel.step(tenv, pairs[0][0], acts, d.fruit_u,
                                         hold=(half, pairs[0][1])), 100),
            'replay push': (lambda: replay.push(
                ts.buffer, o.flatten(0, 1), acts.flatten(), d.explore_u
                .flatten(), o.flatten(0, 1), zeros.flatten(),
                mask=~zeros.flatten()), 50),
            'replay sample': (lambda: replay.sample(
                ts.buffer, tcfg.batch_size, d.sample_u), 50),
            'TD update': (lambda: short._td_update(
                ts.params, ts.target_params, ts.opt_state, batch), 20),
            'read-back': (lambda: torch.stack(
                [ts.buffer.size, zeros.any().to(torch.int32)]).tolist(),
                50),
        }
        with torch.no_grad():
            times = {k: event_ms(fn, it) for k, (fn, it) in parts.items()}
        log(f'parts of a training step at {n_envs} envs, ms each (CUDA '
            f'events around repeats, so the slower of host and device): '
            f'{json.dumps(times)} [{smi}]')

    del short, held_ts, batch, pairs, parts
    torch.cuda.empty_cache()

    # --- 12. the rest of the config surface, variant by variant ---
    both = dict(spawn_mode='procedural', spawn_orientations='both')
    variants = [
        ('procedural', EnvConfig(**big, spawn_mode='procedural'), 4096,
         4096),
        ('procedural-both', EnvConfig(**dict(big, num_snakes=2), **both),
         4096, 1024),
        ('packed', EnvConfig(**big, obs_format='packed'), 4096, 1024),
        ('procedural-packed', EnvConfig(**big, spawn_mode='procedural',
                                        obs_format='packed'), 4096, 1024),
        ('stack4-small', EnvConfig(**small, frame_stack=4), 4096, 256),
        ('stack4-small-packed', EnvConfig(**small, frame_stack=4,
                                          obs_format='packed'), 4096, 256),
        ('stack4', EnvConfig(**big, frame_stack=4), 4096, 1024),
        ('stack4-packed', EnvConfig(**big, frame_stack=4,
                                    obs_format='packed'), 4096, 1024),
        ('vision5', EnvConfig(**big, vision_range=5), 4096, 1024),
        ('vision5-stack2', EnvConfig(**big, vision_range=5, frame_stack=2),
         4096, 1024),
        ('all-wide', EnvConfig(**wide, vision_range=5, frame_stack=2,
                               obs_format='packed', max_episode_steps=40,
                               **both), 1024, 1024),
    ]
    variant_rows = []
    for i, (name, vcfg, b_envs, parity_envs) in enumerate(variants):
        variant_rows += run_variant(name, vcfg, b_envs, parity_envs,
                                    seed=100 + 10 * i, smi=smi)
        torch.cuda.empty_cache()
    by_name = {r['name']: r for r in variant_rows}
    obs_share = (by_name['step_autoreset[procedural]']['device_ms']
                 - by_name['step_autoreset[procedural-packed]']['device_ms'])
    log(f'obs store of step_autoreset at B=4096 20x20x4: uint8 minus '
        f'packed device time {obs_share * 1e3:.2f} us of '
        f'{by_name["step_autoreset[procedural]"]["device_ms"] * 1e3:.2f} us '
        f'(the packed store writes an eighth of the bytes) [{smi}]')

    # --- 13. this slice's paths at full width ---
    from marlsnake_torch.envs.vector import state_rays
    bench_rows = {}
    for label, kwargs in (
            ('pool', dict(spawn_mode='pool')),
            ('procedural', {}),
            ('procedural-packed', dict(obs_format='packed')),
            ('pool-packed', dict(spawn_mode='pool', obs_format='packed')),
            ('vision5', dict(vision_range=5)),
            ('graph', dict(graph=True)),
            ('graph-vision5', dict(graph=True, vision_range=5)),
            ('pool-again', dict(spawn_mode='pool'))):
        step_kernel.step_autoreset.launches = 0
        row = bench.run(num_envs=4096, num_steps=256, iters=2,
                        device='cuda', **kwargs)
        row['launches'] = step_kernel.step_autoreset.launches
        if row['launches'] != 256 * (1 + 3 * 2):
            raise AssertionError(f'bench {label}: {row["launches"]} '
                                 f'launches for {256 * 7} steps')
        bench_rows[label] = row
        log(f'bench [{label}]: {json.dumps(row)} [{smi}]')

    slice_windows = {}
    for label, kwargs in (('procedural-packed', dict(obs_format='packed')),
                          ('vision5', dict(vision_range=5)),
                          ('graph', dict(graph=True))):
        wcfg = EnvConfig(**big, spawn_mode='procedural',
                         **{k: v for k, v in kwargs.items()
                            if k != 'graph'})
        wenv = VectorSnakeEnv(wcfg, 4096, device='cuda', seed=21,
                              graph=kwargs.get('graph', False))
        wgen = torch.Generator(device='cuda')
        wgen.manual_seed(22)
        wheld = [wenv.reset()[0]]
        wroll = bench.Rollout(wenv, 16)

        def window_steps():
            wheld[0], _ = wroll.random(wheld[0], wgen)

        window = profile_device(window_steps, 1)
        slice_windows[label] = window
        log_window(f'profile of 16 bench steps [{label}]', window, 16, smi,
                   also=(KERNEL_NAME,))
        if label == 'graph':
            gstate = wheld[0]
            rays_prof = profile_device(
                lambda: state_rays(wcfg, gstate, None), 20)
            rays_ms = event_ms(lambda: state_rays(wcfg, gstate, None), 50)
            feats = state_rays(wcfg, gstate, None)
            if feats.shape != (4096, 4, 5, 8) or feats.dtype \
                    != torch.float32 or not bool(torch.isfinite(feats).all()):
                raise AssertionError('ray features of wrong shape or not '
                                     'finite')
            if bool(feats[~gstate.alive].any()):
                raise AssertionError('a dead snake has ray features')
            log(f'ray features of 4096 envs x 4 snakes from the grid: '
                f'{rays_ms:.5f} ms a call (CUDA events; the slower of host '
                f'and device), device busy '
                f'{rays_prof["busy_us"] / 20:.1f} us in '
                f'{sum(v[1] for v in rays_prof["kernels"].values()) // 20} '
                f'kernels, host wall {rays_prof["wall_us"] / 20:.1f} us '
                f'[{smi}]')
    del wenv, wheld, wroll, gstate, feats
    torch.cuda.empty_cache()

    # two training episodes at 256 envs with packed obs
    ptrainer = DQNTrainer(train_config(obs_format='packed'), device='cuda')
    pts = ptrainer.init_state()
    if pts.buffer.obs_shape != (20, 20, 1):
        raise AssertionError(f'packed ring rows {pts.buffer.obs_shape}')
    pfirst = {k: v.clone() for k, v in pts.params.items()}
    step_kernel.step.launches = 0
    p_steps, p_eps = 0, []
    for _ in range(2):
        pts, m = ptrainer.train_episode(pts)
        p_steps += chunked_steps(ptrainer, m)
        p_eps.append(m)
    torch.cuda.synchronize()
    packed_launches = step_kernel.step.launches
    log(f'packed training path: 2 episodes at 256 envs, '
        f'{[int(m.episode_length) for m in p_eps]} steps, '
        f'{[m.updates for m in p_eps]} updates, mean loss '
        f'{[float(m.mean_loss) for m in p_eps]}, step launches='
        f'{packed_launches} over {p_steps} steps run, ring size {int(pts.buffer.size)} rows of '
        f'{pts.buffer.obs.shape[1]} bytes')
    if packed_launches != p_steps:
        raise AssertionError(f'{p_steps} env steps run on the packed '
                             f'training path but {packed_launches} kernel '
                             f'launches')
    if p_eps[-1].updates <= 0 or not all(
            bool(torch.isfinite(m.mean_loss)) for m in p_eps) \
            or float(p_eps[-1].mean_loss) <= 0.0:
        raise AssertionError('the packed training made no update or its '
                             'loss is not finite and positive')
    if not any(not torch.equal(pts.params[k], pfirst[k]) for k in pfirst) \
            or not all(bool(torch.isfinite(v).all())
                       for v in pts.params.values()):
        raise AssertionError('the packed training left the parameters '
                             'unchanged or not finite')
    # the ring's rows unpack to one-hot planes
    planes = unpack_obs(pts.buffer.obs[:int(pts.buffer.size)])
    if int(planes.max()) > 1 or int(planes.view(-1, 8).sum(1).max()) > 1:
        raise AssertionError('packed ring rows do not unpack to one-hot')
    del ptrainer, pts, planes
    for kwargs in (dict(), dict(obs_format='packed')):
        row = bench.run_train(256, 1, episodes=2, device='cuda', **kwargs)
        log(f'train bench (in turns): {json.dumps(row)} [{smi}]')

    # --- 14. PPO training and the batched evaluator at full width ---
    trained = {}
    ppo = ppo_phase(smi, trained)
    torch.cuda.empty_cache()
    evaluation = evaluator_phase(smi)
    torch.cuda.empty_cache()

    # --- 15. NEAT and ES evolution, the wrapper layer, the battle arenas
    # and the CLI ---
    with tempfile.TemporaryDirectory() as evo_dir:
        evolution = evolution_phase(smi, evo_dir)
        torch.cuda.empty_cache()
        adapters = adapter_phase(smi, evo_dir)
        torch.cuda.empty_cache()
        battle = battle_phase(smi, evo_dir, trained['ppo_params'])
        torch.cuda.empty_cache()
        cli_runs = cli_phase(smi, evo_dir, trained['ppo_params'])
        torch.cuda.empty_cache()
        # the learning-curve programs and the battle program
        showcase = showcase_phase(smi, evo_dir)
    log(f'showcase: {json.dumps(showcase)}')
    torch.cuda.empty_cache()

    # --- 16. the config matrix and evolution at the flagship scale ---
    table = bench_table_phase(smi)
    log(f'bench_table: {json.dumps({k: v for k, v in table.items() if k != "kernel_rows"})}')
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as flagship_dir:
        flagship = flagship_phase(smi, flagship_dir)
    log(f'flagship: {json.dumps(flagship)}')
    torch.cuda.empty_cache()

    # --- 17. the distillation and the two rollout demos ---
    with tempfile.TemporaryDirectory() as distill_dir:
        distill = distill_phase(smi, distill_dir)
    log(f'distill: {json.dumps(distill)}')
    torch.cuda.empty_cache()
    demos = demos_phase(smi)
    torch.cuda.empty_cache()

    # --- 18. data-parallel training ---
    with tempfile.TemporaryDirectory() as dp_dir:
        dp = parallel_phase(smi, dp_dir)
    log(f'parallel: {json.dumps(dp)}')
    torch.cuda.empty_cache()

    # --- 19. the captured loops against their bodies, and their times ---
    graphs = graph_phase(smi)
    log(f'graphs: {json.dumps(graphs)}')
    torch.cuda.empty_cache()
    log(f'tracer: {json.dumps(tracer_phase(smi))}')
    torch.cuda.empty_cache()

    def in_graphs(kernel_name):
        return {label: {k: v for k, v in w['kernel_us_per_launch'].items()
                        if kernel_name in k}
                for label, w in graphs['windows'].items()
                if any(kernel_name in k for k in w['kernel_us_per_launch'])}

    def in_loop_graphs(kernel_name):
        """Device us a launch and launches a step of ``kernel_name`` in the
        16-step windows of the chunked loops, graph and uncaptured."""
        found = {}
        for path, windows in (
                ('evaluator (E=256)', evaluation['evaluator_graph'][
                    'windows']),
                ('battle_batch (E=128)', battle['battle_graph']['windows']),
                ('fitness', flagship['fitness_windows'])):
            for mode, w in windows.items():
                mine = {k: v for k, v in w['kernel_us_per_launch'].items()
                        if kernel_name in k}
                if mine:
                    found[f'{path} {mode}'] = {
                        'us_per_launch': mine,
                        'launches_per_step': {
                            k: n / 16 for k, n in
                            w['kernel_launches_in_window'].items()
                            if kernel_name in k}}
        return found

    step_main = step_rows[256]
    mask_rows = {'evaluator (E=256, N=4)': evaluation['mask_evaluator'],
                 'battle (E=128, N=1)': battle['mask_battle'],
                 'DQNEvaluator (E=1, N=4)': adapters['mask_dqn_evaluator']}
    fill_rows = {'evaluator (3,072 boards)': evaluation['fill_evaluator'],
                 'battle (384 boards)': battle['fill_battle']}
    log(json.dumps({'kernels': variant_rows + table['kernel_rows'] + [dict(
        auto,
        name='step_autoreset',
        route='cuda',
        source='marlsnake_torch/csrc/step_autoreset.cu',
        replaces='marlsnake_tpu/ops/pallas_step.py:54',
        launches=launches,
        max_abs_err=max([err, distill['max_abs_err'], demos['max_abs_err']]
                        + [v for k, v in showcase['max_abs_err'].items()
                           if k.startswith('step_autoreset ')]),
        acting_forward_ms=forward_ms,
        bench_env_steps_per_s=b['value'],
        bench_idle_share=bench_idle,
        vector_adapter_launches=adapters['vector_adapter_launches'],
        max_abs_err_vector_adapter_b8=adapters[
            'step_autoreset_max_abs_err_b8'],
        showcase_launches={
            'run_ppo (B=128, 3 updates)': showcase['ppo_graph'][
                'step_autoreset_launches'],
            'run_ppo20 (B=256, 2 updates)': showcase['ppo20'][
                'step_autoreset_launches']},
        distributed_ppo_launches={
            'world 1, NCCL (B=256)': dp['ppo_world1'][
                'step_autoreset_launches'],
            'world 2, gloo, each rank (B=128)': dp['gloo_world2'][
                'ppo_step_autoreset_launches']},
        max_abs_err_distributed_ppo_b128=dp['max_abs_err'][
            'step_autoreset ppo B=128'],
        max_abs_err_scaling_b512=dp['max_abs_err'][
            'step_autoreset scaling B=512'],
        max_abs_err_showcase={k: v for k, v in showcase['max_abs_err'].items()
                              if k.startswith('step_autoreset ')},
        bench_table_launches=table['launches'],
        max_abs_err_bench_table=table['max_abs_err'],
        launches_by_path={
            'distill_acting (E=256, 3 iterations of 32 steps)': distill[
                'launches'],
            'demo (B=1024, 2 rollouts of 256 steps)': demos['demo'][
                'launches'],
            'vector_rollout (B=4096, 2 rollouts of 256 steps)': demos[
                'vector_rollout']['launches']},
        max_abs_err_distill_b256=distill['max_abs_err'],
        max_abs_err_demo_b1024=demos['max_abs_err'],
        distill={k: v for k, v in distill.items()
                 if k not in ('launches', 'max_abs_err')},
        demos={k: v for k, v in demos.items() if k != 'max_abs_err'},
        device_us_per_launch_in_windows=in_graphs(KERNEL_NAME),
        graph_bench_env_steps_per_s=graphs['bench'],
        graph_ppo=graphs['ppo'],
        **ppo,
    ), dict(
        step_main,
        name='step',
        route='cuda',
        source='marlsnake_torch/csrc/step_autoreset.cu',
        replaces='marlsnake_tpu/core/engine.py:987 (step, an XLA path, '
                 'not a Pallas kernel)',
        launches=train_launches,
        # at the training path's shape and the showcase programs'
        max_abs_err=max([train_step_err] + [
            v for k, v in showcase['max_abs_err'].items()
            if k.startswith('step ')]),
        max_abs_err_other_shapes=step_err,
        max_abs_err_distributed_dqn_b128=dp['max_abs_err'][
            'step dqn B=128 hold'],
        max_abs_err_showcase={k: v for k, v in showcase['max_abs_err'].items()
                              if k.startswith('step ')},
        max_abs_err_flagship=flagship['max_abs_err'],
        num_envs=256,
        at_4096_envs={k: step_rows[4096][k] for k in (
            'device_ms', 'host_us', 'call_ms', 'plain_ms', 'bound_ms',
            'pct_of_bound', 'bytes', 'device_us_holding',
            'device_us_by_pacing')},
        device_us_per_launch_in_windows=in_graphs(STEP_KERNEL_NAME),
        device_us_in_loop_graphs=in_loop_graphs(STEP_KERNEL_NAME),
        fitness_graphs=flagship['fitness_graphs'],
        graph_dqn={n: {k: v for k, v in r.items() if k != 'rows'}
                   for n, r in graphs['dqn'].items()},
        graph_equal=graphs['equal'],
        graph_captures=graphs['captures'],
        train_idle_share={n: w['idle_share'] for n, w in windows.items()},
        train_dtoh_per_step={n: w['dtoh'] / w['steps']
                             for n, w in windows.items()},
        packed_training_launches=packed_launches,
        replay_push=pushes,
        bench_env_steps_per_s={k: r['value'] for k, r in bench_rows.items()},
        bench_idle_share={k: w['idle_share']
                          for k, w in slice_windows.items()},
        **{k: v for k, v in evaluation.items()
           if not k.startswith(('mask_', 'fill_'))},
        launches_by_path={
            'training': train_launches,
            'evaluator (B=256)': evaluation['evaluator_launches'],
            'neat (B=100)': evolution['neat_launches'],
            'es (B=129 and 8)': evolution['es_launches'],
            'gym_adapter (B=1)': adapters['gym_adapter_launches'],
            'dqn_evaluator (B=1)': adapters['dqn_evaluator_launches'],
            'render_winner (B=1)': adapters['render_winner_launches'],
            'battle_batch (B=128)': battle['battle_launches'],
            'battle_arena (B=1)': battle['arena_launches'],
            'showcase run_dqn (B=32, 12 episodes)': showcase['dqn_graph'][
                'step_launches'],
            'battle_batch_run (B=128)': showcase['battle']['step_launches'],
            'neat_flagship (2 generations)': {
                k: flagship['runs']['neat'][k]
                for k in ('launches', 'launches_by_width')},
            'es_flagship (2 generations, holdout 64)': {
                k: flagship['runs']['es'][k]
                for k in ('launches', 'launches_by_width')},
            'cli': {k: {e: v[e] for e in ('step', 'step_autoreset')}
                    for k, v in cli_runs.items()},
            'distributed_dqn world 1, NCCL (B=256)': dp['dqn_world1'][
                'step_launches'],
            'distributed_dqn world 2, gloo, each rank (B=128)': dp[
                'gloo_world2']['dqn_step_launches']},
        battle={k: v for k, v in battle.items()
                if k not in ('battle_launches', 'arena_launches',
                             'mask_battle', 'fill_battle')},
        cli_seconds={k: v['seconds'] for k, v in cli_runs.items()},
        evolution={k: v for k, v in evolution.items()
                   if k not in ('neat_launches', 'es_launches')},
        flagship_fitness_windows=flagship['fitness_windows'],
        flagship_episode_card_vs_cpu=flagship[
            'fitness_episode_card_vs_cpu'],
        adapters={k: v for k, v in adapters.items()
                  if k not in ('vector_adapter_launches',
                               'step_autoreset_max_abs_err_b8',
                               'mask_dqn_evaluator')},
    ), dict(
        mask_rows['evaluator (E=256, N=4)'],
        name='masked_actions',
        route='cuda',
        source='marlsnake_torch/csrc/safety_mask.cu',
        replaces='marlsnake_tpu/algo/evaluator.py:131 (masked_actions, '
                 'with masked_action_single :56; XLA code, not a Pallas '
                 'kernel)',
        launches=evaluation['evaluator_mask_launches'],
        max_abs_err=evaluation['mask_max_abs_err'],   # the path's 16 steps
        max_abs_err_other_shapes=mask_parity['safety_mask_max_abs_err'],
        checked=mask_parity,
        at_shapes=mask_rows,
        device_us_in_loop_graphs=in_loop_graphs(MASK_KERNEL_NAME),
        launches_by_path={
            'evaluator (E=256, N=4)': evaluation['evaluator_mask_launches'],
            'battle_batch (E=128, N=1)': battle['battle_mask_launches'],
            'dqn_evaluator (E=1, N=4)': adapters[
                'dqn_evaluator_mask_launches'],
            'battle_arena (E=1, N=4)': battle['arena_mask_launches'],
            'battle_batch_run (E=128, N=1)': showcase['battle'][
                'mask_launches'],
            'cli': {k: v['safety_mask'] for k, v in cli_runs.items()}},
    ), dict(
        fill_rows['evaluator (3,072 boards)'],
        name='reachable_count',
        route='cuda',
        source='marlsnake_torch/csrc/safety_mask.cu',
        replaces='marlsnake_tpu/ops/floodfill.py:25 (reachable_count, XLA '
                 'code, not a Pallas kernel)',
        launches=evaluation['fill_launches'],
        launches_note='its own path: the space of every post-move board '
                      'of 16 evaluation steps; the masked paths launch it '
                      '0 times, the mask kernel runs the same fill',
        max_abs_err=evaluation['fill_max_abs_err'],   # the path's boards
        max_abs_err_other_shapes=mask_parity['reachable_count_max_abs_err'],
        checked=mask_parity,
        at_shapes=fill_rows,
    )]}))
    log(f'total {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--masked-paths']:
        sys.exit(masked_paths_main(
            sys.argv[2] if len(sys.argv) > 2
            else os.path.dirname(os.path.abspath(__file__))))
    if sys.argv[1:2] == ['--mask-phases']:
        sys.exit(masked_paths_main(
            os.path.dirname(os.path.abspath(__file__)), phases=True))
    sys.exit(main())
