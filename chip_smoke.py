#!/usr/bin/env python3
"""Build and drive the PyTorch port (marlsnake_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA step kernel with nvcc from this checkout's sources;
3. the kernel against its plain PyTorch version (engine.step_autoreset)
   on the card, at 10x10 with 2 snakes (B=64, done_mode 'all' and 'any')
   and at 20x20 with 4 snakes (B=4096), 64 steps each, the same actions
   and draws for both: every state and output field must be EQUAL,
   floats included (tolerance 0: the library is built with -fmad=false
   and both sides do the same IEEE operations in the same order);
4. the main path: VectorSnakeEnv with 4096 envs of 20x20 with 4 snakes
   and the reference-width DQN (random weights from a seed, float32, TF32
   off) acting epsilon-greedily for 16 steps; the launch counter is set
   to 0 before and read after, and the last step is held against the
   plain version;
5. times with CUDA events after warm-up: kernel and plain version per
   step, the acting forward, and marlsnake_torch.bench's env-steps/s;
6. one JSON line of kernels, then, as the last line,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Exits non-zero without a result when CUDA is not available.
"""

import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM CUDA-core rate (used for int ops)


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
        err = max(err, compare(got, want, f'{cfg.height}x{cfg.width}x'
                               f'{cfg.num_snakes} {cfg.done_mode} t={t}'))
        resets += int(got[1].done_all.sum())
        state = got[0]
    if step_kernel.step_autoreset.launches - before != steps:
        raise AssertionError('the launch counter did not move')
    if resets == 0:
        raise AssertionError('no auto-reset happened in the parity run')
    log(f'parity {cfg.height}x{cfg.width}x{cfg.num_snakes} '
        f'done_mode={cfg.done_mode} B={num_envs} steps={steps}: equal, '
        f'{resets} auto-resets, max_abs_err={err}')
    return err


def kernel_traffic(cfg, state, actions, draws, outputs) -> tuple:
    """(bytes, ops) one step must move and do: every input read once,
    every output written once; spawn rows and the base grid only for the
    envs that reset in this step."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    new_state, out = outputs
    resets = int(out.done_all.sum())
    n, k, hw = cfg.num_snakes, cfg.snake_length, cfg.height * cfg.width
    read = (nbytes([t for _, t in state.fields()])
            + nbytes([actions.to(torch.int32)]) + nbytes(list(draws))
            + resets * n * k * 4 + (hw * 4 if resets else 0))
    written = (nbytes([t for _, t in new_state.fields()])
               + nbytes([t for _, t in out.fields()]))
    # integer work: ~2 ops per obs byte (bit extract + store) and ~16 per
    # cell for the grid passes (erase, prefix count, fruit pick, copy)
    ops = state.num_envs * (2 * n * hw * 8 + 16 * hw)
    return read + written, ops


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    # the port only: no module of JAX or of the JAX package is imported
    from marlsnake_torch import bench
    from marlsnake_torch.algo.acting import select_actions
    from marlsnake_torch.core import engine
    from marlsnake_torch.core.types import EnvConfig
    from marlsnake_torch.envs.vector import VectorSnakeEnv
    from marlsnake_torch.models.dqn import make_dqn
    from marlsnake_torch.ops import step_kernel
    from marlsnake_torch.rng import step_draws

    # --- 1. the card ---
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {kind} count {torch.cuda.device_count()}')

    # --- 2. build ---
    t0 = time.perf_counter()
    path, build_log = step_kernel.build_library()
    step_kernel.load_library()
    log(f'build: {time.perf_counter() - t0:.2f} s -> '
        f'{os.path.relpath(path)}')
    for line in build_log.splitlines():
        log(f'  nvcc: {line}')

    # --- 3. kernel against the plain version ---
    small = dict(height=10, width=10, num_snakes=2, snake_length=3)
    big = dict(height=20, width=20, num_snakes=4, snake_length=3)
    err = max(parity(EnvConfig(**small), 64, 64, seed=1),
              parity(EnvConfig(**small, done_mode='any'), 64, 64, seed=2),
              parity(EnvConfig(**big), 4096, 64, seed=3))

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

    # --- 5. times ---
    s, a, d = last
    outputs = step_kernel.step_autoreset(cfg, tables, s, a, d)
    kernel_ms = event_ms(
        lambda: step_kernel.step_autoreset(cfg, tables, s, a, d), 200)
    plain_ms = event_ms(
        lambda: engine.step_autoreset(cfg, tables, s, a, d), 20)
    flat_obs = obs.reshape((-1,) + cfg.obs_shape[1:])
    with torch.no_grad():
        forward_ms = event_ms(lambda: net(flat_obs), 10)
    nbytes, ops = kernel_traffic(cfg, s, a, d, outputs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f'step_autoreset at B={num_envs} 20x20x4: kernel {kernel_ms:.5f} '
        f'ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms '
        f'({nbytes} bytes -> {bytes_ms:.5f} ms; {ops} int ops -> '
        f'{ops_ms:.5f} ms) [{smi}]')
    log(f'acting forward ({num_envs * cfg.num_snakes} agents, fp32): '
        f'{forward_ms:.5f} ms [{smi}]')
    b = bench.run(num_envs=4096, num_steps=256, iters=4, device='cuda')
    log(f'bench: {json.dumps(b)} [{smi}]')

    log(json.dumps({'kernels': [{
        'name': 'step_autoreset',
        'route': 'cuda',
        'source': 'marlsnake_torch/csrc/step_autoreset.cu',
        'replaces': 'marlsnake_tpu/ops/pallas_step.py:54',
        'launches': launches,
        'max_abs_err': err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
        'library_ms': None,
        'bytes': nbytes,
        'acting_forward_ms': forward_ms,
        'bench_env_steps_per_s': b['value'],
    }]}))
    log(f'total {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
