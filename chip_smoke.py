#!/usr/bin/env python3
"""Build and drive the PyTorch port (marlsnake_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA step kernel with nvcc from this checkout's sources;
3. the kernel against its plain PyTorch version (engine.step_autoreset)
   on the card, at 10x10 with 2 snakes (B=64, done_mode 'all' and 'any'),
   at 20x20 with 4 snakes (B=4096) and at 40x40 with 8 snakes (B=1024),
   64 steps each, the same actions and draws for both: every state and
   output field must be EQUAL, floats included (tolerance 0: the library
   is built with -fmad=false and both sides do the same IEEE operations in
   the same order), and each run must auto-reset some envs;
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
   - the plain version, the acting forward, marlsnake_torch.bench's
     env-steps/s, and a profiler window over 16 bench steps: device time
     by kernel name and the device's idle share;
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
KERNEL_NAME = 'step_autoreset'


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
    """Run ``fn()`` ``iters`` times under torch.profiler (CPU and CUDA).
    Returns {'kernels': {name: [device us, count]}, 'busy_us', 'span_us',
    'idle_share', 'wall_us'} from the device-side events: busy is their
    summed duration, span the time from the first start to the last end
    (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, busy, first, last = {}, 0.0, None, None
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        kernels.setdefault(e.name, [0.0, 0])
        kernels[e.name][0] += end - start
        kernels[e.name][1] += 1
        busy += end - start
        first = start if first is None else min(first, start)
        last = end if last is None else max(last, end)
    span = (last - first) if kernels else 0.0
    return {'kernels': kernels, 'busy_us': busy, 'span_us': span,
            'idle_share': 1.0 - busy / span if span > 0 else None,
            'wall_us': wall_us}


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
    wide = dict(height=40, width=40, num_snakes=8, snake_length=3)
    err = max(parity(EnvConfig(**small), 64, 64, seed=1),
              parity(EnvConfig(**small, done_mode='any'), 64, 64, seed=2),
              parity(EnvConfig(**big), 4096, 64, seed=3),
              parity(EnvConfig(**wide), 1024, 64, seed=4))

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
    rolling = [s]

    def roll():
        rolling[0], _ = step_kernel.step_autoreset(cfg, tables, rolling[0],
                                                   a, d)

    prof = profile_device(roll, 100)
    mine = [v for k, v in prof['kernels'].items() if KERNEL_NAME in k]
    if not mine:
        raise AssertionError('the profiler saw no step_autoreset kernel')
    device_ms = sum(v[0] for v in mine) / sum(v[1] for v in mine) / 1e3
    host_blocks = host_us(roll)
    wrapper_us = sorted(host_blocks)[len(host_blocks) // 2]
    call_ms = event_ms(
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
    pct_of_bound = 100.0 * bound_ms / device_ms
    log(f'step_autoreset at B={num_envs} 20x20x4: device {device_ms:.5f} ms '
        f'(torch.profiler, rolling), host {wrapper_us:.2f} us per call '
        f'(median of blocks {[round(x, 2) for x in host_blocks]}), '
        f'call {call_ms:.5f} ms, plain {plain_ms:.5f} ms, bound '
        f'{bound_ms:.5f} ms ({nbytes} bytes -> {bytes_ms:.5f} ms; {ops} int '
        f'ops -> {ops_ms:.5f} ms), {pct_of_bound:.1f}% of bound [{smi}]')
    log(f'acting forward ({num_envs * cfg.num_snakes} agents, fp32): '
        f'{forward_ms:.5f} ms [{smi}]')
    b = bench.run(num_envs=4096, num_steps=256, iters=4, device='cuda')
    log(f'bench: {json.dumps(b)} [{smi}]')

    bench_env = VectorSnakeEnv(cfg, num_envs, device='cuda', seed=9)
    bench_states, _ = bench_env.reset()
    bench_gen = torch.Generator(device=bench_env.device)
    bench_gen.manual_seed(10)
    held = [bench_states]

    def bench_steps():
        held[0], r = bench.rollout(bench_env, held[0], 16, bench_gen)

    window = profile_device(bench_steps, 1)
    log(f'profile of 16 bench steps: wall {window["wall_us"]:.1f} us, '
        f'device busy {window["busy_us"]:.1f} us over a span of '
        f'{window["span_us"]:.1f} us, idle share {window["idle_share"]} '
        f'[{smi}]')
    for name, (us, count) in sorted(window['kernels'].items(),
                                    key=lambda kv: -kv[1][0]):
        log(f'  {us:10.1f} us {count:4d}x  {name[:100]}')

    log(json.dumps({'kernels': [{
        'name': 'step_autoreset',
        'route': 'cuda',
        'source': 'marlsnake_torch/csrc/step_autoreset.cu',
        'replaces': 'marlsnake_tpu/ops/pallas_step.py:54',
        'launches': launches,
        'max_abs_err': err,
        'ms': device_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
        'library_ms': None,
        'device_ms': device_ms,
        'host_us': wrapper_us,
        'call_ms': call_ms,
        'pct_of_bound': pct_of_bound,
        'bytes': nbytes,
        'acting_forward_ms': forward_ms,
        'bench_env_steps_per_s': b['value'],
        'bench_idle_share': window['idle_share'],
    }]}))
    log(f'total {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
