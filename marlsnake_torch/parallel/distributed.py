"""Process groups, a local cluster of ranks, scaling and the collectives
audit.

The JAX package starts ``jax.distributed`` a host and lets XLA insert the
collectives from its sharding annotations. Here every rank is a process
that owns one device and calls ``torch.distributed`` itself: NCCL between
CUDA devices, gloo on the CPU, and gloo also for ranks that share one
card, which NCCL refuses (gloo then stages the CUDA tensors of a
collective through the host; the compute stays on the card). Failure is
fail-stop, as in JAX: a rank that fails makes its launcher raise.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from marlsnake_torch.device import resolve_device
from marlsnake_torch.parallel.mesh import Mesh, make_mesh

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device='cuda') -> None:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``; does nothing without a coordinator, as JAX's does.
    ``coordinator_address`` is an init method (``tcp://host:port``,
    ``file:///path``) or a bare ``host:port``. ``backend`` defaults to
    NCCL for CUDA and gloo for the CPU; 'gloo' with CUDA lets ranks share
    one card. On CUDA the rank's device (``cuda:<process_id % cards>``
    unless ``device`` names one) is made current before the group is
    made."""
    if coordinator_address is None:
        return
    dev = resolve_device(device)
    if dev.type == 'cuda':
        if dev.index is None:
            dev = torch.device('cuda',
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    init = coordinator_address if '://' in coordinator_address \
        else f'tcp://{coordinator_address}'
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def run_ranks(commands: Sequence[Sequence[str]],
              timeout: float) -> List[str]:
    """Run ``python *commands[r]`` for each rank r at once (``['-m',
    module, ...]`` or a script and its arguments), from the repository
    root with the repository on the path, and return their standard
    outputs. Raises, after ending every rank, as soon as one fails or when
    ``timeout`` seconds have passed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_REPO_ROOT, os.environ.get('PYTHONPATH')) if p))
    with tempfile.TemporaryDirectory() as logs:
        files, procs = [], []
        try:
            for rank, args in enumerate(commands):
                out = open(os.path.join(logs, f'{rank}.out'), 'w+')
                err = open(os.path.join(logs, f'{rank}.err'), 'w+')
                files.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, *map(str, args)],
                    stdout=out, stderr=err, cwd=_REPO_ROOT, env=env))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                for rank, p in enumerate(procs):
                    if p.returncode not in (None, 0):
                        files[rank][1].seek(0)
                        raise RuntimeError(
                            f'rank {rank} failed rc={p.returncode}:\n'
                            f'{files[rank][1].read()[-4000:]}')
                if time.monotonic() > deadline:
                    raise RuntimeError(f'ranks timed out after {timeout} s')
                time.sleep(0.05)
            outputs = []
            for rank, (p, (out, err)) in enumerate(zip(procs, files)):
                if p.returncode != 0:
                    err.seek(0)
                    raise RuntimeError(f'rank {rank} failed '
                                       f'rc={p.returncode}:\n'
                                       f'{err.read()[-4000:]}')
                out.seek(0)
                outputs.append(out.read())
            return outputs
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for out, err in files:
                out.close()
                err.close()


def cluster_job(num_processes: int, device='cuda',
                backend: Optional[str] = None) -> dict:
    """The local cluster's job for ``runner``: one ``DistributedDQN``
    episode of 2 envs a rank on an 8x8 board, with ``min_buffer_size`` low
    enough that the averaged TD update (the collective under test) fires
    within the short episode (2 envs x 2 snakes a rank push 4 transitions
    a step)."""
    config = dict(height=8, width=8, num_snakes=2, snake_length=2,
                  num_envs=2 * num_processes, max_steps_per_episode=8,
                  batch_size=4, min_buffer_size=4, buffer_size=64)
    return {'device': device, 'backend': backend,
            'tasks': [{'kind': 'dqn', 'config': config, 'episodes': 1}]}


def cluster_result(rank: int, num_processes: int, dqn: dict) -> dict:
    """One rank's report of the cluster's episode (``dqn``: the runner's
    result of its task): its parameters' digest (the sum of their
    magnitudes, in float64), mean reward and update count."""
    ts, metrics = dqn['states'][-1], dqn['metrics'][-1]
    return {'process_id': rank, 'num_processes': num_processes,
            'param_digest': sum(float(p.double().abs().sum())
                                for p in ts.params.values()),
            'mean_reward': float(metrics.mean_reward),
            'updates': metrics.updates}


def launch_local_cluster(num_processes: int = 2, device='cuda',
                         backend: Optional[str] = None,
                         timeout: float = 300.0) -> list:
    """Start ``num_processes`` ranks on this host (``runner.run_job``,
    rendezvous through a file), each running the episode of
    ``cluster_job`` on ``device`` with ``backend``. Returns each rank's
    ``cluster_result``; raises if a rank fails or times out, or if the
    ranks end with different parameters (digests)."""
    from marlsnake_torch.parallel.runner import run_job
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_job(cluster_job(num_processes, device, backend),
                        num_processes, tmp, timeout)
    results = [cluster_result(rank, num_processes, res[0])
               for rank, res in enumerate(ranks)]
    if len({r['param_digest'] for r in results}) != 1:
        raise RuntimeError(
            f'replicated params diverged across processes: {results}')
    return results


# --- the collectives audit ---------------------------------------------------

# the trainers' collectives as the profiler names them (``c10d::<op>``,
# under NCCL and gloo alike); any other op is counted under its own name
_C10D_OPS = {'allreduce_': 'all-reduce', 'broadcast_': 'broadcast'}


def collective_counts(prof) -> dict:
    """The collectives a ``torch.profiler.profile`` window issued, by kind
    ('all-reduce', 'broadcast'; any other under its ``c10d`` name, such
    as 'barrier'). The audit of a data-parallel
    program, as the JAX package's ``hlo_collective_counts`` is of its
    HLO: the env rollout issues none, the learner exactly its
    all-reduces."""
    counts: dict = {}
    for e in prof.events():
        if e.name.startswith('c10d::'):
            op = e.name[len('c10d::'):]
            kind = _C10D_OPS.get(op, op)
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def collective_times(prof) -> dict:
    """Microseconds the collectives of a profiler window took: 'device_us'
    of the NCCL kernels, 'host_us' of the calls on the caller's thread
    (their ``c10d::`` spans) and 'gloo_us' of gloo's own work (its
    ``gloo:`` spans, on its threads, waiting for the other ranks
    included)."""
    times = {'device_us': 0.0, 'host_us': 0.0, 'gloo_us': 0.0}
    for e in prof.events():
        span = e.time_range.end - e.time_range.start
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if 'nccl' in e.name.lower():
                times['device_us'] += span
        elif e.name.startswith('c10d::'):
            times['host_us'] += span
        elif e.name.startswith('gloo:'):
            times['gloo_us'] += span
    return times


# --- scaling -----------------------------------------------------------------

def _rank_step_seconds(cfg, num_envs: int, num_steps: int,
                       mesh: Mesh) -> float:
    """Seconds this rank takes for ``num_steps`` auto-reset steps of
    ``num_envs`` envs with zero actions, draws made up front (one warm-up
    step first)."""
    from marlsnake_torch.envs.vector import build_vector_fns
    from marlsnake_torch.rng import rank_seed, reset_draws, step_draws
    dev = mesh.device
    reset_fn, step_fn = build_vector_fns(cfg, autoreset=True, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rank_seed(0, mesh.rank))
    states, _ = reset_fn(reset_draws(cfg, num_envs, gen, dev))
    draws = [step_draws(cfg, num_envs, gen, dev)
             for _ in range(num_steps + 1)]
    acts = torch.zeros((num_envs, cfg.num_snakes), dtype=torch.int32,
                       device=dev)
    sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
    states, _ = step_fn(states, acts, draws[-1])
    sync()
    t0 = time.perf_counter()
    for d in draws[:num_steps]:
        states, _ = step_fn(states, acts, d)
    sync()
    return time.perf_counter() - t0


def _single_and_full(cfg, envs_per_device: int, num_steps: int,
                     mesh: Optional[Mesh]):
    """(mesh, single seconds, full seconds): 'single' is rank 0 stepping
    alone while the others wait; 'full' is every rank stepping at once,
    timed by the slowest (a MAX all-reduce). Every rank returns the
    same numbers."""
    mesh = mesh or make_mesh()
    times = torch.zeros((2,), dtype=torch.float64, device=mesh.device)
    mesh.barrier()
    if mesh.rank == 0:
        times[0] = _rank_step_seconds(cfg, envs_per_device, num_steps, mesh)
    mesh.barrier()
    mesh.all_reduce(times, 'max')       # rank 0's single time to all
    mesh.barrier()
    times[1] = _rank_step_seconds(cfg, envs_per_device, num_steps, mesh)
    mesh.all_reduce(times, 'max')
    single, full = times.tolist()
    return mesh, single, full


def _emulated(mesh: Mesh) -> bool:
    """True when the ranks run on the CPU or share a card: the UUIDs of
    the ranks' cards, gathered from every rank, are fewer than the
    ranks."""
    if mesh.device.type == 'cpu':
        return True
    if mesh.group is None:
        return False
    uuid = str(torch.cuda.get_device_properties(mesh.device).uuid)
    uuids = [None] * mesh.world
    dist.all_gather_object(uuids, uuid, group=mesh.group)
    return len(set(uuids)) < mesh.world


def per_device_step_time(cfg, envs_per_device: int = 64,
                         num_steps: int = 32,
                         mesh: Optional[Mesh] = None) -> dict:
    """Milliseconds an env step at ``envs_per_device`` envs a rank takes:
    one rank alone ('unsharded') and every rank at once ('sharded', the
    slowest rank's). Called by every rank of ``mesh`` (default
    ``make_mesh()``). Returns {'devices', 'unsharded_ms_per_step',
    'sharded_ms_per_step', 'emulated'}; with 'emulated' True (the CPU, or
    ranks sharing a card) compare shapes and trends only."""
    mesh, single, full = _single_and_full(cfg, envs_per_device, num_steps,
                                          mesh)
    return {'devices': mesh.world,
            'unsharded_ms_per_step': single / num_steps * 1e3,
            'sharded_ms_per_step': full / num_steps * 1e3,
            'emulated': _emulated(mesh)}


def scaling_efficiency(cfg, envs_per_device: int = 512,
                       num_steps: int = 64,
                       mesh: Optional[Mesh] = None) -> dict:
    """Env-steps/s of one rank alone ('single') and of every rank at once
    ('full', timed by the slowest rank), and 'efficiency' = full /
    (devices x single). Called by every rank of ``mesh``. Meaningful only
    with one card a rank: with 'emulated' True the ranks share the host or
    a card, and the quotient says nothing of scaling."""
    mesh, single, full = _single_and_full(cfg, envs_per_device, num_steps,
                                          mesh)
    steps = envs_per_device * num_steps
    single_rate = steps / single
    full_rate = mesh.world * steps / full
    return {'single': single_rate, 'full': full_rate, 'devices': mesh.world,
            'efficiency': full_rate / (mesh.world * single_rate),
            'emulated': _emulated(mesh)}
