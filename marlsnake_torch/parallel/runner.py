"""Data-parallel jobs run in ranks of their own:
``python -m marlsnake_torch.parallel.runner JOB RANK WORLD RENDEZVOUS``.

A job is a dict the caller wrote with ``torch.save``: the ``device``
('cpu' or 'cuda'), the ``backend`` (None for the device's default) and
its ``tasks``, which every rank runs in order in one process group
(``run_rank``). Each rank writes its results, one entry a task, to
``JOB.rank<RANK>.pt``. ``run_job`` writes a job, starts its ranks, waits
for them and returns their results. Job and results are pickles that this
program writes and reads, and nothing else.

Tasks:

* ``{'kind': 'dqn', 'config': DQNConfig fields, 'episodes': n}``:
  ``DistributedDQN`` episodes; optional ``'states'`` (the start state of
  each rank, else ``init_state()``) and ``'draws'`` (for each episode,
  each rank's ``(TrainDraws, ResetDraws)``);
* ``{'kind': 'ppo', 'config': PPOConfig fields, 'updates': n}``:
  ``DistributedPPO`` updates, likewise (``'draws'``: each rank's
  ``(PPODraws,)``).

  Both give, after each episode or update, the rank's state and metrics
  (on the CPU), the launches of both kernel entries and the seconds it
  took. With ``'profile': True`` the last episode or update runs under
  ``torch.profiler``, and its collectives are counted
  (``collective_counts``) and timed (``collective_times``). With
  ``'check': n`` the checks' hook (``_attach_checks``) also gives the
  rank's env steps in each and its first n learner calls;
* ``{'kind': 'scaling', 'env': EnvConfig fields, 'envs_per_device': e,
  'num_steps': t}``: ``per_device_step_time`` and ``scaling_efficiency``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

import torch

from marlsnake_torch.parallel import distributed
from marlsnake_torch.parallel.mesh import make_mesh, map_tensors
from marlsnake_torch.utils import cuda_graph


def run_job(job: dict, world: int, workdir: str,
            timeout: float = 600.0) -> list:
    """Run ``job`` in ``world`` ranks (files and the rendezvous in a new
    directory under ``workdir``); returns each rank's results."""
    tmp = tempfile.mkdtemp(dir=workdir)
    path = os.path.join(tmp, 'job.pt')
    torch.save(job, path)
    rendezvous = 'file://' + os.path.join(tmp, 'rendezvous')
    distributed.run_ranks(
        [('-m', 'marlsnake_torch.parallel.runner', path, r, world, rendezvous)
         for r in range(world)], timeout)
    return [torch.load(f'{path}.rank{r}.pt', map_location='cpu',
                       weights_only=False) for r in range(world)]


def _cpu(tree):
    return map_tensors(lambda t: t.detach().to('cpu', copy=True), tree)


def _launches() -> tuple:
    from marlsnake_torch.ops import step_kernel
    return step_kernel.step.launches, step_kernel.step_autoreset.launches


def _attach_checks(trainer, mesh, calls: int) -> dict:
    """The checks' hook (the tests and ``chip_smoke.py`` ask for it with a
    task's ``'check'``): wraps this rank's ``trainer`` and ``mesh`` so
    that they count the env steps the trainer takes and keep, on the CPU,
    the arguments and local results of its first ``calls`` learner calls
    and what the gradient all-reduce of each of those returned. Returns
    the dict they fill: 'env_steps' (a running count, a tracked
    ``cuda_graph.Counter``, so that a captured rollout's replays count
    their steps), 'args', 'local' and 'reduced' (lists, one entry a
    call)."""
    seen = {'env_steps': cuda_graph.track(cuda_graph.Counter('env_steps')),
            'args': [], 'local': [], 'reduced': []}
    step_env, loss_and_grads, mean = (trainer._step_env,
                                      trainer.loss_and_grads, mesh.mean)

    def counted_step(*args, **kwargs):
        seen['env_steps'].launches += 1
        return step_env(*args, **kwargs)

    def recorded_call(*args):
        out = loss_and_grads(*args)
        if len(seen['args']) < calls:
            seen['args'].append(_cpu(args))
            seen['local'].append(_cpu(out))
        return out

    def recorded_mean(tensors):
        out = mean(tensors)
        if len(seen['reduced']) < calls:
            seen['reduced'].append(_cpu(out))
        return out

    trainer._step_env, trainer.loss_and_grads, mesh.mean = (
        counted_step, recorded_call, recorded_mean)
    return seen


def _run_learner(task: dict, mesh, trainer, init, advance, count: int):
    from torch.profiler import ProfilerActivity, profile
    dev = mesh.device
    cuda = dev.type == 'cuda'
    states = task.get('states')
    ts = init() if states is None else map_tensors(
        lambda t: t.to(dev), states[mesh.rank])
    result = {'states': [], 'metrics': [], 'launches': [], 'seconds': []}
    checks = None
    if task.get('check') is not None:
        checks = _attach_checks(trainer, mesh, task['check'])
        result['env_steps'] = []
    for i in range(count):
        args = () if task.get('draws') is None else map_tensors(
            lambda t: t.to(dev), task['draws'][i][mesh.rank])
        steps0 = checks['env_steps'].launches if checks is not None else 0
        launches0 = _launches()
        window = (profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
            if task.get('profile') and i == count - 1
            else contextlib.nullcontext())
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with window as prof:
            ts, metrics = advance(ts, *args)
            if cuda:
                torch.cuda.synchronize()
        result['seconds'].append(time.perf_counter() - t0)
        if prof is not None:
            result['collectives'] = distributed.collective_counts(prof)
            result['collective_times'] = distributed.collective_times(prof)
        result['states'].append(_cpu(ts))
        result['metrics'].append(_cpu(metrics))
        result['launches'].append(tuple(
            b - a for a, b in zip(launches0, _launches())))
        if checks is not None:
            result['env_steps'].append(checks['env_steps'].launches
                                       - steps0)
    if checks is not None:
        result['record'] = {k: checks[k]
                            for k in ('args', 'local', 'reduced')}
    return result


def _dqn(task: dict, mesh):
    from marlsnake_torch.algo.dqn_trainer import DQNConfig
    from marlsnake_torch.parallel.dqn_dp import DistributedDQN
    ddqn = DistributedDQN(DQNConfig(**task['config']), mesh)
    return _run_learner(task, mesh, ddqn.trainer, ddqn.init_state,
                        ddqn.train_episode, task['episodes'])


def _ppo(task: dict, mesh):
    from marlsnake_torch.algo.ppo_trainer import PPOConfig
    from marlsnake_torch.parallel.ppo_dp import DistributedPPO
    dppo = DistributedPPO(PPOConfig(**task['config']), mesh)
    return _run_learner(task, mesh, dppo.trainer, dppo.init_state,
                        dppo.train_update, task['updates'])


def _scaling(task: dict, mesh):
    from marlsnake_torch.core.types import EnvConfig
    cfg = EnvConfig(**task['env'])
    kwargs = dict(envs_per_device=task['envs_per_device'],
                  num_steps=task['num_steps'], mesh=mesh)
    return {'step_time': distributed.per_device_step_time(cfg, **kwargs),
            'scaling': distributed.scaling_efficiency(cfg, **kwargs)}


_TASKS = {'dqn': _dqn, 'ppo': _ppo, 'scaling': _scaling}


def run_rank(job: dict, rank: int, world: int, rendezvous: str) -> list:
    """Join the group at ``rendezvous`` as ``rank`` of ``world`` and run
    ``job``'s tasks; returns their results. TF32 is set off here: a
    spawned process does not inherit its parent's flags, and cuDNN's TF32
    default is on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if job['device'] == 'cpu':
        torch.set_num_threads(1)
    distributed.initialize(rendezvous, world, rank, job.get('backend'),
                           job['device'])
    try:
        return [_TASKS[task['kind']](task, make_mesh(world, job['device']))
                for task in job['tasks']]
    finally:
        torch.distributed.destroy_process_group()


def main() -> None:
    path, rank, world, rendezvous = (sys.argv[1], int(sys.argv[2]),
                                     int(sys.argv[3]), sys.argv[4])
    results = run_rank(torch.load(path, weights_only=False), rank, world,
                       rendezvous)
    torch.save(results, f'{path}.rank{rank}.pt')


if __name__ == '__main__':
    main()
