"""One rank of a local cluster as a program of its own: ``python -m
marlsnake_torch.parallel.mp_worker RANK WORLD RENDEZVOUS DEVICE BACKEND``.

The rank joins the group (``RENDEZVOUS`` an init method, ``BACKEND``
'nccl', 'gloo' or 'default'), runs the local cluster's one
``DistributedDQN`` episode (``distributed.cluster_job``) through the
runner on ``DEVICE``, and prints its ``distributed.cluster_result`` as one
JSON line: ``process_id``, ``num_processes``, ``param_digest``,
``mean_reward`` and ``updates``. ``distributed.launch_local_cluster`` runs
the same episode in every rank through ``runner.run_job``.
"""

import json
import sys


def main() -> None:
    from marlsnake_torch.parallel import distributed, runner
    rank, world, rendezvous, device, backend = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5])
    job = distributed.cluster_job(world, device,
                                  None if backend == 'default' else backend)
    results = runner.run_rank(job, rank, world, rendezvous)
    print(json.dumps(distributed.cluster_result(rank, world, results[0])),
          flush=True)


if __name__ == '__main__':
    main()
