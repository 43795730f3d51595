"""Data-parallel training over ``torch.distributed``.

The port of the JAX package's ``parallel/``: the env batch, the replay
ring, the rollout and GAE are split across ranks, one device a rank;
parameters and optimizer state are replicated, and gradients are averaged
with one all-reduce per update (``mesh.py``, ``dqn_dp.py``,
``ppo_dp.py``). ``distributed.py`` starts a process group and a local
cluster of ranks, measures scaling and counts collectives;
``runner.py`` is the program its ranks run, and ``mp_worker.py`` runs
the local cluster's episode as one rank through it.
"""
