"""DAgger distillation of the trained DQN into a small acting net: the
JAX repository's ``tools/distill_acting.py`` on the port.

Each outer iteration rolls the env under the STUDENT's greedy policy (the
states the student itself visits), labels every visited obs with the
frozen teacher's greedy action and Q-values, trains the student with
cross-entropy plus 0.1 x a soft logit-matching term over 64 minibatches
of 4,096 (Adam at 3e-4), and reports the updated student's argmax
agreement with the labels over the whole buffer. The env is 20x20 with 4
snakes of length 3, 32 rollout steps of E envs a iteration, each step
one launch of the auto-reset step kernel (K1) on the card.

The teacher is the reference-width DQN, float32 with TF32 off, with the
``dqn_params`` of ``artifacts/hybrid_neat_20x20.pkl``, bit-equal to the
orbax ``artifacts/dqn20_ckpt`` ``showcase20`` that JAX's tool loads. The
student is ``DistilledDQN(conv, fc)``, computed in bfloat16 as JAX's,
from flax's initialisation (``flax_init_``, seeded 11 as JAX's
``student.init(key(11), ...)``). An iteration takes its draws up front
(``rng.DistillDraws``: the rollout's step draws and the minibatch rows)
and reads nothing back: the loss and the agreement are read only at
JAX's print cadence (every 5th iteration and the last), in JAX's format.
The iteration runs uncaptured, with no CUDA graph: on an H100 at the
committed student's widths it launches ~7,700 kernels for ~0.33 s of
device work (``chip_smoke.py``'s ``distill_phase``).

The student goes to ``OUT/ckpt/distilled_acting.msgpack`` in flax's
layout (``flax.serialization.from_bytes`` reads it; git-ignored under
``artifacts/torch/ckpt/``), its meta, with JAX's keys and the card, to
``OUT/distilled_acting.msgpack.meta.json``. The last line printed is one
JSON object: the card, the seconds in all, the ms of an iteration split
into rollout, teacher labels, SGD and agreement (CUDA events), the
agreement and the loss.

    python -m marlsnake_torch.tools.distill_acting [ITERS [ENVS [CONV [FC]]]]
    python -m marlsnake_torch.tools.distill_acting 200 256 32,64 128
    python -m marlsnake_torch.tools.distill_acting 2 2 --device cpu \\
        --out /tmp/distill

The defaults are JAX's (60 iterations, 256 envs, conv 16,32, fc 64); a
run into the default ``OUT`` (``artifacts/torch``) must be at those or
at the committed student's (200, 256, 32,64, 128). From Python, ``run``
also takes the rollout, SGD and batch sizes. The envs and the draws are
seeded 0, as JAX's ``key(0)``, and the student computes in bfloat16.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

from marlsnake_torch.algo import optim
from marlsnake_torch.algo.optim import mean_of
from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw, msgpack_pack
from marlsnake_torch.core.state import EnvState
from marlsnake_torch.core.types import FEATURE_CHANNEL, EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import VectorSnakeEnv
from marlsnake_torch.models.dqn import DQN, DistilledDQN
from marlsnake_torch.models.weights import (distilled_dqn_to_flax,
                                            dqn_from_flax, flax_init_)
from marlsnake_torch.rng import DistillDraws, derive_seed, distill_draws
from marlsnake_torch.utils.profiling import card_label

# tools/distill_acting.py:45-47, :66, :104, :125
ROLLOUT_STEPS = 32
SGD_STEPS = 64
BATCH = 4096
LR = 3e-4
SOFT_WEIGHT = 0.1
PRINT_EVERY = 5
SEED = 0  # tools/distill_acting.py:119, key(0)
STUDENT_SEED = 11

HYBRID = os.path.join('artifacts', 'hybrid_neat_20x20.pkl')
OUT_DIR = os.path.join('artifacts', 'torch')
STUDENT = 'distilled_acting.msgpack'
# JAX's defaults (tools/distill_acting.py:37-43), and the counts of the
# committed student (artifacts/distilled_acting.msgpack.meta.json)
DEFAULTS = dict(outer_iters=60, num_envs=256, conv=(16, 32), fc=(64,))
COMMITTED = dict(outer_iters=200, num_envs=256, conv=(32, 64), fc=(128,))
PARTS = ('rollout', 'teacher', 'sgd', 'agreement')
# the rest of a run's counts, as both of those runs have them
_SIZES = dict(rollout_steps=ROLLOUT_STEPS, sgd_steps=SGD_STEPS, batch=BATCH)

Params = Dict[str, torch.Tensor]


def env_config() -> EnvConfig:
    return EnvConfig(height=20, width=20, num_snakes=4, snake_length=3)


def make_teacher(params, cfg: EnvConfig, device='cuda') -> DQN:
    """The reference-width DQN with flax ``params``, float32."""
    hw = (cfg.height, cfg.width)
    net = DQN(hw, FEATURE_CHANNEL, cfg.num_actions, assume_binary_obs=True,
              device='cpu')
    net.load_state_dict(dqn_from_flax(params, hw))
    return net.to(resolve_device(device))


def make_student(cfg: EnvConfig, conv: Sequence[int], fc: Sequence[int],
                 device='cuda', compute_dtype=torch.bfloat16,
                 seed: int = STUDENT_SEED) -> DistilledDQN:
    """``DistilledDQN(conv, fc)`` from flax's initialisation, drawn from
    ``seed`` on the CPU and then moved, so that the weights do not depend
    on the device."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = flax_init_(DistilledDQN(
            (cfg.height, cfg.width), FEATURE_CHANNEL, cfg.num_actions,
            tuple(conv), tuple(fc), compute_dtype=compute_dtype,
            device='cpu'))
    return net.to(resolve_device(device))


class Outer(NamedTuple):
    """What an outer iteration returns: the envs and obs it ends at, the
    updated student parameters and Adam state, the mean minibatch loss
    and the agreement (0-d tensors, not read back), and the buffer of
    visited obs (T*E*N, H, W, C) with the teacher's labels."""
    states: EnvState
    obs: torch.Tensor
    params: Params
    opt_state: optim.AdamState
    loss: torch.Tensor
    agreement: torch.Tensor
    data: torch.Tensor
    labels: torch.Tensor


def greedy(student: DistilledDQN, params: Params,
           obs: torch.Tensor) -> torch.Tensor:
    """The student's argmax actions over a batch of per-agent obs."""
    return torch.func.functional_call(student, params, (obs,)).argmax(-1)


def rollout(env: VectorSnakeEnv, student: DistilledDQN, params: Params,
            states: EnvState, obs: torch.Tensor, draws: DistillDraws):
    """The student's greedy rollout of ``draws``' steps: (states, obs
    after it, the obs of every step before its action, flat)."""
    steps = draws.step.fruit_u.shape[0]
    data = torch.empty((steps,) + tuple(obs.shape), dtype=obs.dtype,
                       device=obs.device)
    for t in range(steps):
        data[t] = obs
        acts = greedy(student, params, obs.flatten(0, 1))
        states, out = env.step(states, acts.to(torch.int32).view(
            obs.shape[:2]), draws.step_at(t))
        obs = out.obs
    return states, obs, data.flatten(0, 2)


def distill_loss(logits: torch.Tensor, labels: torch.Tensor,
                 q: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels`` (the
    log-normaliser less the label's logit) averaged over the batch, plus
    ``SOFT_WEIGHT`` x the mean squared logit error, means as XLA's."""
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels[:, None])[:, 0]
    return mean_of(ce) + SOFT_WEIGHT * mean_of((logits - q) ** 2)


def loss_and_grads(student: DistilledDQN, params: Params, x: torch.Tensor,
                   labels: torch.Tensor, q: torch.Tensor):
    """(the loss of a minibatch, its gradients in the order of
    ``params``)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        logits = torch.func.functional_call(student, leaves, (x,))
        loss = distill_loss(logits, labels, q)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), list(grads)


def adam_step(params: Params, opt_state: optim.AdamState, grads):
    """One optax ``adam(LR)`` step: (params, opt_state)."""
    updates, opt_state = optim.adam_update(grads, opt_state, LR)
    return dict(zip(params, optim.apply_updates(list(params.values()),
                                                updates))), opt_state


def sgd(student: DistilledDQN, params: Params, opt_state: optim.AdamState,
        data: torch.Tensor, labels: torch.Tensor, q: torch.Tensor,
        idx: torch.Tensor):
    """One Adam step for each row of ``idx`` (its minibatch's buffer
    rows): (params, opt_state, the mean of the steps' losses)."""
    losses = []
    for rows in idx:
        loss, grads = loss_and_grads(student, params, data[rows],
                                     labels[rows], q[rows])
        params, opt_state = adam_step(params, opt_state, grads)
        losses.append(loss)
    return params, opt_state, mean_of(torch.stack(losses))


def outer_iteration(env: VectorSnakeEnv, teacher: DQN,
                    student: DistilledDQN, params: Params,
                    opt_state: optim.AdamState, states: EnvState,
                    obs: torch.Tensor, draws: DistillDraws,
                    mark: Optional[Callable[[str], None]] = None) -> Outer:
    """One DAgger iteration (tools/distill_acting.py:74-117): the
    student's rollout, the teacher's Q-values and argmax labels for the
    whole buffer, the SGD steps, then the updated student's agreement
    with the labels. ``mark(part)`` is called at the end of each part
    (``PARTS``)."""
    mark = mark or (lambda part: None)
    with torch.no_grad():
        states, obs, data = rollout(env, student, params, states, obs,
                                    draws)
        mark('rollout')
        t_q = teacher(data)
        labels = t_q.argmax(-1)
        mark('teacher')
    params, opt_state, loss = sgd(student, params, opt_state, data, labels,
                                  t_q, draws.idx)
    mark('sgd')
    with torch.no_grad():
        agree = mean_of((greedy(student, params, data) == labels).to(
            torch.float32))
    mark('agreement')
    return Outer(states, obs, params, opt_state, loss, agree, data, labels)


def refuse_narrowed(counts: dict, out: str) -> None:
    """Raise if a run at counts other than JAX's defaults or the
    committed student's would write into the default output directory,
    over the committed meta."""
    runs = (dict(DEFAULTS, **_SIZES), dict(COMMITTED, **_SIZES))
    if counts not in runs and os.path.abspath(out) == os.path.abspath(
            OUT_DIR):
        raise ValueError(f'a run at {counts} would overwrite the meta in '
                         f'{OUT_DIR}, made at {COMMITTED}: give it another '
                         f'out')


class _Events:
    """CUDA events at the ends of each iteration's parts (nothing on the
    CPU); ``ms()`` reads them after a synchronisation."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.iterations = []

    def start(self) -> Callable[[str], None]:
        marks = {}
        self.iterations.append(marks)

        def mark(part):
            if self.cuda:
                marks[part] = torch.cuda.Event(enable_timing=True)
                marks[part].record()

        mark('start')
        return mark

    def ms(self) -> list:
        """For each iteration, {part: ms, 'total': ms}."""
        out = []
        for marks in self.iterations:
            if not marks:
                continue
            names = ('start',) + PARTS
            row = {b: marks[a].elapsed_time(marks[b])
                   for a, b in zip(names[:-1], names[1:])}
            row['total'] = marks['start'].elapsed_time(marks[PARTS[-1]])
            out.append(row)
        return out


def _mean_rows(rows: list) -> Optional[dict]:
    return ({k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
            if rows else None)


def run(outer_iters: int = 60, num_envs: int = 256,
        conv: Sequence[int] = (16, 32), fc: Sequence[int] = (64,),
        out: str = OUT_DIR, hybrid: str = HYBRID, device='cuda',
        rollout_steps: int = ROLLOUT_STEPS, sgd_steps: int = SGD_STEPS,
        batch: int = BATCH) -> dict:
    """Distil, write the student and its meta, and return the summary."""
    counts = dict(outer_iters=outer_iters, num_envs=num_envs,
                  conv=tuple(conv), fc=tuple(fc),
                  rollout_steps=rollout_steps, sgd_steps=sgd_steps,
                  batch=batch)
    refuse_narrowed(counts, out)
    # the teacher's labels are the targets: float32, as parity pins them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(device)
    card = card_label(dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    t_begin = time.time()
    cfg = env_config()
    teacher = make_teacher(load_hybrid_raw(hybrid)['dqn_params'], cfg, dev)
    student = make_student(cfg, conv, fc, dev)
    params = {k: v.detach() for k, v in student.named_parameters()}
    opt_state = optim.adam_init(list(params.values()))
    env = VectorSnakeEnv(cfg, num_envs, autoreset=True, device=dev,
                         seed=SEED)
    states, obs = env.reset()
    gen = torch.Generator(device=dev)
    gen.manual_seed(derive_seed(SEED, 100))
    events = _Events(dev)
    rows = []
    t0 = time.time()
    for it in range(outer_iters):
        draws = distill_draws(cfg, num_envs, rollout_steps, sgd_steps,
                              batch, gen, dev)
        res = outer_iteration(env, teacher, student, params, opt_state,
                              states, obs, draws, events.start())
        states, obs, params, opt_state = res[:4]
        if it % PRINT_EVERY == 0 or it == outer_iters - 1:
            loss, agree = float(res.loss), float(res.agreement)
            rows.append(dict(iter=it, loss=loss, agreement=agree,
                             elapsed=time.time() - t0))
            print(f'iter {it:3d} | loss {loss:.4f} | '
                  f'agreement {agree * 100:.2f}% | '
                  f'{time.time() - t0:.0f}s', flush=True)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    total = time.time() - t_begin
    ms = events.ms()

    os.makedirs(os.path.join(out, 'ckpt'), exist_ok=True)
    path = os.path.join(out, 'ckpt', STUDENT)
    with open(path, 'wb') as f:
        f.write(msgpack_pack(distilled_dqn_to_flax(params)))
    agree = rows[-1]['agreement'] if rows else None
    meta = {'agreement_pct': None if agree is None
            else round(agree * 100, 2),
            'conv_channels': list(counts['conv']),
            'fc_features': list(counts['fc']),
            'teacher': f'{HYBRID} dqn_params',
            'outer_iters': outer_iters, 'num_envs': num_envs, 'card': card}
    meta_path = os.path.join(out, STUDENT + '.meta.json')
    with open(meta_path, 'w') as f:
        json.dump(meta, f)
    print('wrote', path, json.dumps(meta), flush=True)
    summary = dict(
        counts, card=card, total_s=total,
        iteration_ms_first=ms[0] if ms else None,
        iteration_ms_mean_after_first=_mean_rows(ms[1:]),
        agreement=agree, loss=rows[-1]['loss'] if rows else None,
        rows=rows, buffer_rows=rollout_steps * num_envs * cfg.num_snakes,
        max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == 'cuda' else None),
        student=path, meta=meta_path)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('counts', nargs='*',
                   help='ITERS [ENVS [CONV [FC]]], as the JAX script takes '
                        'them (CONV and FC comma-separated)')
    p.add_argument('--out', default=OUT_DIR)
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    if len(a.counts) > 4:
        p.error('at most four positional counts: ITERS ENVS CONV FC')
    c = a.counts + [None] * (4 - len(a.counts))

    def widths(s, default):
        return default if s is None else tuple(int(x) for x in s.split(','))

    return run(int(c[0] or DEFAULTS['outer_iters']),
               int(c[1] or DEFAULTS['num_envs']),
               widths(c[2], DEFAULTS['conv']), widths(c[3], DEFAULTS['fc']),
               a.out, device=a.device)


if __name__ == '__main__':
    main()
