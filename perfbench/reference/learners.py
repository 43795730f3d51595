"""The plain reference of the two learners: a DQN training episode and a
PPO update, in plain torch over the reference engine and nets. Imports
nothing of the program.

DQN episode (the reference trainer's loop, all envs stepped together):
reset; then while an env is live, a step of: Q-values of every agent,
epsilon-greedy actions (a given random action where a given uniform is
under epsilon, else the first maximum; 0 for a done agent), the env step
without reset with finished envs held still, the early-death penalty
while the live-step count is under its threshold, a push of the agents
alive at the step's start into the ring (slot ``(ptr + i) % capacity``
in row order), and, once the ring holds ``min_buffer_size`` transitions
and an env is still live, one update: a sample of ``batch`` slots
without replacement (the first ``batch`` of a stable argsort of the
given keys, unfilled slots last), the mean Huber loss of ``Q(s, a)``
against ``r + (1 - done) * gamma * max_a Q_target(s', a)``, and a clipped
Adam step. The episode's mean loss is over its updates.

PPO update: a rollout of ``T`` steps of auto-resetting envs, each step
the logits and value of every agent, the action ``argmax(logits +
gumbel)`` (0 for a done agent) and its log-probability; rewards of agents
done at the step's start are 0; GAE with the bootstrap cut where an agent
is done or its episode ends; then epochs of minibatches in the given
order, each a clipped-surrogate loss with the advantages normalised over
the minibatch's valid rows, a value loss and an entropy bonus, and a
clipped Adam step.

``fault`` plants a defect in the reference put in the program's place,
to show that the comparison catches it: 'half_batch' takes the loss over
the first half of each batch; 'tf32_epochs' (PPO) runs the minibatch
epochs alone with TF32 on in cuBLAS and cuDNN.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch

from perfbench.reference import nets
from perfbench.reference.engine import Engine

F32 = torch.float32


def _half(x: torch.Tensor, fault: Optional[str]) -> torch.Tensor:
    return x[:x.shape[0] // 2] if fault == 'half_batch' else x


class Ring:
    """The replay ring: flat uint8 obs, one row a transition."""

    def __init__(self, capacity: int, obs_numel: int, device):
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.cap = capacity
        self.obs = z((capacity, obs_numel), torch.uint8)
        self.next_obs = z((capacity, obs_numel), torch.uint8)
        self.action = z((capacity,), torch.int32)
        self.reward = z((capacity,), F32)
        self.done = z((capacity,), torch.bool)
        self.ptr = 0
        self.size = 0

    def push(self, obs, action, reward, next_obs, done, mask):
        rows = mask.nonzero()[:, 0]
        slots = (self.ptr + torch.arange(rows.numel(),
                                         device=rows.device)) % self.cap
        self.obs[slots] = obs.reshape(obs.shape[0], -1)[rows]
        self.next_obs[slots] = next_obs.reshape(obs.shape[0], -1)[rows]
        self.action[slots] = action[rows].to(torch.int32)
        self.reward[slots] = reward[rows]
        self.done[slots] = done[rows]
        self.ptr = (self.ptr + rows.numel()) % self.cap
        self.size = min(self.size + rows.numel(), self.cap)

    def sample(self, batch: int, keys: torch.Tensor) -> torch.Tensor:
        slot = torch.arange(self.cap, device=keys.device)
        k = keys + (slot >= self.size).to(keys.dtype) * 2.0
        return torch.argsort(k, stable=True)[:batch] % max(self.size, 1)


def huber(pred, target):
    err = (pred - target).abs()
    quad = err.clamp(max=1.0)
    return 0.5 * quad ** 2 + (err - quad)


def dqn_episode(env: Engine, hp: dict, params, target, adam: nets.Adam,
                ring: Ring, epsilon: float, reset, draws,
                fault: Optional[str] = None):
    """One training episode. ``reset`` = (spawn_u, fruit_u); ``draws`` =
    (rand, explore_u, fruit_u, sample_keys), step axis first. Returns
    (params, {'loss': mean loss, 'length': live steps, 'reward': mean
    shaped reward a agent, 'updates': count})."""
    rand, explore_u, fruit_u, keys = draws
    state, obs = env.reset(*reset)
    e, n = obs.shape[:2]
    dev = obs.device
    out = None
    dones = torch.zeros((e, n), dtype=torch.bool, device=dev)
    frozen = torch.zeros((e,), dtype=torch.bool, device=dev)
    ep_rew = torch.zeros((e, n), dtype=F32, device=dev)
    loss_sum, updates, steps = torch.zeros((), device=dev), 0, 0
    for t in range(hp['max_steps_per_episode']):
        if bool(frozen.all()):
            break
        with torch.no_grad():
            q = nets.dqn(params, obs.reshape((e * n,) + obs.shape[2:]))
        greedy = q.argmax(-1).to(torch.int32).view(e, n)
        acts = torch.where(explore_u[t] < epsilon, rand[t], greedy)
        acts = torch.where(dones, 0, acts).to(torch.int32)
        new_state, new_out = env.step(
            state, acts, fruit_u[t],
            hold=None if out is None else (frozen, out))
        shaped = new_out.reward
        if steps < hp['early_death_threshold']:
            shaped = shaped + torch.where(new_out.done,
                                          hp['early_death_penalty'], 0.0)
        push = (~dones & ~frozen[:, None]).reshape(-1)
        ring.push(obs.reshape(e * n, -1), acts.reshape(-1),
                  shaped.reshape(-1), new_out.obs.reshape(e * n, -1),
                  new_out.done.reshape(-1), push)
        ep_rew = ep_rew + torch.where(push.view(e, n), shaped, 0.0)
        steps += 1
        frozen = frozen | new_out.done.all(-1)
        state, out = new_state, new_out
        obs, dones = out.obs, out.done
        if ring.size >= hp['min_buffer_size'] and not bool(frozen.all()):
            idx = ring.sample(hp['batch_size'], keys[t])
            shape = (idx.numel(),) + obs.shape[2:]
            b_obs = ring.obs[idx].view(shape)
            b_next = ring.next_obs[idx].view(shape)
            b_act, b_rew = ring.action[idx], ring.reward[idx]
            b_done = ring.done[idx]
            with torch.no_grad():
                next_q = nets.dqn(target, b_next).max(-1).values
                y = b_rew + (1.0 - b_done.to(F32)) * hp['gamma'] * next_q

            def loss_fn(p):
                qs = nets.dqn(p, _half(b_obs, fault))
                q_sa = qs.gather(1, _half(b_act, fault).long()[:, None])[:, 0]
                return huber(q_sa, _half(y, fault)).mean()

            loss, grads = nets.grads_of(loss_fn, params)
            params = adam.step(params, grads)
            loss_sum = loss_sum + loss
            updates += 1
    return params, {'loss': float(loss_sum / max(updates, 1)),
                    'length': steps, 'updates': updates,
                    'reward': float(ep_rew.sum() * (1.0 / ep_rew.numel()))}


def ppo_update(env: Engine, hp: dict, params, adam: nets.Adam, carry,
               draws, fault: Optional[str] = None):
    """One update. ``carry`` = (state, obs, agent_done) of the envs;
    ``draws`` = (fruit_u, reset_spawn_u, reset_fruit_u, gumbel, perm),
    step axis first. Returns (params, carry, {'actor', 'value', 'entropy',
    'adv'}): the mean over minibatches of each loss term, and the
    rollout's advantages."""
    fruit_u, spawn_u, rfruit_u, gumbel, perm = draws
    state, obs, agent_done = carry
    e, n = obs.shape[:2]
    T = hp['rollout_steps']
    rec = {k: [] for k in ('obs', 'action', 'logp', 'value', 'reward',
                           'valid', 'next_done')}
    with torch.no_grad():
        for t in range(T):
            logits, value = nets.actor_critic(
                params, obs.reshape((e * n,) + obs.shape[2:]))
            logits, value = logits.view(e, n, -1), value.view(e, n)
            action = (logits + gumbel[t]).argmax(-1)
            logp = torch.log_softmax(logits, -1).gather(
                -1, action[..., None])[..., 0]
            action = action.to(torch.int32).masked_fill(agent_done, 0)
            state, out = env.step_autoreset(state, action, fruit_u[t],
                                            spawn_u[t], rfruit_u[t])
            valid = ~agent_done
            rec['obs'].append(obs.reshape(e * n, -1))
            rec['action'].append(action)
            rec['logp'].append(logp)
            rec['value'].append(value)
            rec['reward'].append(torch.where(valid, out.reward, 0.0))
            rec['valid'].append(valid)
            rec['next_done'].append(out.done | out.done_all[:, None])
            agent_done = out.done & ~out.done_all[:, None]
            obs = out.obs
        _, last = nets.actor_critic(params,
                                    obs.reshape((e * n,) + obs.shape[2:]))
    r = {k: torch.stack(v) for k, v in rec.items()}
    nonterm = 1.0 - r['next_done'].to(F32)
    next_v = torch.cat([r['value'][1:], last.view(1, e, n)])
    delta = r['reward'] + hp['gamma'] * next_v * nonterm - r['value']
    decay = hp['gamma'] * hp['gae_lambda'] * nonterm
    adv = torch.zeros_like(r['value'])
    gae = torch.zeros((e, n), device=obs.device)
    for t in reversed(range(T)):
        gae = delta[t] + decay[t] * gae
        adv[t] = gae
    ret = adv + r['value']
    with nets.tf32(True) if fault == 'tf32_epochs' else nullcontext():
        params, terms = _ppo_epochs(hp, params, adam, r, adv, ret, perm,
                                    obs.shape[2:], fault)
    actor, value_loss, ent = torch.stack(terms).mean(0).tolist()
    return params, (state, obs, agent_done), {
        'actor': actor, 'value': value_loss, 'entropy': ent, 'adv': adv}


def _ppo_epochs(hp: dict, params, adam: nets.Adam, r: dict, adv, ret, perm,
                obs_shape, fault: Optional[str]):
    """The minibatch epochs of a PPO update over the rollout ``r``; the
    parameters and each minibatch's (actor, value, entropy) terms."""
    rows = adv.numel()
    flat = dict(obs=r['obs'].reshape(rows, -1),
                action=r['action'].reshape(rows),
                logp=r['logp'].reshape(rows), adv=adv.reshape(rows),
                ret=ret.reshape(rows), valid=r['valid'].reshape(rows))
    mb = rows // hp['num_minibatches']
    terms = []
    for epoch in perm:
        for idx in epoch[:mb * hp['num_minibatches']].view(-1, mb):
            idx = _half(idx, fault)
            m = {k: v[idx] for k, v in flat.items()}
            m_obs = m['obs'].view((idx.numel(),) + obs_shape)

            def loss_fn(p):
                logits, value = nets.actor_critic(p, m_obs)
                lp_all = torch.log_softmax(logits, -1)
                lp = lp_all.gather(-1, m['action'].long()[:, None])[:, 0]
                v = m['valid'].to(F32)
                vsum = v.sum().clamp_min(1.0)
                ratio = torch.exp(lp - m['logp'])
                mean = (m['adv'] * v).sum() / vsum
                a = (m['adv'] - mean) / (torch.sqrt(
                    ((m['adv'] - mean) ** 2 * v).sum() / vsum) + 1e-8)
                eps = hp['clip_eps']
                pg = torch.maximum(-a * ratio,
                                   -a * torch.clamp(ratio, 1 - eps, 1 + eps))
                actor = (pg * v).sum() / vsum
                value_loss = (0.5 * (value - m['ret']) ** 2 * v).sum() / vsum
                ent = (-(torch.exp(lp_all) * lp_all).sum(-1) * v).sum() / vsum
                terms.append(torch.stack([actor, value_loss, ent]).detach())
                return (actor + hp['vf_coef'] * value_loss
                        - hp['ent_coef'] * ent)

            _, grads = nets.grads_of(loss_fn, params)
            params = adam.step(params, grads)
    return params, terms
