"""PPO training traffic: ``PPOTrainer.collect`` then ``learn``, one update
after another.

Set-up builds one trainer, gives it weights made on the device from the
seed (``reference.nets.init_params``), resets its envs from the seed's
draws and runs the first update, which captures the rollout's graph. The
window's call is one more update. Each update's draws (the rollout's
fruit and reset draws, the action sample's Gumbel noise, an order of the
samples for each epoch) are made on the device from the seed's generator
and handed to the call. A unit of work is an env-step of the rollout:
``num_envs * rollout_steps`` an update.

The check: the reference (``reference.learners.ppo_update``) follows the
first update from the same weights, envs and draws, and the program is
held to it by the update's loss, by its rollout's advantages (GAE over
the logits, actions, values and rewards), by Adam's first moment after
it (the median leaf) and by the parameters' change (the worst leaf).
Later updates are not compared: after the first, the parameters differ
by rounding, and where the Gumbel sample of some agent flips, its env's
trajectory and every later number part from the reference's by far more
than rounding, on some seeds and not on others.
"""

from __future__ import annotations

import time

import torch

from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
from marlsnake_torch.rng import PPODraws, ResetDraws, StepDraws
from perfbench import compare
from perfbench.port import check_env
from perfbench.reference import nets
from perfbench.reference.engine import Engine, game_from_config
from perfbench.reference.learners import ppo_update


class Driver:
    work = 'train_env_steps'
    profile_calls = 1

    def __init__(self, config: dict, params: dict, seed: int, device):
        self.config, self.params, self.seed = config, params, seed
        self.device = torch.device(device)
        self.tracing = False
        self.spans = {'ppo.collect': [], 'ppo.learn': []}
        e, t = config['env'], config['train']
        self.hp = dict(t, **{k: params[k] for k in (
            'rollout_steps', 'update_epochs', 'num_minibatches')})
        self.trainer_config = PPOConfig(
            num_snakes=e['num_snakes'], height=e['height'], width=e['width'],
            snake_length=e['snake_length'], reward_dict=e['rewards'],
            num_envs=params['num_envs'],
            rollout_steps=params['rollout_steps'], lr=t['lr'],
            gamma=t['gamma'], gae_lambda=t['gae_lambda'],
            clip_eps=t['clip_eps'], ent_coef=t['ent_coef'],
            vf_coef=t['vf_coef'], max_grad_norm=t['max_grad_norm'],
            update_epochs=params['update_epochs'],
            num_minibatches=params['num_minibatches'])
        self.layout = nets.actor_critic_layout(e['height'], e['width'], 8,
                                               config['net']['actions'])

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _draws(self) -> PPODraws:
        """One update's draws from the seed's generator."""
        e, p = self.config['env'], self.params
        t, envs, n = p['rollout_steps'], p['num_envs'], e['num_snakes']
        step = StepDraws(self._rand(t, envs, n), self._rand(t, envs),
                         self._rand(t, envs, round(0.8 * n)))
        u = self._rand(t, envs, n, self.config['net']['actions'])
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
        rows = t * envs * n
        perm = torch.stack([torch.randperm(rows, generator=self.gen,
                                           device=self.device)
                            for _ in range(p['update_epochs'])])
        return PPODraws(step, gumbel, perm)

    def setup(self) -> None:
        self.trainer = PPOTrainer(self.trainer_config, device=self.device)
        check_env(self.trainer.env_cfg, self.config)
        got = [(k, tuple(v.shape))
               for k, v in self.trainer.net.state_dict().items()]
        if got != self.layout:
            raise ValueError(f'the ActorCritic parameters are not the '
                             f'reference layout: {got}')
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        self.p0 = nets.init_params(self.layout, self.gen, self.device)
        envs = self.params['num_envs']
        self.reset = ResetDraws(
            self._rand(envs),
            self._rand(envs, round(0.8 * self.config['env']['num_snakes'])))
        ts = self.trainer.init_state(self.reset)
        for k, v in ts.params.items():
            v.copy_(self.p0[k])
        self.ts = ts
        self.first = None    # (draws, metrics) of the first update
        self._update()

    def _clock(self) -> float:
        """The host clock once the device has done what was queued."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _update(self) -> int:
        draws = self._draws()
        trainer = self.trainer
        if self.tracing:
            t0 = self._clock()
        ts = trainer.collect(self.ts, draws)
        if self.tracing:
            t1 = self._clock()
        if self.first is None:
            self.adv1 = trainer.trajectory.advantages.clone()
        self.ts, m = trainer.learn(ts, draws.perm)
        if self.tracing:
            t2 = self._clock()
            self.spans['ppo.collect'].append(t1 - t0)
            self.spans['ppo.learn'].append(t2 - t1)
        if self.first is None:
            self.first = (draws, m)
            self.mu1 = dict(zip(self.ts.params, self.ts.opt_state.mu))
            self.p1 = self.ts.params
        return self.params['num_envs'] * self.params['rollout_steps']

    def call(self):
        return self._update(), None

    def release(self) -> None:
        """Frees the program's state; keeps what the check reads: the
        program's results in the reference's form."""
        m = self.first[1]
        self.program = (
            {'actor': float(m.loss_actor), 'value': float(m.loss_value),
             'entropy': float(m.entropy)}, self.adv1, self.mu1, self.p1)
        del self.trainer, self.ts
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, fault=None):
        """The reference over the first update: (its loss terms, its
        rollout's advantages, Adam's first moment after it, the
        parameters after it)."""
        with nets.tf32(tf32):
            t = self.config['train']
            env = Engine(game_from_config(self.config['env']), self.device)
            adam = nets.Adam(self.p0, t['lr'], t['adam_eps'],
                             t['max_grad_norm'])
            state, obs = env.reset(*self.reset)
            carry = (state, obs, torch.zeros(obs.shape[:2], dtype=torch.bool,
                                             device=self.device))
            draws = self.first[0]
            p, _, info = ppo_update(
                env, self.hp, self.p0, adam, carry,
                (*draws.step, draws.gumbel, draws.perm), fault)
            terms = {k: info[k] for k in ('actor', 'value', 'entropy')}
            return terms, info['adv'], dict(adam.mu), p

    def _loss_gap(self, prog: dict, ref: dict) -> float:
        """The gap of the total loss (the mean of the minibatches' terms)
        over the sum of the terms' sizes: the terms nearly cancel, and the
        total alone is no scale."""
        t = self.config['train']
        w = {'actor': 1.0, 'value': t['vf_coef'], 'entropy': -t['ent_coef']}
        gap = sum(w[k] * (prog[k] - ref[k]) for k in w)
        return abs(gap) / max(sum(abs(w[k] * ref[k]) for k in w), 1e-12)

    def numbers(self, prog, ref) -> dict:
        """The numbers compared, ``prog`` against ``ref``."""
        (p_loss, p_adv, p_mu, p_p1), (r_loss, r_adv, r_mu, r_p1) = prog, ref
        keep = compare.moving_leaves(compare.norms(r_mu))
        dp = {k: p_p1[k] - self.p0[k] for k in self.p0}
        dr = {k: r_p1[k] - self.p0[k] for k in self.p0}
        scale = float(r_adv.abs().max().clamp_min(1e-12))
        return {
            'loss_gap': self._loss_gap(p_loss, r_loss),
            'adv_gap': float((p_adv - r_adv).abs().max()) / scale,
            'grad_gap': compare.leaf_gap(p_mu, r_mu, keep, worst=False),
            'update_gap': compare.leaf_gap(dp, dr, keep),
        }

    def controls(self) -> dict:
        """The control (the reference in TF32 in the program's place), the
        same with TF32 in the minibatch epochs alone, and the fault of
        half of each batch left out, against the reference."""
        ref = self.reference()
        return {'control': self.numbers(self.reference(tf32=True), ref),
                'control_epochs': self.numbers(
                    self.reference(fault='tf32_epochs'), ref),
                'half_batch': self.numbers(
                    self.reference(fault='half_batch'), ref)}

    def compared(self) -> dict:
        """The program's numbers against the reference's."""
        return self.numbers(self.program, self.reference())
