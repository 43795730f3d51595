"""PPO training of the Moonlight agent: ``PPOTrainer`` with
``net='moonlight_agent'``, ``collect`` then ``learn``, one update after
another.

Set-up builds one trainer for the configuration file's decoder (its
widths as published, its ``layers``, the router's ``router_experts``
and the ``held_experts`` of its deployment, bfloat16 compute), gives it
weights made on the device from the file's ``weights_seed``
(``reference.moonlight.init_params``: the same weights, so the same
routing, in every run; drawn again where the check needs them, since
the trainer's step runs in place, ``in_place``), resets its envs from the
seed's draws and runs the first update, which captures the rollout's
graph. The window's call
is one more update. Each update's draws (the rollout's fruit and reset
draws, the action sample's Gumbel noise, an order of the samples an
epoch) are made on the device from the seed's generator. A unit of work
is an env-step of the rollout: ``num_envs * rollout_steps`` an update.

The check: the reference (``reference.moonlight.ppo_update``, float32)
follows the first update from the same weights, envs and draws and from
the program's recorded actions, in blocks of ``reference_block``
samples. The program is held to it by the restricted log-probs and the
values of every valid agent at every rollout step (root mean squares of
the gaps), by the update's loss, by its advantages and by the
parameters' change after it (the worst leaf), as ``ppo_train`` holds
the ActorCritic; and by Adam's first moment after its first step: the
first minibatch's gradient as the clip to a global norm keeps it, each
leaf's share of the global norm (``grad_gap``, the median leaf; and on
the held experts' leaves, ``expert_grad_gap``), with that global norm
(``grad_norm_gap``). Both sides compute that gradient from the same
parameters. Adam's moment after the whole update is not compared: after
Adam's first step, whose size hardly depends on the gradient's, the
later minibatches part by more than rounding on some seeds, in the
bfloat16 reference as in the program (its median leaf read 0.0006-0.043
in sound runs).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
from marlsnake_torch.models.moonlight import AgentPrompt, MoonlightConfig
from marlsnake_torch.rng import PPODraws, ResetDraws, StepDraws
from perfbench import compare
from perfbench.port import env_config
from perfbench.reference import moonlight as ref
from perfbench.reference import nets
from perfbench.reference.engine import Engine, game_from_config

# what the program runs, of the keys a configuration file may state
PUBLISHED = {'attention_bias': False, 'hidden_act': 'silu',
             'moe_layer_freq': 1, 'n_group': 1, 'topk_group': 1,
             'norm_topk_prob': True, 'q_lora_rank': None,
             'scoring_func': 'sigmoid', 'topk_method': 'noaux_tc',
             'tie_word_embeddings': False, 'num_nextn_predict_layers': 0}
ACTIONS = 3
FAULTS = ('fp8_experts', 'zero_expert', 'top5', 'no_scale', 'half_batch')


def model_settings(config: dict) -> dict:
    """The decoder's settings as the reference reads them; raises where
    the file states a variant that the program does not run."""
    for key, want in PUBLISHED.items():
        if config[key] != want:
            raise ValueError(f'{key}: the program runs {want!r}, the '
                             f'configuration states {config[key]!r}')
    dep = config['deployment']
    if dep['held_experts'][1] != config['n_routed_experts']:
        raise ValueError('n_routed_experts counts the held experts')
    keys = ('hidden_size', 'num_attention_heads', 'kv_lora_rank',
            'qk_nope_head_dim', 'qk_rope_head_dim', 'v_head_dim',
            'intermediate_size', 'moe_intermediate_size', 'n_shared_experts',
            'num_experts_per_tok', 'routed_scaling_factor',
            'first_k_dense_replace', 'rms_norm_eps', 'rope_theta',
            'vocab_size', 'layers')
    m = {k: config[k] for k in keys}
    m.update(router_experts=dep['router_experts'],
             held=tuple(dep['held_experts']))
    return m


def _total(norms: dict) -> torch.Tensor:
    """The global norm of leaves given by their norms."""
    return torch.stack(list(norms.values())).norm()


def _shares(norms: dict) -> dict:
    """Each leaf's norm over the global norm: the direction that the clip
    to a global norm leaves."""
    total = _total(norms)
    return {k: v / total for k, v in norms.items()}


class Driver:
    work = 'train_env_steps'
    profile_calls = 1
    traced_calls = 2      # updates of the traced pass (traced_agent.py)

    def __init__(self, config: dict, params: dict, seed: int, device):
        self.config, self.params, self.seed = config, params, seed
        self.device = torch.device(device)
        self.tracing = False
        e, t = config['env'], config['train']
        self.m = model_settings(config)
        self.hp = dict(t, **{k: params[k] for k in (
            'rollout_steps', 'update_epochs', 'num_minibatches')})
        m = self.m
        moonlight = MoonlightConfig(
            **{k: m[k] for k in m if k not in ('layers', 'router_experts')},
            n_routed_experts=m['router_experts'],
            num_hidden_layers=m['layers'],
            bias_update_rate=t['bias_update_rate'],
            prompt=AgentPrompt(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in config['prompt'].items()}))
        self.trainer_config = PPOConfig(
            num_snakes=e['num_snakes'], height=e['height'], width=e['width'],
            snake_length=e['snake_length'], reward_dict=e['rewards'],
            num_envs=params['num_envs'],
            rollout_steps=params['rollout_steps'], lr=t['lr'],
            gamma=t['gamma'], gae_lambda=t['gae_lambda'],
            clip_eps=t['clip_eps'], ent_coef=t['ent_coef'],
            vf_coef=t['vf_coef'], max_grad_norm=t['max_grad_norm'],
            update_epochs=params['update_epochs'],
            num_minibatches=params['num_minibatches'],
            obs_format=e['obs_format'], net='moonlight_agent',
            moonlight=moonlight, in_place=True,
            compute_dtype=getattr(torch, config['precision']))
        self.layout = ref.layout(m)

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _draws(self) -> PPODraws:
        """One update's draws from the seed's generator."""
        e, p = self.config['env'], self.params
        t, envs, n = p['rollout_steps'], p['num_envs'], e['num_snakes']
        step = StepDraws(self._rand(t, envs, n), self._rand(t, envs),
                         self._rand(t, envs, round(0.8 * n)))
        u = self._rand(t, envs, n, ACTIONS)
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
        rows = t * envs * n
        perm = torch.stack([torch.randperm(rows, generator=self.gen,
                                           device=self.device)
                            for _ in range(p['update_epochs'])])
        return PPODraws(step, gumbel, perm)

    def setup(self) -> None:
        self.trainer = PPOTrainer(self.trainer_config, device=self.device)
        want = dataclasses.replace(env_config(self.config),
                                   obs_format=self.config['env']['obs_format'])
        if self.trainer.env_cfg != want:
            raise ValueError(f'the program runs {self.trainer.env_cfg}, the '
                             f'configuration states {want}')
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        envs = self.params['num_envs']
        self.reset = ResetDraws(
            self._rand(envs),
            self._rand(envs, round(0.8 * self.config['env']['num_snakes'])))
        ts = self.trainer.init_state(self.reset)
        got = [(k, tuple(v.shape)) for k, v in ts.params.items()]
        if got != self.layout or list(ts.buffers) != ref.bias_names(self.m):
            raise ValueError(f'the agent\'s parameters are not the reference '
                             f'layout: {got}, {list(ts.buffers)}')
        for k, v in self._weights().items():
            ts.params[k].copy_(v)
        self.ts = ts
        self.first = self.grad1 = None
        # the first minibatch's gradient as the learner takes it
        self.trainer.on_grads = self._first_minibatch
        self._update()
        self.trainer.on_grads = None

    def _first_minibatch(self, params, grads) -> None:
        if self.grad1 is None:
            self.grad1 = self._norms(zip(params, grads))

    def _weights(self) -> dict:
        """The weights the first update starts from, drawn again each time
        from ``weights_seed``: the trainer's step writes the parameters in
        place (``in_place``), and a draw on the device takes less time
        than a copy of 5.7 GB kept and moved."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config['weights_seed'])
        return ref.init_params(self.layout, gen, self.device,
                               self.config['weights_std'])

    def _update(self) -> int:
        draws = self._draws()
        trainer = self.trainer
        ts = trainer.collect(self.ts, draws)
        if self.first is None:
            traj = trainer.trajectory
            self.rollout = {k: getattr(traj, k).clone() for k in (
                'action', 'logprob', 'value', 'valid', 'advantages')}
        self.ts, m = trainer.learn(ts, draws.perm)
        if self.first is None:
            self.first = (draws, m)
            p0 = self._weights()
            self.dp1 = self._norms((k, v - p0[k])
                                   for k, v in self.ts.params.items())
        return self.params['num_envs'] * self.params['rollout_steps']

    @staticmethod
    def _norms(pairs) -> dict:
        """Each leaf's norm as a 0-d tensor (``compare.leaf_gap`` takes
        them as the leaves themselves)."""
        return {k: v.double().norm().cpu() for k, v in pairs}

    def call(self):
        return self._update(), None

    def release(self) -> None:
        """Frees the program's state; keeps what the check reads."""
        m = self.first[1]
        self.program = {
            'loss': {'actor': float(m.loss_actor),
                     'value': float(m.loss_value),
                     'entropy': float(m.entropy)},
            'logp': self.rollout['logprob'], 'value': self.rollout['value'],
            'valid': self.rollout['valid'],
            'adv': self.rollout['advantages'], 'dp': self.dp1,
            'grad1': self.grad1}
        del self.trainer, self.ts
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32, fault=None) -> dict:
        """The reference over the first update, in the program's form."""
        with nets.tf32(False):
            t = self.config['train']
            env = Engine(game_from_config(self.config['env']), self.device)
            p0 = self._weights()
            adam = nets.Adam(p0, t['lr'], t['adam_eps'], t['max_grad_norm'])
            state, obs = env.reset(*self.reset)
            carry = (state, obs, torch.zeros(obs.shape[:2], dtype=torch.bool,
                                             device=self.device))
            draws = self.first[0]
            bias = [torch.zeros(self.m['router_experts'], device=self.device)
                    for _ in ref.bias_names(self.m)]
            agent = ref.Agent(self.m, self.config['prompt'], dtype, fault)
            p, _, info = ref.ppo_update(
                env, self.hp, agent, p0, bias, adam, carry,
                (*draws.step, draws.perm), self.rollout['action'],
                self.params['reference_block'])
            out = {'loss': {'actor': info['actor'],
                            'value': info['value_loss'],
                            'entropy': info['entropy']},
                   'logp': info['logp'], 'value': info['value'],
                   'valid': info['valid'], 'adv': info['adv'],
                   'grad1': info['grad1'],
                   'dp': self._norms((k, v - p0[k]) for k, v in p.items())}
            del p, p0, adam
            return out

    def _loss_gap(self, prog: dict, ref_: dict) -> float:
        """The gap of the total loss over the sum of the terms' sizes."""
        t = self.config['train']
        w = {'actor': 1.0, 'value': t['vf_coef'], 'entropy': -t['ent_coef']}
        gap = sum(w[k] * (prog[k] - ref_[k]) for k in w)
        return abs(gap) / max(sum(abs(w[k] * ref_[k]) for k in w), 1e-12)

    def numbers(self, prog: dict, ref_: dict) -> dict:
        """The numbers compared, ``prog`` against ``ref_``."""
        valid = ref_['valid']

        def rms(x):
            return math.sqrt(float((x[valid].double() ** 2).mean()))

        keep = compare.moving_leaves(compare.norms(ref_['grad1']))
        scale = float(ref_['adv'].abs().max().clamp_min(1e-12))
        p1, r1 = _shares(prog['grad1']), _shares(ref_['grad1'])
        return {
            'logp_gap': rms(prog['logp'] - ref_['logp']),
            'value_gap': rms(prog['value'] - ref_['value'])
            / max(rms(ref_['value']), 1e-12),
            'loss_gap': self._loss_gap(prog['loss'], ref_['loss']),
            'adv_gap': float((prog['adv'] - ref_['adv']).abs().max()) / scale,
            'grad_gap': compare.leaf_gap(p1, r1, keep, worst=False),
            'update_gap': compare.leaf_gap(prog['dp'], ref_['dp'], keep),
            'grad_norm_gap': abs(float(_total(prog['grad1'])
                                       / _total(ref_['grad1'])) - 1.0),
            'expert_grad_gap': compare.leaf_gap(
                p1, r1, [k for k in r1 if '.experts.' in k], worst=False),
        }

    def controls(self) -> dict:
        """The control (the reference in bfloat16 in the program's place)
        and each fault, planted in the reference put in the program's
        place, against the reference."""
        sound = self.reference()
        out = {'control': self.numbers(self.reference(torch.bfloat16),
                                       sound)}
        for fault in FAULTS:
            out[fault] = self.numbers(self.reference(fault=fault), sound)
        return out

    def compared(self) -> dict:
        """The program's numbers against the reference's."""
        return self.numbers(self.program, self.reference())
