"""DQN training traffic: ``DQNTrainer.train_episode``, whole episodes back
to back.

Set-up builds one trainer, gives it weights made on the device from the
seed (``reference.nets.init_params``) and drives it through three
episodes through the window's own call, the first of which captures the
chunk's graph. In the first two every action is a left turn (the draws'
random action, explored with certainty): a snake that turns left three
times runs into its own neck, so every env is done by the third step,
and the two make the run's first three optimizer updates, one and two.
The third is the window's traffic for its first ``prefix_steps`` steps
(two chunks): uniform random actions under the epsilon draws, fruit, the
early-death penalty, an update every step on a ring that wraps (the
first two episodes leave some 6,000 transitions in its 10,000 slots,
and every step pushes up to 1,024 more); from then on every action is a
left turn, so that it ends in the third chunk. The window's call is one
more episode, on draws made on the device from the seed's generator:
uniform random actions, explored where a uniform falls under epsilon,
fruit draws, replay sample keys. A unit of work is a trained env-step:
every env of the batch for every step in which an env was live, held
envs counted, as the trainer counts episode length.

The check: the reference (``reference.learners.dqn_episode``) trains
from the same weights on the same draws through the three set-up
episodes, and the program is held to it by each episode's mean TD loss,
mean reward, length and update count, by the first update's gradient as
Adam holds it (its first moment after one update, a tenth of the clipped
gradient), by the parameters' change over the first three updates and
over all of set-up's updates, each by the worst leaf, and by the replay
ring after the third episode (every slot, the write position and the
fill), element for element. Over whole episodes of random play the
learner is chaotic: the reference differs from itself, run twice, by as
much as the program differs from it, so the check follows the first
updates and a prefix of the window's traffic, before rounding has grown.
Adam's first moment after the third episode is not compared: one run in
three of one seed reads it 2% off in every leaf, as far as the control
does, on a ring equal to the reference's in every byte.
"""

from __future__ import annotations

import torch

from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
from marlsnake_torch.rng import ResetDraws, TrainDraws
from perfbench import compare
from perfbench.port import check_env
from perfbench.reference import nets
from perfbench.reference.engine import Engine, game_from_config
from perfbench.reference.learners import Ring, dqn_episode

RING = ('obs', 'action', 'reward', 'next_obs', 'done')

SETUP = ('turning', 'turning', 'prefix')   # set-up's episodes
LEFT = 1             # the 'snake' observer's left turn


class Driver:
    work = 'train_env_steps'
    profile_calls = 1

    def __init__(self, config: dict, params: dict, seed: int, device):
        self.config, self.params, self.seed = config, params, seed
        self.device = torch.device(device)
        e, t = config['env'], config['train']
        self.trainer_config = DQNConfig(
            num_snakes=e['num_snakes'], height=e['height'], width=e['width'],
            snake_length=e['snake_length'], reward_dict=e['rewards'],
            max_steps_per_episode=t['max_steps_per_episode'],
            batch_size=t['batch_size'], gamma=t['gamma'], lr=t['lr'],
            epsilon_start=t['epsilon_start'], epsilon_end=t['epsilon_end'],
            epsilon_decay=t['epsilon_decay'], buffer_size=t['buffer_size'],
            min_buffer_size=t['min_buffer_size'],
            target_update_freq=t['target_update_freq'],
            early_death_threshold=t['early_death_threshold'],
            early_death_penalty=t['early_death_penalty'],
            num_envs=params['num_envs'],
            update_every=params['update_every'])
        self.layout = nets.dqn_layout(e['height'], e['width'], 8,
                                      config['net']['actions'])

    def _draws(self, mode: str = 'window'):
        """One episode's (reset, train) draws from the seed's generator;
        ``mode`` 'turning': every action a left turn; 'prefix': the
        window's draws, every action a left turn from step
        ``prefix_steps`` on."""
        e = self.config['env']
        t = self.config['train']
        g, dev = self.gen, self.device
        envs, n = self.params['num_envs'], e['num_snakes']
        steps = t['max_steps_per_episode']
        fruits = round(0.8 * n)
        reset = ResetDraws(
            torch.rand((envs,), generator=g, device=dev),
            torch.rand((envs, fruits), generator=g, device=dev))
        shape = (steps, envs, n)
        if mode == 'turning':
            rand = torch.full(shape, LEFT, dtype=torch.int32, device=dev)
            explore = torch.zeros(shape, device=dev)
        else:
            rand = torch.randint(0, self.config['net']['actions'], shape,
                                 generator=g, device=dev, dtype=torch.int32)
            explore = torch.rand(shape, generator=g, device=dev)
        if mode == 'prefix':
            rand[self.params['prefix_steps']:] = LEFT
            explore[self.params['prefix_steps']:] = 0.0
        train = TrainDraws(
            rand, explore, torch.rand(shape, generator=g, device=dev),
            torch.rand((steps, t['buffer_size']), generator=g, device=dev))
        return reset, train

    def setup(self) -> None:
        self.trainer = DQNTrainer(self.trainer_config, device=self.device)
        check_env(self.trainer.env_cfg, self.config)
        got = [(k, tuple(v.shape))
               for k, v in self.trainer.net.state_dict().items()]
        if got != self.layout:
            raise ValueError(f'the DQN parameters are not the reference '
                             f'layout: {got}')
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        self.p0 = nets.init_params(self.layout, self.gen, self.device)
        ts = self.trainer.init_state()
        for k, v in ts.params.items():   # target_params is the same dict
            v.copy_(self.p0[k])
        self.followed = []   # (reset, draws, metrics) of set-up's episodes
        self.states = []     # (Adam's first moment, parameters) after each
        for mode in SETUP:
            reset, draws = self._draws(mode)
            ts, m = self.trainer.train_episode(ts, draws, reset)
            self.followed.append((reset, draws, m))
            self.states.append((dict(zip(ts.params, ts.opt_state.mu)),
                                ts.params))
        self.ring = ts.buffer   # the window's episodes write other copies
        self.ts = ts

    def call(self):
        reset, draws = self._draws()
        self.ts, m = self.trainer.train_episode(self.ts, draws, reset)
        return int(m.episode_length) * self.params['num_envs'], None

    def release(self) -> None:
        """Frees the program's state; keeps what the check reads: the
        program's results in the reference's form."""
        self.program = (
            [{'loss': float(m.mean_loss), 'reward': float(m.mean_reward),
              'length': int(m.episode_length), 'updates': m.updates}
             for _, _, m in self.followed], self.states,
            {k: getattr(self.ring, k)[:self.ring.capacity] for k in RING}
            | {'ptr': int(self.ring.ptr), 'size': int(self.ring.size)})
        del self.trainer, self.ts, self.ring
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, fault=None):
        """The reference over set-up's episodes: (per-episode results,
        (Adam's first moment, parameters) after each, the ring after the
        last)."""
        with nets.tf32(tf32):
            t = self.config['train']
            env = Engine(game_from_config(self.config['env']), self.device)
            adam = nets.Adam(self.p0, t['lr'], t['adam_eps'],
                             t['max_grad_norm'])
            e = self.config['env']
            ring = Ring(t['buffer_size'], 8 * e['height'] * e['width'],
                        self.device)
            eps = torch.tensor(t['epsilon_start'], dtype=torch.float32,
                               device=self.device)
            p, out, states = self.p0, [], []
            for reset, draws, _ in self.followed:
                p, info = dqn_episode(env, t, p, self.p0, adam, ring,
                                      eps, tuple(reset), tuple(draws)[:4],
                                      fault)
                out.append(info)
                states.append((dict(adam.mu), p))
                eps = torch.clamp(eps * t['epsilon_decay'],
                                  min=t['epsilon_end'])
            return out, states, {k: getattr(ring, k) for k in RING} | {
                'ptr': ring.ptr, 'size': ring.size}

    def numbers(self, prog, ref) -> dict:
        """The numbers compared, ``prog`` against ``ref``, each (per-episode
        results, (Adam's first moment, parameters) after each episode, the
        ring after the last)."""
        (p_eps, p_st, p_ring), (r_eps, r_st, r_ring) = prog, ref
        keep = compare.moving_leaves(compare.norms(r_st[0][0]))

        def change(params):
            return {k: params[k] - self.p0[k] for k in self.p0}

        def loss(a, b):
            return compare.rel_gap(a['loss'], b['loss'], 1e-12)
        return {
            'loss_gap': max(loss(a, b) for a, b in zip(p_eps[:-1],
                                                       r_eps[:-1])),
            'reward_gap': max(compare.rel_gap(a['reward'], b['reward'], 1e-3)
                              for a, b in zip(p_eps, r_eps)),
            'count_gap': sum(abs(a[k] - b[k]) for a, b in zip(p_eps, r_eps)
                             for k in ('length', 'updates')),
            'grad_gap': compare.leaf_gap(p_st[0][0], r_st[0][0], keep),
            'update_gap': compare.leaf_gap(change(p_st[1][1]),
                                           change(r_st[1][1]), keep),
            'prefix_loss_gap': loss(p_eps[-1], r_eps[-1]),
            'prefix_update_gap': compare.leaf_gap(change(p_st[-1][1]),
                                                  change(r_st[-1][1]), keep),
            'ring_mismatches': sum(compare.mismatches(p_ring[k], r_ring[k])
                                   for k in r_ring),
        }

    def controls(self) -> dict:
        """The control (the reference in TF32 in the program's place) and
        the fault of half of each batch left out, against the
        reference."""
        ref = self.reference()
        return {'control': self.numbers(self.reference(tf32=True), ref),
                'half_batch': self.numbers(
                    self.reference(fault='half_batch'), ref)}

    def compared(self) -> dict:
        """The program's numbers against the reference's."""
        return self.numbers(self.program, self.reference())
