"""Rollout traffic: many envs stepped with uniform random actions,
``VectorSnakeEnv.step`` (the step with auto-reset, K1) replayed as one
captured graph of ``steps`` steps through ``CapturedLoop``.

Set-up builds the env, resets it from the seed's draws, and runs the
first call, which captures the graph. A call draws the next ``steps``
steps' actions and step draws on the device from the seed's generator
into the graph's buffers, then replays it; the graph leaves the last
state and step output in its buffers, from which the next call goes on.
Nothing reduces the obs inside the loop. A unit of work is an env-step.

The check: the first ``followed_calls`` calls are followed by the
reference from the very start, the reference resetting the envs itself
from the same draws and going on from its own state; ``sampled_calls``
calls drawn from the seed among the next ones up to call
``sampled_from`` are compared from the state the program had before them
(the reference cannot follow the program's hundreds of calls in the time
of a run). Each compared call's last state and step output (obs,
rewards, dones, ranks, episodic stats) must equal the reference's,
element for element.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from marlsnake_torch.envs.vector import VectorSnakeEnv, build_vector_fns
from marlsnake_torch.ops.step_kernel import StaticEnvs
from marlsnake_torch.rng import ResetDraws, StepDraws
from marlsnake_torch.utils.cuda_graph import CapturedLoop
from perfbench import compare
from perfbench.port import env_config
from perfbench.reference import engine as ref_engine


def as_reference(obj, cls):
    """The program's state or step output as the reference's dataclass
    (its fields by name; the reference has no frame history)."""
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


class Driver:
    work = 'rollout_env_steps'
    profile_calls = 4

    def __init__(self, config: dict, params: dict, seed: int, device):
        self.config, self.params, self.seed = config, params, seed
        self.device = torch.device(device)
        self.cfg = env_config(config)
        rng = np.random.default_rng(seed)
        followed = params['followed_calls']
        picks = rng.choice(np.arange(followed, params['sampled_from'] + 1),
                           params['sampled_calls'], replace=False)
        self.picked = {*range(followed), *(int(i) for i in picks)}

    def setup(self) -> None:
        p, dev, cfg = self.params, self.device, self.cfg
        envs, steps, n = p['num_envs'], p['steps'], cfg.num_snakes
        self.env = VectorSnakeEnv(cfg, envs, device=dev)
        reset_fn, _ = build_vector_fns(cfg, autoreset=True, device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed)
        self.reset = ResetDraws(
            torch.rand((envs,), generator=self.gen, device=dev),
            torch.rand((envs, cfg.resolved_num_fruits), generator=self.gen,
                       device=dev))
        states, _ = reset_fn(self.reset)
        self.envs = StaticEnvs(cfg, envs, dev)
        self.envs.load(states)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.actions = z(steps, envs, n, dtype=torch.int32)
        self.draws = StepDraws(z(steps, envs, n), z(steps, envs),
                               z(steps, envs, cfg.resolved_num_fruits))
        self.loop = CapturedLoop(self._body, dev)
        self.calls = 0
        self.seen = {}   # call -> (state before, actions, draws, result)
        self.call()

    def _body(self) -> None:
        states, out = self.envs.state, None
        for t in range(self.actions.shape[0]):
            states, out = self.env.step(
                states, self.actions[t], StepDraws(*(x[t] for x in
                                                     self.draws)))
        self.envs.store(states, out)

    def call(self):
        g = self.gen
        torch.randint(0, self.cfg.num_actions, self.actions.shape,
                      generator=g, device=self.device, dtype=torch.int32,
                      out=self.actions)
        for x in self.draws:
            torch.rand(x.shape, generator=g, device=self.device, out=x)
        keep = self.calls in self.picked
        if keep:
            before = self.envs.clone()[0]
            inputs = (self.actions.clone(),
                      StepDraws(*(x.clone() for x in self.draws)))
        self.loop()
        if keep:
            self.seen[self.calls] = (before, *inputs, self.envs.clone())
        self.calls += 1
        return self.params['num_envs'] * self.params['steps'], None

    def release(self) -> None:
        del self.loop, self.envs, self.env
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def replay(self, engine, before, actions, draws):
        """The reference over one call's steps from ``before``."""
        s, out = before, None
        for t in range(actions.shape[0]):
            s, out = engine.step_autoreset(s, actions[t], *(x[t] for x
                                                            in draws))
        return s, out

    def numbers(self, low_precision: bool = False) -> dict:
        """Elements of the compared calls' results that differ from the
        reference's (the reference's picks in bfloat16 as the control)."""
        eng = ref_engine.Engine(ref_engine.game_from_config(self.config['env']),
                                self.device, low_precision)
        bad, s = 0, None
        for call, (before, actions, draws, (state, out)) in sorted(
                self.seen.items()):
            if call == 0:
                start, _ = eng.reset(*self.reset)
                bad += sum(compare.mismatches(getattr(before, k), v)
                           for k, v in ref_engine.fields(start).items())
            elif call < self.params['followed_calls']:
                start = s   # the reference's own state after the call before
            else:
                start = as_reference(before, ref_engine.State)
            s, o = self.replay(eng, start, actions, draws)
            bad += sum(compare.mismatches(getattr(state, k), v)
                       for k, v in ref_engine.fields(s).items())
            bad += sum(compare.mismatches(getattr(out, k), v)
                       for k, v in ref_engine.fields(o).items())
        return {'mismatches': bad}

    def controls(self) -> dict:
        """The control: the reference with its float32 picks of fruit and
        spawn cells in bfloat16, in the program's place."""
        return {'control': self.numbers(low_precision=True)}

    def compared(self) -> dict:
        """The program's numbers against the reference's."""
        return self.numbers()
