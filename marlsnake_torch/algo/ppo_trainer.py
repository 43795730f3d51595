"""Parameter-shared multi-agent PPO trainer on one device.

The port of the JAX package's ``algo/ppo_trainer.py``, with its algorithm
and defaults: every snake is an agent of one shared ActorCritic; an update
collects ``rollout_steps`` steps of ``num_envs`` auto-resetting envs,
computes GAE, and runs ``update_epochs`` epochs of ``num_minibatches``
clipped-surrogate minibatches (value loss, entropy bonus, gradient clipped
to a global norm of ``max_grad_norm``, Adam with eps 1e-5). Transitions of
agents that were already dead at the step's start are masked out of every
loss. Scalars: ``loss/actor``, ``loss/value``, ``policy/entropy``,
``policy/approx_kl``, ``env/mean_reward_per_step_per_agent``,
``env/mean_episode_return``, ``env/episodes_collected``.

Where the JAX package runs the rollout as one ``lax.scan`` program, this
runs it as one captured CUDA graph (``utils/cuda_graph.py``; on the CPU
the same body runs directly): ``rollout_steps`` steps with no read-back,
each one forward of the (E * N) agents, the action sample
``argmax(logits + gumbel)``, and one launch of the CUDA step kernel's
auto-reset entry (``ops/step_kernel.py``; the plain engine on the CPU),
then the last value and GAE. ``collect`` copies the state and the draws
into the graph's buffers and hands back copies of what it carries;
``collect_plain`` runs the same body uncaptured. The rollout goes
into buffers the trainer allocates once (``trainer.trajectory``: obs as
(T, E * N, H * W * C) bytes, packed bytes under ``obs_format='packed'``),
which the next update overwrites. The minibatch epochs are plain torch:
autograd on the forward, ``algo/optim.py`` for the clip and Adam.

The shared net is the one ``PPOConfig.net`` names in
``models/policy.py``'s table, which says what a net gives the trainer:
the ActorCritic, or an LLM agent (``models/moonlight.py``:
Moonlight-16B-A3B's decoder over a prompt of the packed board, its
action logits the ``lm_head`` rows of the three actions, a value head),
on the same path: the rollout in the same graph, the same GAE,
minibatches, clip and Adam. The net turns the rollout's obs into its
input (``ingress``) and gives its initial state (``initial_state``). The
state's buffers (the agent's routers' correction biases) ride in
``PPOTrainState.buffers`` and take the net's step (``step_buffers``: for
the agent, the bias step of aux-loss-free balancing) after each
optimizer step. With ``in_place`` (for either net) ``learn`` writes the
new parameters and Adam's moments into the state it is given
(``_apply_in_place``): at its published widths the agent's float32
parameters and moments fit one card once, not twice.

Random numbers: the trainer owns one ``torch.Generator`` on its device;
``update`` draws an update's numbers from it up front (``rng.ppo_draws``)
unless the caller hands them in. Left out against the JAX trainer: the
fallback that loads checkpoints saved before the optimizer state.

Data parallelism (``mesh``, the JAX trainer's ``axis_name`` branch; see
``parallel/ppo_dp.py``): each rank rolls out its own envs with its own
generator (``rng.rank_seed``), so its Gumbel noise and its minibatch
permutations are its own, over its own rows. Each minibatch all-reduces
its gradients and its four loss terms as one flat buffer and divides it
by the world size (JAX's ``pmean``). At the end the reward and valid-step
sums, the finished-episode return sum and count and the episodes the
rollout ended are summed over the ranks (the counts as int64, exactly).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import torch

from marlsnake_torch.algo import optim
from marlsnake_torch.algo.optim import mean_of
from marlsnake_torch.core.state import EnvState
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.device import resolve_device
from marlsnake_torch.envs.vector import build_vector_fns
from marlsnake_torch.models.moonlight import MoonlightConfig
from marlsnake_torch.models.policy import make_policy
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.rng import (PPODraws, ResetDraws, StepDraws,
                                 ppo_draws, rank_seed, reset_draws)
from marlsnake_torch.utils import checkpoint as ckpt
from marlsnake_torch.utils.cuda_graph import (CapturedLoop, clone_tree,
                                              copy_into)
from marlsnake_torch.utils.metrics import MetricWriter
from marlsnake_torch.utils.profiling import tracer

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class PPOConfig:
    """Field names and defaults are the JAX ``PPOConfig``'s, but for
    ``net`` and ``moonlight``, the port's own."""
    # environment
    num_snakes: int = 4
    height: int = 20
    width: int = 20
    snake_length: int = 5
    vision_range: Optional[int] = None
    frame_stack: int = 1
    reward_dict: Any = dataclasses.field(default_factory=lambda: {
        'fruit': 1.0, 'kill': 0.0, 'lose': 0.0, 'win': 0.0, 'time': 0.0})
    # rollout
    num_envs: int = 64
    rollout_steps: int = 128
    # optimization
    lr: float = 2.5e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    update_epochs: int = 4
    num_minibatches: int = 4
    num_updates: int = 100
    # bookkeeping
    log_dir: str = 'runs/ppo'
    save_dir: str = 'checkpoints_ppo'
    # write a 'final' checkpoint into save_dir when train() completes
    save_final: bool = True
    # resume from a checkpoint tag: parameters, optimizer state and the
    # update counter come back, and training goes on from there
    resume_from: Optional[str] = None
    seed: int = 0
    # float32 parameters; torch.bfloat16 runs the convolutions and
    # products in bfloat16 (models/ppo.py)
    compute_dtype: torch.dtype = torch.float32
    # The engine's obs are one-hot {0, 1} planes: skipping the
    # conditional /255's whole-batch max gives the same activations
    assume_binary_obs: bool = True
    # 'packed': the envs emit one byte a cell a frame, the rollout
    # buffer holds those bytes, and they are unpacked where they enter
    # the ActorCritic
    obs_format: str = 'uint8'
    # the shared net, by its name in models/policy.NETS: the ActorCritic
    # (models/ppo.py), or the LLM agent of models/moonlight.py, which
    # reads the packed board as a prompt, with the decoder settings of
    # ``moonlight``
    net: str = 'actor_critic'
    moonlight: MoonlightConfig = dataclasses.field(
        default_factory=MoonlightConfig)
    # the optimizer step writes the parameters and moments it is given,
    # a leaf at a time, letting go of each gradient once used; the same
    # numbers as the functional step, which keeps the old state
    in_place: bool = False

    def env_config(self) -> EnvConfig:
        return EnvConfig.from_reward_dict(
            self.reward_dict, height=self.height, width=self.width,
            num_snakes=self.num_snakes, snake_length=self.snake_length,
            vision_range=self.vision_range, frame_stack=self.frame_stack,
            obs_format=self.obs_format)


@dataclasses.dataclass
class PPOTrainState:
    """What training carries from update to update, on the device but the
    update counter. The JAX state's ``key`` has no field here: the
    trainer's generator takes its place."""
    params: Params                 # the ActorCritic's state_dict layout
    opt_state: optim.AdamState     # moments in the order of ``params``
    env_states: EnvState
    obs: torch.Tensor              # (E, N, H, W, C)
    agent_done: torch.Tensor       # (E, N) bool: dead in this episode
    update: int
    episodes: torch.Tensor         # () int32: episodes completed so far
    ep_return_acc: torch.Tensor    # (E, N) float32: running returns
    finished_return_sum: torch.Tensor  # () float32
    finished_count: torch.Tensor       # () int32
    # the net's state that no gradient moves (the agent's MoE routers'
    # correction biases; empty for the ActorCritic)
    buffers: Params = dataclasses.field(default_factory=dict)

    def replace(self, **changes) -> 'PPOTrainState':
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class PPOMetrics:
    loss_actor: torch.Tensor
    loss_value: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    mean_reward_per_step_per_agent: torch.Tensor
    mean_episode_return: torch.Tensor
    episodes_collected: torch.Tensor


@dataclasses.dataclass
class Trajectory:
    """One rollout, step axis first; the trainer's own buffers."""
    obs: torch.Tensor         # (T, E * N, H * W * C) uint8: obs the step saw
    action: torch.Tensor      # (T, E, N) int32 (0 for dead agents)
    logprob: torch.Tensor     # (T, E, N) float32 of the sampled action
    value: torch.Tensor       # (T, E, N) float32
    reward: torch.Tensor      # (T, E, N) float32, 0 where not valid
    valid: torch.Tensor       # (T, E, N) bool: alive at the step's start
    next_done: torch.Tensor   # (T, E, N) bool: done, or the episode ended
    advantages: torch.Tensor  # (T, E, N) float32 (GAE)
    returns: torch.Tensor     # (T, E, N) float32
    ended: torch.Tensor       # () int32: episodes the rollout ended


class Minibatch(NamedTuple):
    obs: torch.Tensor       # (M, H * W * C) uint8
    action: torch.Tensor    # (M,) int32
    logprob: torch.Tensor   # (M,) float32: at collection
    adv: torch.Tensor
    ret: torch.Tensor
    valid: torch.Tensor     # (M,) bool


@dataclasses.dataclass
class _RolloutBuffers:
    """What ``collect``'s graph reads and carries, at fixed addresses."""
    envs: step_kernel.StaticEnvs
    obs: torch.Tensor
    agent_done: torch.Tensor
    ep_return_acc: torch.Tensor
    finished_return_sum: torch.Tensor
    finished_count: torch.Tensor
    episodes: torch.Tensor
    params: Params
    buffers: Params
    step: StepDraws            # step axis first
    gumbel: torch.Tensor


class PPOTrainer:
    """Single-device trainer. ``device`` defaults to the GPU; pass
    ``'cpu'`` to run the plain PyTorch path. With ``mesh``
    (``parallel.mesh.Mesh``) it is one rank of a data-parallel run on the
    mesh's device, ``num_envs`` being this rank's envs."""

    def __init__(self, config: PPOConfig, device='cuda', mesh=None):
        self.config = config
        self.mesh = mesh
        # called as on_grads(params, grads) before each optimizer step
        self.on_grads: Optional[Callable[[Params, List[torch.Tensor]],
                                         None]] = None
        if mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.env_cfg = config.env_config()
        # the net is applied to parameters handed in (PPOTrainState.params);
        # init_state starts from its initial_state()
        self.net = make_policy(config, self.env_cfg, self.device)
        self.net.requires_grad_(False)
        # the state's tensors that no gradient moves, and their step
        self._held = (self.net.state_dict().keys()
                      - dict(self.net.named_parameters()).keys())
        if self._held and mesh is not None:
            raise ValueError(f'the net {config.net!r} trains on one device: '
                             'its buffers are not all-reduced')
        self._step_buffers = self.net.step_buffers if self._held else None
        self._ingress = self.net.ingress
        self._reset_env, self._step_env = build_vector_fns(
            self.env_cfg, autoreset=True, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed + 1 if mesh is None
                                   else rank_seed(config.seed, mesh.rank))
        t, e, n = config.rollout_steps, config.num_envs, config.num_snakes
        _, h, w, c = self.env_cfg.obs_shape

        def buf(dtype, shape=(t, e, n)):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        f32, b8 = torch.float32, torch.bool
        self.trajectory = Trajectory(
            obs=buf(torch.uint8, (t, e * n, h * w * c)),
            action=buf(torch.int32), logprob=buf(f32), value=buf(f32),
            reward=buf(f32), valid=buf(b8), next_done=buf(b8),
            advantages=buf(f32), returns=buf(f32),
            ended=buf(torch.int32, ()))
        self._rollout: Optional[Tuple[_RolloutBuffers, CapturedLoop]] = None

    # ------------------------------------------------------------------
    def init_state(self, reset: Optional[ResetDraws] = None
                   ) -> PPOTrainState:
        """The net's parameters, cold Adam moments, and ``num_envs`` envs
        reset with ``reset``, by default drawn from the trainer's
        generator."""
        cfg, dev = self.config, self.device
        e, n = cfg.num_envs, cfg.num_snakes
        state = self.net.initial_state()
        params = {k: v for k, v in state.items() if k not in self._held}
        if reset is None:
            reset = reset_draws(self.env_cfg, e, self.generator, dev)
        env_states, obs = self._reset_env(reset)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return PPOTrainState(
            params=params, opt_state=optim.adam_init(list(params.values())),
            env_states=env_states, obs=obs,
            agent_done=zeros((e, n), torch.bool), update=0,
            episodes=zeros((), torch.int32),
            ep_return_acc=zeros((e, n), torch.float32),
            finished_return_sum=zeros((), torch.float32),
            finished_count=zeros((), torch.int32),
            buffers={k: v for k, v in state.items() if k in self._held})

    # ------------------------------------------------------------------
    def _forward(self, params: Params, flat_obs: torch.Tensor,
                 buffers: Optional[Params] = None, phases: bool = False):
        """(logits (M, A), value (M,)) of per-agent obs rows (M, H, W, C)
        through the net's ``ingress``; ``phases``: the net's marks and
        counts (the agent's, ``models/moonlight.py``)."""
        return torch.func.functional_call(
            self.net, (params, buffers or {}),
            (self._ingress(flat_obs), phases))

    def _policy(self, params: Params, obs: torch.Tensor,
                buffers: Optional[Params] = None):
        """(logits (E, N, A), value (E, N)) of obs (E, N, H, W, C), with
        the net's phases."""
        e, n = obs.shape[:2]
        logits, value = self._forward(
            params, obs.reshape((e * n,) + obs.shape[2:]), buffers, True)
        return logits.reshape(e, n, -1), value.reshape(e, n)

    # ------------------------------------------------------------------
    def collect(self, ts: PPOTrainState, draws: PPODraws) -> PPOTrainState:
        """``rollout_steps`` steps under ``ts.params`` into
        ``self.trajectory``, then its advantages and returns, as one replay
        of the rollout's CUDA graph (on the CPU, the body run directly).
        Returns ``ts`` with the envs, obs, done flags and episode
        accumulators where the rollout left them."""
        return self._collect(ts, draws, captured=True)

    def collect_plain(self, ts: PPOTrainState, draws: PPODraws
                      ) -> PPOTrainState:
        """``collect`` with its body run uncaptured (the graph's plain
        version; the same buffers and the same body)."""
        return self._collect(ts, draws, captured=False)

    def rollout_loop(self) -> Tuple[_RolloutBuffers, CapturedLoop]:
        """The rollout's buffers and its ``CapturedLoop``, made on first
        use."""
        if self._rollout is None:
            cfg, dev = self.config, self.device
            e, n, t = cfg.num_envs, cfg.num_snakes, cfg.rollout_steps
            like = self.init_state(reset_draws(
                self.env_cfg, e, torch.Generator(device=dev).manual_seed(0),
                dev))
            draws = ppo_draws(self.env_cfg, e, t, 1,
                              torch.Generator(device=dev).manual_seed(0), dev)
            bufs = _RolloutBuffers(
                envs=step_kernel.StaticEnvs(self.env_cfg, e, dev),
                obs=like.obs, agent_done=like.agent_done,
                ep_return_acc=like.ep_return_acc,
                finished_return_sum=like.finished_return_sum,
                finished_count=like.finished_count, episodes=like.episodes,
                params=like.params, buffers=like.buffers, step=draws.step,
                gumbel=draws.gumbel)
            self._rollout = (bufs, CapturedLoop(
                lambda: self._rollout_body(bufs), dev))
        return self._rollout

    @torch.no_grad()
    def _collect(self, ts: PPOTrainState, draws: PPODraws, captured: bool
                 ) -> PPOTrainState:
        """The rollout: copy-in, the graph, the clones, as the tracer's
        span ``ppo.collect``, bounded by marks (the graph holds none)."""
        with tracer.span('ppo.collect', device=True):
            b, loop = self.rollout_loop()
            b.envs.load(ts.env_states)
            for name in ('obs', 'agent_done', 'ep_return_acc',
                         'finished_return_sum', 'finished_count', 'episodes',
                         'params', 'buffers'):
                copy_into(getattr(b, name), getattr(ts, name))
            copy_into(b.step, draws.step)
            b.gumbel.copy_(draws.gumbel)
            (loop if captured else loop.uncaptured)()
            return ts.replace(env_states=b.envs.clone()[0], **{
                name: clone_tree(getattr(b, name)) for name in (
                    'obs', 'agent_done', 'ep_return_acc',
                    'finished_return_sum', 'finished_count', 'episodes')})

    def _rollout_body(self, b: _RolloutBuffers) -> None:
        """The rollout over the buffers ``b``: the steps, the last value
        and GAE, with no read-back (the body of JAX's rollout scan)."""
        cfg, traj = self.config, self.trajectory
        e, n = cfg.num_envs, cfg.num_snakes
        env_states, obs, agent_done = b.envs.state, b.obs, b.agent_done
        ep_acc, fin_sum = b.ep_return_acc, b.finished_return_sum
        fin_cnt, episodes = b.finished_count, b.episodes
        for t in range(cfg.rollout_steps):
            logits, value = self._policy(b.params, obs, b.buffers)
            action = (logits + b.gumbel[t]).argmax(-1)
            logprob = torch.log_softmax(logits, -1).gather(
                -1, action[..., None])[..., 0]
            action = action.to(torch.int32).masked_fill_(agent_done, 0)
            env_states, out = self._step_env(
                env_states, action, StepDraws(*(x[t] for x in b.step)))
            valid = ~agent_done
            rew = torch.where(valid, out.reward, 0.0)
            ep_acc = ep_acc + rew
            ep_done = out.done_all                        # (E,)
            fin_sum = fin_sum + torch.where(ep_done, mean_of(ep_acc, -1),
                                            0.0).sum()
            ended = ep_done.sum(dtype=torch.int32)
            fin_cnt = fin_cnt + ended
            episodes = episodes + ended
            ep_acc = ep_acc.masked_fill(ep_done[:, None], 0.0)

            traj.obs[t].copy_(obs.reshape(e * n, -1))
            traj.action[t] = action
            traj.logprob[t] = logprob
            traj.value[t] = value
            traj.reward[t] = rew
            traj.valid[t] = valid
            torch.logical_or(out.done, ep_done[:, None],
                             out=traj.next_done[t])
            # auto-reset clears the per-agent done at an episode's end
            agent_done = out.done & ~ep_done[:, None]
            obs = out.obs
        traj.ended.copy_(episodes - b.episodes)
        _, last_value = self._policy(b.params, obs, b.buffers)
        self._gae(last_value)
        b.envs.store(env_states)
        for dst, src in ((b.obs, obs), (b.agent_done, agent_done),
                         (b.ep_return_acc, ep_acc),
                         (b.finished_return_sum, fin_sum),
                         (b.finished_count, fin_cnt),
                         (b.episodes, episodes)):
            dst.copy_(src)

    def _gae(self, last_value: torch.Tensor) -> None:
        """GAE over ``self.trajectory`` into its ``advantages`` and
        ``returns``, bootstrapped from ``last_value`` (E, N), the value of
        the obs after the last step; a step whose agent is done or whose
        episode ended cuts the bootstrap. Each step's terms are those of
        the JAX trainer's reverse scan (``addcmul`` may fuse the last
        multiply and add)."""
        cfg, traj = self.config, self.trajectory
        nonterminal = 1.0 - traj.next_done.to(torch.float32)
        next_value = torch.cat([traj.value[1:], last_value[None]])
        delta = (traj.reward + cfg.gamma * next_value * nonterminal
                 - traj.value)
        decay = cfg.gamma * cfg.gae_lambda * nonterminal
        gae = torch.zeros_like(last_value)
        for t in reversed(range(cfg.rollout_steps)):
            gae = torch.addcmul(delta[t], decay[t], gae,
                                out=traj.advantages[t])
        torch.add(traj.advantages, traj.value, out=traj.returns)

    # ------------------------------------------------------------------
    def _loss(self, params: Params, mb: Minibatch,
              buffers: Optional[Params] = None):
        """(total loss, (actor, value, entropy, approx_kl)) of one
        minibatch, in the JAX trainer's formula order; the advantages are
        normalised over the minibatch's valid rows."""
        cfg = self.config
        obs = mb.obs.reshape((mb.obs.shape[0],) + self.env_cfg.obs_shape[1:])
        logits, value = self._forward(params, obs, buffers)
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, mb.action.long()[:, None])[:, 0]
        v = mb.valid.to(torch.float32)
        vsum = v.sum().clamp_min(1.0)
        ratio = torch.exp(logp - mb.logprob)
        adv = mb.adv
        mean = (adv * v).sum() / vsum
        adv = (adv - mean) / (
            torch.sqrt(((adv - mean) ** 2 * v).sum() / vsum) + 1e-8)
        pg1 = -adv * ratio
        pg2 = -adv * torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
        loss_actor = (torch.maximum(pg1, pg2) * v).sum() / vsum
        loss_value = (0.5 * (value - mb.ret) ** 2 * v).sum() / vsum
        ent = (-(torch.exp(logp_all) * logp_all).sum(-1) * v).sum() / vsum
        kl = ((mb.logprob - logp) * v).sum() / vsum
        total = loss_actor + cfg.vf_coef * loss_value - cfg.ent_coef * ent
        return total, torch.stack([loss_actor, loss_value, ent, kl])

    def loss_and_grads(self, params: Params, mb: Minibatch,
                       buffers: Optional[Params] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  List[torch.Tensor]]:
        """(total loss, its (actor, value, entropy, approx_kl) terms,
        gradients of the total in the order of ``params``)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            total, aux = self._loss(leaves, mb, buffers)
            grads = torch.autograd.grad(total, list(leaves.values()))
        return total.detach(), aux.detach(), list(grads)

    def apply_gradients(self, params: Params, opt_state: optim.AdamState,
                        grads) -> Tuple[Params, optim.AdamState]:
        """Clip to the global norm ``max_grad_norm``, then one Adam step
        (eps 1e-5) at ``lr``; with ``in_place``, made into the state given
        (``_apply_in_place``)."""
        cfg = self.config
        if cfg.in_place:
            return self._apply_in_place(params, opt_state, grads)
        grads = optim.clip_by_global_norm(grads, cfg.max_grad_norm)
        updates, opt_state = optim.adam_update(grads, opt_state, cfg.lr,
                                               eps=1e-5)
        new = optim.apply_updates(list(params.values()), updates)
        return dict(zip(params, new)), opt_state

    def _apply_in_place(self, params: Params, opt_state: optim.AdamState,
                        grads: List[torch.Tensor]
                        ) -> Tuple[Params, optim.AdamState]:
        """``apply_gradients``'s arithmetic, written into the parameters
        and moments handed in, one parameter at a time, each gradient
        let go of (``grads`` emptied) once used: a 1.4 B-parameter learner
        has room on one card for one copy of its float32 state and its
        gradients, not for the two or three that a functional step makes
        (``PERF.md``). So ``learn`` changes the state it is given."""
        cfg = self.config
        norm = optim.global_norm(grads)
        for i, p in enumerate(params.values()):
            g = optim.clip_by_global_norm([grads[i]], cfg.max_grad_norm, norm)
            grads[i] = None
            (update,), st = optim.adam_update(
                g, optim.AdamState(opt_state.count, [opt_state.mu[i]],
                                   [opt_state.nu[i]]), cfg.lr, eps=1e-5)
            p.add_(update)
            opt_state.mu[i].copy_(st.mu[0])
            opt_state.nu[i].copy_(st.nu[0])
        grads.clear()
        opt_state.count.add_(1)
        return params, opt_state

    def minibatches(self, perm: torch.Tensor):
        """The minibatches of one epoch of ``self.trajectory``, in order:
        rows ``perm[:mb * num_minibatches]`` cut into ``num_minibatches``
        runs of ``mb = T * E * N // num_minibatches``."""
        traj, nm = self.trajectory, self.config.num_minibatches
        rows = perm.numel()
        flat = Minibatch(traj.obs.reshape(rows, -1), traj.action.reshape(rows),
                         traj.logprob.reshape(rows),
                         traj.advantages.reshape(rows),
                         traj.returns.reshape(rows), traj.valid.reshape(rows))
        mb = rows // nm
        for idx in perm[:mb * nm].view(nm, mb):
            yield Minibatch(*(x[idx] for x in flat))

    def learn(self, ts: PPOTrainState, perm: torch.Tensor
              ) -> Tuple[PPOTrainState, PPOMetrics]:
        """The minibatch epochs over ``self.trajectory`` from ``ts``, which
        ``collect`` returned, one row of ``perm`` an epoch, and the
        update's metrics: the losses' mean over every minibatch, the
        reward and episodes of the rollout. The tracer's span
        ``ppo.learn``, bounded by marks, and in it each minibatch's marks:
        the ends of ``ppo.gather`` (its rows), ``ppo.fwd_bwd``
        (``loss_and_grads``) and ``ppo.optim`` (``apply_gradients``, and
        where the state has buffers the net's ``step_buffers``: for the
        agent the routers' bias step over the minibatch's expert loads).
        ``on_grads``, where set, is called with each minibatch's
        parameters and the gradient the step takes, before the step."""
        with tracer.span('ppo.learn', device=True):
            return self._learn(ts, perm)

    def _learn(self, ts: PPOTrainState, perm: torch.Tensor
               ) -> Tuple[PPOTrainState, PPOMetrics]:
        params, opt_state, auxs = ts.params, ts.opt_state, []
        buffers = ts.buffers
        for epoch_perm in perm:
            for mb in self.minibatches(epoch_perm):
                tracer.mark('ppo.gather')
                _, aux, grads = self.loss_and_grads(params, mb, buffers)
                if self.mesh is not None:
                    *grads, aux = self.mesh.mean(grads + [aux])
                if self.on_grads is not None:
                    self.on_grads(params, grads)
                tracer.mark('ppo.fwd_bwd')
                params, opt_state = self.apply_gradients(params, opt_state,
                                                         grads)
                if buffers:
                    buffers = self._step_buffers(buffers)
                auxs.append(aux)
                tracer.mark('ppo.optim')
        aux = mean_of(torch.stack(auxs), 0)
        traj = self.trajectory
        rew_sum = (traj.reward * traj.valid).sum()
        valid_sum = traj.valid.sum(dtype=torch.int32)
        fin_sum, fin_cnt = ts.finished_return_sum, ts.finished_count
        episodes = ts.episodes
        if self.mesh is not None:
            sums = self.mesh.all_reduce(torch.stack([rew_sum, fin_sum]))
            counts = self.mesh.all_reduce(torch.stack(
                [valid_sum, fin_cnt, traj.ended]).to(torch.int64))
            rew_sum, fin_sum = sums
            valid_sum, fin_cnt, ended = counts.to(torch.int32)
            episodes = episodes - traj.ended + ended
        metrics = PPOMetrics(
            loss_actor=aux[0], loss_value=aux[1], entropy=aux[2],
            approx_kl=aux[3],
            mean_reward_per_step_per_agent=rew_sum / valid_sum.clamp_min(1),
            mean_episode_return=torch.where(
                fin_cnt > 0, fin_sum / fin_cnt.clamp_min(1), 0.0),
            episodes_collected=fin_cnt)
        ts = ts.replace(params=params, opt_state=opt_state, buffers=buffers,
                        update=ts.update + 1, episodes=episodes,
                        finished_return_sum=torch.zeros_like(fin_sum),
                        finished_count=torch.zeros_like(fin_cnt))
        return ts, metrics

    def update(self, ts: PPOTrainState, draws: Optional[PPODraws] = None
               ) -> Tuple[PPOTrainState, PPOMetrics]:
        """One PPO update: ``collect`` (rollout and GAE), then ``learn``
        (minibatch epochs and metrics). ``draws`` default to numbers from
        the trainer's generator."""
        cfg = self.config
        with tracer.span('ppo.update'):
            if draws is None:
                draws = ppo_draws(self.env_cfg, cfg.num_envs,
                                  cfg.rollout_steps, cfg.update_epochs,
                                  self.generator, self.device)
            return self.learn(self.collect(ts, draws), draws.perm)

    # ------------------------------------------------------------------
    def train(self, num_updates: Optional[int] = None,
              log: bool = True) -> PPOTrainState:
        cfg = self.config
        num_updates = num_updates or cfg.num_updates
        ts = self.init_state()
        start_u = 1
        if cfg.resume_from:
            ts = self.load_checkpoint(cfg.resume_from, ts)
            start_u = ts.update + 1
        writer = None
        if log:
            from datetime import datetime
            writer = MetricWriter(os.path.join(
                cfg.log_dir, datetime.now().strftime('%Y%m%d-%H%M%S')))
        t0 = time.time()
        for u in range(start_u, num_updates + 1):
            ts, m = self.update(ts)
            if u % 5 == 0 or u == num_updates:
                scalars = {
                    'loss/actor': float(m.loss_actor),
                    'loss/value': float(m.loss_value),
                    'policy/entropy': float(m.entropy),
                    'policy/approx_kl': float(m.approx_kl),
                    'env/mean_reward_per_step_per_agent':
                        float(m.mean_reward_per_step_per_agent),
                    'env/mean_episode_return': float(m.mean_episode_return),
                    'env/episodes_collected': int(m.episodes_collected),
                }
                if writer:
                    writer.add_scalars(scalars, u)
                steps = (u - start_u + 1) * cfg.rollout_steps * cfg.num_envs
                print(f'update {u:4d} | return '
                      f'{scalars["env/mean_episode_return"]:8.4f} | '
                      f'entropy {scalars["policy/entropy"]:.3f} | '
                      f'kl {scalars["policy/approx_kl"]:.4f} | '
                      f'{steps / (time.time() - t0):,.0f} env-steps/s')
        if writer:
            writer.close()
        if cfg.save_final:
            self.save_checkpoint(ts, 'final')
        return ts

    # --- checkpoints ---------------------------------------------------
    def _ckpt_path(self, tag) -> str:
        return os.path.abspath(os.path.join(self.config.save_dir,
                                            f'ppo_{tag}'))

    def _payload(self, ts: PPOTrainState, full: bool) -> dict:
        # {params, opt_state, update}, the reference PPO checkpoint's
        # {model_state_dict, optimizer_state_dict, epoch}; full=True adds
        # every other field and the generator's state, so that a resumed
        # run repeats the uninterrupted one
        opt = ts.opt_state
        payload = {'params': ts.params,
                   'opt_state': {'count': opt.count, 'mu': opt.mu,
                                 'nu': opt.nu},
                   'update': ts.update}
        if ts.buffers:
            payload['buffers'] = ts.buffers
        if full:
            payload.update(
                env_states=dict(ts.env_states.fields()), obs=ts.obs,
                agent_done=ts.agent_done, episodes=ts.episodes,
                ep_return_acc=ts.ep_return_acc,
                finished_return_sum=ts.finished_return_sum,
                finished_count=ts.finished_count,
                generator=self.generator.get_state())
        return payload

    def save_checkpoint(self, ts: PPOTrainState, tag, full: bool = False):
        ckpt.save(self._ckpt_path(tag), self._payload(ts, full))

    def load_checkpoint(self, tag, ts: PPOTrainState,
                        full: bool = False) -> PPOTrainState:
        """``ts`` with what the checkpoint ``tag`` holds; with
        ``full=True`` every field, and the trainer's generator is set."""
        got = ckpt.restore(self._ckpt_path(tag), self._payload(ts, full))
        opt = got.pop('opt_state')
        got['opt_state'] = optim.AdamState(opt['count'], opt['mu'],
                                           opt['nu'])
        if full:
            got['env_states'] = EnvState(**got['env_states'])
            self.generator.set_state(got.pop('generator').cpu())
        return ts.replace(**got)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('--updates', type=int, default=100)
    p.add_argument('--num-envs', type=int, default=64)
    p.add_argument('--no-log', action='store_true')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    cfg = PPOConfig(num_updates=args.updates, num_envs=args.num_envs)
    PPOTrainer(cfg, device=args.device).train(log=not args.no_log)


if __name__ == '__main__':
    main()
