"""Top-level CLI of the port, the counterpart of the JAX package's
``cli.py`` and of the reference entry points (``train_dqn.py --mode
{train,eval,battle}``, train_dqn.py:963-1015, and ``train_ga.py``,
train_ga.py:506-509)::

    python -m marlsnake_torch.cli train       [--episodes N] [--num-envs E] ...
    python -m marlsnake_torch.cli train-ppo   [--updates N] ...
    python -m marlsnake_torch.cli eval        [--checkpoint TAG] ...
    python -m marlsnake_torch.cli battle      [--checkpoint TAG] [--batched]
    python -m marlsnake_torch.cli neat        [--generations N] ...
    python -m marlsnake_torch.cli es          [--generations N] ...
    python -m marlsnake_torch.cli demo        # random rollout + render

The subcommands, options and defaults are the JAX CLI's, with one more
option, ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
path). Checkpoints are the port's: ``train`` writes
``<save-dir>/shared_model_<tag>.pt``, which ``eval``, ``battle``,
``neat`` and ``es`` read; a tag that cannot be read leaves the DQN at its
random initial weights, with a warning, as in JAX. ``--ppo-checkpoint``
is a PPO checkpoint in the reference's torch layout, skipped when the
file is absent; ``--hybrid-pickle`` a hybrid NEAT checkpoint of either
package.
"""

from __future__ import annotations

import argparse
import os
import pickle
import random

# The reference's PPO opponent (train_dqn.py:986-991), as a path inside a
# checkout of the reference repository; the opponent is skipped when the
# file is absent.
REFERENCE_PPO_CHECKPOINT = 'marlenv/runs/ppo/20251228-155100/best_model.pt'


def _cap_seats(opponents: list, names: list, num_snakes: int):
    """Fit the opponent lineup to the ``num_snakes - 1`` available seats,
    reserving the last for Greedy (reference lineup, train_dqn.py:
    986-1003). Tail opponents that don't fit are dropped with a warning.
    Returns the truncated (opponents, names, seats)."""
    seats = num_snakes - 1
    if len(opponents) > seats - 1:
        for dropped in names[seats:]:
            print(f'warning: no seat for {dropped} '
                  f'(num_snakes={num_snakes}), dropping')
        opponents = opponents[:max(seats - 1, 0)]
        names = names[:1 + max(seats - 1, 0)]
    return opponents, names, seats


def _env_args(p: argparse.ArgumentParser):
    p.add_argument('--height', type=int, default=20)
    p.add_argument('--width', type=int, default=20)
    p.add_argument('--num-snakes', type=int, default=4)
    p.add_argument('--snake-length', type=int, default=5)
    p.add_argument('--vision-range', type=int, default=None)
    p.add_argument('--map', type=str, default=None,
                   help='bundled map name or path to an ASCII layout')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default) or 'cpu'")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog='marlsnake_torch')
    sub = p.add_subparsers(dest='mode', required=True)

    t = sub.add_parser('train', help='parameter-shared DQN training')
    _env_args(t)
    t.add_argument('--episodes', type=int, default=50_000)
    t.add_argument('--num-envs', type=int, default=1)
    t.add_argument('--resume', type=str, default=None)
    t.add_argument('--save-dir', type=str, default='checkpoints')
    t.add_argument('--log-dir', type=str, default='runs_dqn')
    t.add_argument('--no-log', action='store_true')

    tp = sub.add_parser('train-ppo', help='PPO training')
    _env_args(tp)
    tp.add_argument('--updates', type=int, default=1000)
    tp.add_argument('--num-envs', type=int, default=64)
    tp.add_argument('--rollout-steps', type=int, default=128)
    tp.add_argument('--no-log', action='store_true')

    e = sub.add_parser('eval', help='safety-masked evaluation')
    _env_args(e)
    e.add_argument('--checkpoint', type=str, default='final')
    e.add_argument('--save-dir', type=str, default='checkpoints')
    e.add_argument('--episodes', type=int, default=20)
    e.add_argument('--no-render', action='store_true')

    b = sub.add_parser('battle', help='masked DQN vs opponent lineup')
    _env_args(b)
    b.add_argument('--checkpoint', type=str, default='final')
    b.add_argument('--save-dir', type=str, default='checkpoints')
    b.add_argument('--episodes', type=int, default=10)
    b.add_argument('--no-render', action='store_true')
    b.add_argument('--batched', action='store_true',
                   help='run all episodes simultaneously on the device '
                        '(algo/battle_batch.py): wall time of one '
                        'episode, table with 95%% CIs; implies '
                        '--no-render')
    b.add_argument('--hybrid-pickle', type=str,
                   default='hybrid_neat_best.pkl')
    b.add_argument('--ppo-checkpoint', type=str,
                   default=REFERENCE_PPO_CHECKPOINT,
                   help='torch PPO checkpoint for the reference default '
                        'opponent (train_dqn.py:986-991); skipped when '
                        'the file is absent')

    g = sub.add_parser('neat', help='hybrid NEAT evolution over a frozen '
                                    'DQN feature extractor')
    _env_args(g)
    g.add_argument('--checkpoint', type=str, default='final')
    g.add_argument('--save-dir', type=str, default='checkpoints')
    g.add_argument('--generations', type=int, default=50)
    g.add_argument('--pop-size', type=int, default=100)
    g.add_argument('--fitness-episodes', type=int, default=4,
                   help='episodes per genome, common random numbers '
                        'across the population (1 = reference scale)')
    g.add_argument('--result-file', type=str,
                   default='hybrid_neat_best.pkl')

    e = sub.add_parser('es', help='antithetic weight-perturbation ES on '
                                  'the hybrid decision head (CRN-paired '
                                  'fitness, fixed-validation champion '
                                  'selection, fresh-holdout verdict)')
    _env_args(e)
    e.add_argument('--checkpoint', type=str, default='final')
    e.add_argument('--save-dir', type=str, default='checkpoints')
    e.add_argument('--generations', type=int, default=100)
    e.add_argument('--pop-size', type=int, default=256)
    e.add_argument('--sigma', type=float, default=0.03)
    e.add_argument('--lr', type=float, default=0.003)
    e.add_argument('--fitness-episodes', type=int, default=4)
    e.add_argument('--val-episodes', type=int, default=32)
    e.add_argument('--holdout-episodes', type=int, default=256)
    e.add_argument('--result-file', type=str,
                   default='hybrid_es_best.msgpack')

    d = sub.add_parser('demo', help='random rollout with ascii render')
    _env_args(d)
    d.add_argument('--steps', type=int, default=40)
    return p


def _dqn_cfg(args, **extra):
    from marlsnake_torch.algo.dqn_trainer import DQNConfig
    return DQNConfig(height=args.height, width=args.width,
                     num_snakes=args.num_snakes,
                     snake_length=args.snake_length,
                     vision_range=args.vision_range,
                     seed=args.seed, **extra)


def _load_dqn(args):
    """The DQN trainer of the env arguments and its state, the parameters
    read from the checkpoint ``args.checkpoint`` where it can be read."""
    from marlsnake_torch.algo.dqn_trainer import DQNTrainer
    tr = DQNTrainer(_dqn_cfg(args, save_dir=args.save_dir),
                    device=args.device)
    ts = tr.init_state()
    try:
        ts, _ = tr.load_checkpoint(args.checkpoint, ts)
        print(f'Loaded checkpoint: {args.checkpoint}')
    except (OSError, KeyError, ValueError, RuntimeError,
            pickle.UnpicklingError) as exc:
        print(f'Warning: evaluating with random weights '
              f'(checkpoint {args.checkpoint!r} not loadable: {exc})')
    return tr, ts


def _ppo_net(path: str, cfg, device):
    """An ``ActorCritic`` for ``cfg``'s obs holding the reference-layout
    PPO checkpoint at ``path`` (its ``model_state_dict``, or the file
    itself a state_dict)."""
    import torch
    from marlsnake_torch.models.ppo import ActorCritic
    from marlsnake_torch.models.weights import actor_critic_from_reference
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    net = ActorCritic((cfg.obs_height, cfg.obs_width),
                      num_actions=cfg.num_actions, assume_binary_obs=True,
                      device=device)
    net.load_state_dict(actor_critic_from_reference(
        ckpt.get('model_state_dict', ckpt)))
    return net


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.mode == 'train':
        from marlsnake_torch.algo.dqn_trainer import DQNTrainer
        cfg = _dqn_cfg(args, num_episodes=args.episodes,
                       num_envs=args.num_envs, resume_from=args.resume,
                       save_dir=args.save_dir, log_dir=args.log_dir)
        DQNTrainer(cfg, device=args.device).train(log=not args.no_log)

    elif args.mode == 'train-ppo':
        from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
        cfg = PPOConfig(height=args.height, width=args.width,
                        num_snakes=args.num_snakes,
                        snake_length=args.snake_length,
                        vision_range=args.vision_range,
                        num_envs=args.num_envs,
                        rollout_steps=args.rollout_steps,
                        num_updates=args.updates, seed=args.seed)
        PPOTrainer(cfg, device=args.device).train(log=not args.no_log)

    elif args.mode == 'eval':
        from marlsnake_torch.algo.evaluator import DQNEvaluator
        from marlsnake_torch.envs.wrappers import RenderGUI, make
        tr, ts = _load_dqn(args)
        env = make('Snake-v1', device=args.device,
                   num_snakes=args.num_snakes, height=args.height,
                   width=args.width, snake_length=args.snake_length,
                   vision_range=args.vision_range, seed=args.seed)
        if not args.no_render:
            env = RenderGUI(env, save_video=True,
                            video_path=f'snake_eval_{args.height}x'
                                       f'{args.width}.mp4')
        DQNEvaluator(env, tr.net, ts.params).evaluate(
            num_episodes=args.episodes, render=not args.no_render)

    elif args.mode == 'battle' and args.batched:
        from marlsnake_torch.algo.battle_batch import (
            BatchedGreedy, BatchedNEAT, BatchedPPO, BatchedRandom,
            build_battle_batch, summarize)
        from marlsnake_torch.core.types import EnvConfig
        tr, ts = _load_dqn(args)
        # the JAX CLI's config: no vision window and no map here
        cfg = EnvConfig(height=args.height, width=args.width,
                        num_snakes=args.num_snakes,
                        snake_length=args.snake_length)
        opponents, names = [], ['DQN (Main)']
        if args.ppo_checkpoint and os.path.exists(args.ppo_checkpoint):
            opponents.append(BatchedPPO(_ppo_net(args.ppo_checkpoint, cfg,
                                                 args.device)))
            names.append('PPO')
        if os.path.exists(args.hybrid_pickle):
            from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw
            data = load_hybrid_raw(args.hybrid_pickle)
            opponents.append(BatchedNEAT(data['dqn_params'],
                                         data['neat_genome'],
                                         data['neat_config'], cfg,
                                         device=args.device))
            names.append('Hybrid NEAT')
        opponents, names, seats = _cap_seats(opponents, names,
                                             args.num_snakes)
        while len(opponents) < seats - 1:
            opponents.append(BatchedRandom())
            names.append('Random Bot')
        if seats >= 1:
            opponents.append(BatchedGreedy())
            names.append('Greedy Bot')
        run = build_battle_batch(tr.net, cfg, opponents,
                                 num_envs=args.episodes, max_steps=512,
                                 device=args.device)
        rew, life = run(ts.params, seed=args.seed)
        print(summarize(rew, life, names))

    elif args.mode == 'battle':
        from marlsnake_torch.algo.battle import BattleArena
        from marlsnake_torch.algo.opponents import (GreedyAgent, NEATAgent,
                                                    PPOAgent, RandomAgent)
        from marlsnake_torch.envs.wrappers import RenderGUI, make
        tr, ts = _load_dqn(args)
        env = make('Snake-v1', device=args.device,
                   num_snakes=args.num_snakes, height=args.height,
                   width=args.width, snake_length=args.snake_length,
                   seed=args.seed)
        # the host agents' one stream of Python random numbers
        rng = random.Random(args.seed)
        # reference default lineup: masked DQN vs PPO vs HybridNEAT vs
        # Greedy (train_dqn.py:986-1003); unavailable opponents are
        # replaced by Random fillers
        enemies = []
        names = ['DQN (Main)']
        if args.ppo_checkpoint and os.path.exists(args.ppo_checkpoint):
            enemies.append(PPOAgent(1, _ppo_net(args.ppo_checkpoint,
                                                env.cfg, args.device)))
            names.append('PPO')
        if os.path.exists(args.hybrid_pickle):
            from marlsnake_torch.algo.neat_hybrid import load_hybrid_raw
            data = load_hybrid_raw(args.hybrid_pickle)
            enemies.append(NEATAgent(len(enemies) + 1, data['dqn_params'],
                                     data['neat_genome'],
                                     data['neat_config'], env.cfg,
                                     device=args.device))
            names.append('Hybrid NEAT')
        enemies, names, seats = _cap_seats(enemies, names,
                                           args.num_snakes)
        while len(enemies) < seats - 1:
            enemies.append(RandomAgent(len(enemies) + 1, rng))
            names.append('Random Bot')
        if seats >= 1:
            enemies.append(GreedyAgent(args.num_snakes - 1, rng))
            names.append('Greedy Bot')
        renv = env
        if not args.no_render:
            renv = RenderGUI(env, save_video=True,
                             video_path='battle_results.mp4')
        BattleArena(renv, tr.net, ts.params, enemies,
                    display_names=names).run_battle(
            num_episodes=args.episodes, render=not args.no_render)

    elif args.mode == 'neat':
        from marlsnake_torch.algo.neat import NeatConfig
        from marlsnake_torch.algo.neat_hybrid import (DEFAULT_REWARD,
                                                      HybridNEATTrainer)
        from marlsnake_torch.core.types import EnvConfig
        tr, ts = _load_dqn(args)
        env_cfg = EnvConfig.from_reward_dict(
            DEFAULT_REWARD, height=args.height, width=args.width,
            num_snakes=args.num_snakes, snake_length=args.snake_length)
        neat_cfg = NeatConfig(num_inputs=128, num_outputs=3,
                              pop_size=args.pop_size)
        HybridNEATTrainer(ts.params, env_cfg=env_cfg, neat_cfg=neat_cfg,
                          result_file=args.result_file, seed=args.seed,
                          fitness_episodes=args.fitness_episodes,
                          device=args.device).run(args.generations)

    elif args.mode == 'es':
        from marlsnake_torch.algo.neat import NeatConfig
        from marlsnake_torch.algo.neat_hybrid import (DEFAULT_REWARD,
                                                      HeadESTrainer)
        from marlsnake_torch.core.types import EnvConfig
        tr, ts = _load_dqn(args)
        env_cfg = EnvConfig.from_reward_dict(
            DEFAULT_REWARD, height=args.height, width=args.width,
            num_snakes=args.num_snakes, snake_length=args.snake_length)
        es = HeadESTrainer(
            ts.params, env_cfg=env_cfg,
            neat_cfg=NeatConfig(num_inputs=128, num_outputs=3),
            pop_size=args.pop_size, sigma=args.sigma, lr=args.lr,
            fitness_episodes=args.fitness_episodes, seed=args.seed,
            result_file=args.result_file, device=args.device)
        best_theta, best_val, _ = es.run(
            args.generations, val_episodes=args.val_episodes)
        ma, mb, dm, ds = es.holdout_compare(
            es._seed_theta, best_theta, episodes=args.holdout_episodes)
        sem = ds / max(args.holdout_episodes, 1) ** 0.5
        print(f'holdout ({args.holdout_episodes} fresh paired episodes): '
              f'seed {ma:.2f} champion {mb:.2f} '
              f'diff {dm:+.2f} +/- {sem:.2f} (sem) -> '
              f'{"IMPROVED" if dm > 2 * sem else "no detectable gain"}')

    elif args.mode == 'demo':
        from marlsnake_torch.envs.wrappers import make_snake
        kwargs = {}
        if args.map:
            kwargs['map'] = args.map
        env, _, _, props = make_snake(
            num_envs=1, num_snakes=args.num_snakes, height=args.height,
            width=args.width, snake_length=args.snake_length,
            vision_range=args.vision_range, seed=args.seed,
            device=args.device, **kwargs)
        env.reset()
        done = [False] * props['num_snakes']
        steps = 0
        while not all(done) and steps < args.steps:
            actions = [env.action_space.sample() % 3
                       for _ in range(props['num_snakes'])]
            obs, rewards, done, infos = env.step(actions)
            steps += 1
        env.unwrapped.render('ascii')
        print(f'demo: {steps} steps, final rank '
              f'{infos.get("rank") if infos else "n/a"}')


if __name__ == '__main__':
    main()
