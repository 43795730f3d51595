"""marlsnake_torch.algo.dqn_trainer against marlsnake_tpu.algo.dqn_trainer.

Both trainers get the same parameters (carried across by
``models/weights.py``) and the same random numbers: the JAX trainer
derives its draws from its key schedule, and the port takes exactly those
numbers as ``ResetDraws`` and ``TrainDraws``. Float32 on the CPU, TF32
off. Tolerances, each where it is used:

* one TD update: loss within 1e-6 relative, gradients within
  1e-6 + 1e-5 x their largest magnitude (oneDNN and XLA sum the
  convolutions in different orders);
* the optimizer alone, on the same gradients: parameters and both moments
  within 1e-6 of each tensor's largest magnitude (XLA contracts
  ``a * g + b * m`` into one fused multiply-add and PyTorch does not, so
  an element where the two terms cancel agrees only to the terms' own
  rounding), the count equal;
* a whole episode at ``epsilon_start=1.0`` (every action explores, so the
  trajectory does not depend on Q): the replay ring, ``ptr``, ``size``,
  the episode length, the update count, the mean reward and epsilon
  EQUAL; the mean loss within 1e-4 relative; parameters within 1e-3
  absolute (after its first steps Adam moves an element by about
  ``lr * g / |g|``, so a rounding difference in a gradient near zero can
  move a parameter by up to ``lr``; the gradient and optimizer tests
  above carry the tight bounds);
* bfloat16 forward: within 5e-2 of the float32 forward and of flax's
  bfloat16 forward.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from marlsnake_tpu.algo.dqn_trainer import DQNConfig as JConfig
from marlsnake_tpu.algo.dqn_trainer import DQNTrainer as JTrainer
from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_torch.algo import optim
from marlsnake_torch.algo.dqn_trainer import (DQNConfig, DQNTrainer,
                                              huber_loss)
from marlsnake_torch.models.dqn import DQN, prepare_obs
from marlsnake_torch.models.weights import (dqn_from_flax, dqn_to_flax,
                                            train_state_from_flax)
from marlsnake_torch.rng import TrainDraws
from test_torch_engine import reset_draws_from_keys
from test_torch_replay import assert_rings_equal

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SMALL = dict(height=8, width=8, num_snakes=2, snake_length=3, num_envs=2,
             max_steps_per_episode=12, batch_size=8, buffer_size=24,
             min_buffer_size=8, epsilon_start=1.0)


# --- helpers shared with test_torch_checkpoint.py ---------------------------

def _t(x):
    return torch.as_tensor(np.array(x))


def trainers(**kwargs):
    """The same configuration in both packages, the port on the CPU."""
    jkw = dict(kwargs)
    if jkw.get('compute_dtype') is torch.bfloat16:
        jkw['compute_dtype'] = jnp.bfloat16
    return JTrainer(JConfig(**jkw)), DQNTrainer(DQNConfig(**kwargs),
                                                device='cpu')


def numpy_state(jts):
    """A JAX TrainState with numpy leaves, as train_state_from_flax
    takes it."""
    return jax.tree.map(np.asarray,
                        jts.replace(key=jax.random.key_data(jts.key)))


def episode_draws(jtr, jts, tr, ring_size=None, axis_index=None):
    """(ResetDraws, TrainDraws) that the JAX trainer's next episode takes
    from ``jts.key`` (dqn_trainer.py:323-331, 374, 289-291; replay.py:105;
    the envs' own fruit keys, engine.py:576, 933). With ``ring_size``, the
    fill of a ring that stays full through the episode, also the indices
    JAX draws when it samples with replacement (replay.py:101). With
    ``axis_index``, those of that device of a data-parallel mesh, whose
    streams fold in its index (dqn_trainer.py:324-329); ``tr`` then has
    the device's own ``num_envs``."""
    cfg, ecfg = tr.config, tr.env_cfg
    e, n = cfg.num_envs, cfg.num_snakes
    key, k_reset, _ = jax.random.split(jts.key, 3)
    if axis_index is not None:
        k_reset = jax.random.fold_in(k_reset, axis_index)
        key = jax.random.fold_in(key, axis_index + 1_000_003)
    reset_keys = jax.random.split(
        jax.random.fold_in(k_reset, jts.episode), e)
    env_keys = jax.vmap(lambda k: jax.random.fold_in(k, 2))(reset_keys)
    rand, explore, fruit, sample, sample_idx = [], [], [], [], []
    for _ in range(cfg.max_steps_per_episode):
        key, k_act, k_sample = jax.random.split(key, 3)
        k1, k2 = jax.random.split(k_act)
        rand.append(jax.random.randint(k1, (e, n), 0, ecfg.num_actions))
        explore.append(jax.random.uniform(k2, (e, n)))
        sample.append(jax.random.uniform(k_sample, (cfg.buffer_size,)))
        if ring_size is not None:
            sample_idx.append(jax.random.randint(
                k_sample, (tr.update_batch,), 0, ring_size))
        split = jax.vmap(jax.random.split)(env_keys)
        env_keys = split[:, 0]
        fruit.append(jax.vmap(
            lambda k: jax.random.uniform(k, (n,)))(split[:, 1]))
    stack = lambda xs: _t(np.stack([np.asarray(x) for x in xs]))
    return (reset_draws_from_keys(ecfg, reset_keys),
            TrainDraws(stack(rand).to(torch.int32), stack(explore),
                       stack(fruit), stack(sample),
                       stack(sample_idx).long() if sample_idx else None))


def random_batch(rng, batch, hw, num_actions=3):
    shape = (batch,) + hw + (8,)
    return ((rng.random(shape) < 0.2).astype(np.uint8),
            rng.integers(0, num_actions, batch).astype(np.int32),
            rng.normal(size=batch).astype(np.float32) * 3,
            (rng.random(shape) < 0.2).astype(np.uint8),
            rng.random(batch) < 0.3)


def jax_loss_and_grads(jtr, params, target_params, batch):
    """The JAX trainer's TD loss (dqn_trainer.py:300-309) and gradients."""
    obs, action, rew, next_obs, done = batch

    def loss_fn(p):
        q = jtr.net.apply(p, jtr._prep(obs))
        q_sa = jnp.take_along_axis(q, action[:, None], axis=-1)[:, 0]
        next_q = jtr.net.apply(target_params, jtr._prep(next_obs)).max(-1)
        target = rew + (1.0 - done.astype(jnp.float32)) \
            * jtr.config.gamma * jax.lax.stop_gradient(next_q)
        return optax.huber_loss(q_sa, target, delta=1.0).mean()

    return jax.value_and_grad(loss_fn)(params)


def assert_params_close(jparams, params, grid_hw, atol, what):
    got = dqn_to_flax(params, grid_hw)['params']
    for layer, leaves in jparams['params'].items():
        for name, want in leaves.items():
            np.testing.assert_allclose(
                got[layer][name], np.asarray(want), rtol=0, atol=atol,
                err_msg=f'{what} {layer}/{name}')


def assert_grads_close(jgrads, grads, grid_hw, what):
    """Within 1e-6 + 1e-5 x the largest magnitude of each gradient."""
    got = dqn_to_flax(grads, grid_hw)['params']
    for layer, leaves in jgrads['params'].items():
        for name, want in leaves.items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                got[layer][name], want, rtol=0,
                atol=1e-6 + 1e-5 * np.abs(want).max(),
                err_msg=f'{what} {layer}/{name}')


# --- (b) one TD update -------------------------------------------------------

def test_td_update_loss_and_gradients_match_jax():
    """10x10, batch 32, target parameters from another seed."""
    hw = (10, 10)
    jtr, tr = trainers(height=10, width=10, num_snakes=2, batch_size=32)
    jts = jtr.init_state()
    jtarget = jtr.init_state(jax.random.key(9)).params
    batch = random_batch(np.random.default_rng(0), 32, hw)
    params = dqn_from_flax(jts.params, hw)
    target = dqn_from_flax(jtarget, hw)

    jloss, jgrads = jax_loss_and_grads(jtr, jts.params, jtarget,
                                       tuple(map(jnp.asarray, batch)))
    loss, grads, q_act = tr.loss_and_grads(params, target,
                                           tuple(map(_t, batch)))
    assert q_act is None and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert_grads_close(jgrads, dict(zip(params, grads)), hw, 'grad')

    # the whole update: same loss; parameters move by lr per element at
    # most on the first Adam step, and agree closely where the gradient
    # is not tiny
    jp, jopt, jloss2 = jtr._td_update(jts.params, jtarget, jts.opt_state,
                                      tuple(map(jnp.asarray, batch)))
    ts = tr.init_state()
    p2, opt2, loss2, _ = tr._td_update(params, target, ts.opt_state,
                                       tuple(map(_t, batch)))
    np.testing.assert_allclose(float(loss2), float(jloss2), rtol=1e-6)
    assert int(opt2.count) == int(jopt[1][0].count) == 1
    assert_params_close(jp, p2, hw, 2 * tr.config.lr + 1e-7, 'params')
    mu = dqn_to_flax(dict(zip(params, opt2.mu)), hw)['params']
    np.testing.assert_allclose(
        mu['fc3']['kernel'], np.asarray(jopt[1][0].mu['params']['fc3'][
            'kernel']), rtol=0, atol=1e-7)


def test_fused_forward_gives_the_same_loss_and_the_acting_q_values():
    hw = (8, 8)
    _, tr = trainers(**SMALL)
    ts = tr.init_state()
    rng = np.random.default_rng(1)
    batch = tuple(map(_t, random_batch(rng, 8, hw)))
    acting = _t((rng.random((4,) + hw + (8,)) < 0.2).astype(np.uint8))
    loss, grads, none = tr.loss_and_grads(ts.params, ts.target_params, batch)
    loss_f, grads_f, q_act = tr.loss_and_grads(ts.params, ts.target_params,
                                               batch, acting)
    assert none is None and not q_act.requires_grad
    np.testing.assert_allclose(float(loss_f), float(loss), rtol=1e-6)
    for a, b in zip(grads, grads_f):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(q_act.numpy(),
                                   tr._q(ts.params, acting).numpy(),
                                   rtol=0, atol=1e-5)


def test_huber_loss_matches_optax():
    rng = np.random.default_rng(2)
    pred = rng.normal(size=64).astype(np.float32) * 2
    target = rng.normal(size=64).astype(np.float32) * 2
    target[:4] = pred[:4] + np.float32([1.0, -1.0, 0.0, 1.0000001])
    np.testing.assert_array_equal(
        huber_loss(_t(pred), _t(target)).numpy(),
        np.asarray(optax.huber_loss(jnp.asarray(pred), jnp.asarray(target),
                                    delta=1.0)))


# --- (c) the optimizer alone -------------------------------------------------

def test_clip_and_adam_match_optax_on_the_same_gradients():
    """Five steps of clip(10) + Adam(5e-4); the gradient norms are about
    0.06, 60, 3, 30 and 9.99, so both sides of the clip are taken."""
    rng = np.random.default_rng(3)
    shapes = [(3, 4, 2, 2), (3,), (5, 7), (5,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    scales = [1e-2, 10.0, 0.5, 5.0, None]
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(5e-4))
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    tp = [_t(p) for p in p0]
    state = optim.adam_init(tp)
    assert int(state.count) == 0 and state.count.dtype == torch.int32
    clipped_any = kept_any = False
    for scale in scales:
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g))
        factor = scale if scale is not None else 9.99 / norm
        g = [(x * factor).astype(np.float32) for x in g]
        tg = [_t(x) for x in g]
        norm = float(optim.global_norm(tg))
        np.testing.assert_allclose(
            norm, float(optax.global_norm([jnp.asarray(x) for x in g])),
            rtol=1e-6)
        clipped = optim.clip_by_global_norm(tg, 10.0)
        if norm < 10.0:
            kept_any = True
            assert all(torch.equal(a, b) for a, b in zip(clipped, tg))
        else:
            clipped_any = True
            np.testing.assert_allclose(float(optim.global_norm(clipped)),
                                       10.0, rtol=1e-6)
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        upd, state = optim.adam_update(clipped, state, 5e-4)
        tp = optim.apply_updates(tp, upd)
        adam = jstate[1][0]
        assert int(state.count) == int(adam.count)
        for got, want in ((tp, jp), (state.mu, adam.mu), (state.nu, adam.nu)):
            for a, b in zip(got, want):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                           atol=1e-6 * np.abs(b).max())
    assert clipped_any and kept_any


# --- (d) a whole episode -----------------------------------------------------

# ReLU gates at a kink: JAX's and the port's float32 pre-activation of a unit
# can lie on either side of zero; from Adam's first steps on, which move
# every entry by about lr whatever its gradient's size, such a gate can
# move the parameters by more than the 1e-3 of the episode checks.

RELU_LAYERS = ('conv1', 'conv2', 'conv3', 'fc1', 'fc2')


def port_preacts(tr, params, obs):
    """The pre-activations of the port's five ReLU layers, float32, as
    ``DQN._trunk`` computes them; NHWC, by flax's layer names."""
    x = prepare_obs(tr._prep(obs), torch.float32,
                    tr.config.assume_binary_obs).permute(0, 3, 1, 2)
    pre = {}
    for name in RELU_LAYERS:
        if name == 'fc1':
            x = x.flatten(1)
        w, b = params[f'{name}.weight'], params[f'{name}.bias']
        y = F.conv2d(x, w, b, padding=1) if w.dim() == 4 else F.linear(x,
                                                                      w, b)
        pre[name] = (y.permute(0, 2, 3, 1) if y.dim() == 4 else y).numpy()
        x = F.relu(y)
    return pre


@functools.lru_cache(maxsize=None)
def _gated_grads(jtr):
    """``jax_loss_and_grads`` under ``jax.jit`` with the port's ReLU gates
    (see ``jax_grads_with_port_gates``), built once a JAX trainer."""
    def run(params, target, batch, port_pre):
        _, inter = jtr.net.apply(params, jtr._prep(batch[0]),
                                 capture_intermediates=True,
                                 mutable=['intermediates'])
        flips, count, largest = {}, 0, jnp.float32(0)
        for name, want in port_pre.items():
            y = inter['intermediates'][name]['__call__'][0]
            flips[name] = (want > 0) != (y > 0)
            count += flips[name].sum()
            largest = jnp.maximum(
                largest, jnp.where(flips[name], jnp.abs(y), 0.0).max())
        applies = [0]

        def interceptor(next_fun, args, kwargs, context):
            if context.module.name is None:
                if context.method_name == '__call__':
                    applies[0] += 1
                return next_fun(*args, **kwargs)
            y = next_fun(*args, **kwargs)
            name = context.module.name
            if applies[0] == 1 and name in flips:
                y = y + jnp.where(flips[name], jax.lax.stop_gradient(
                    port_pre[name] - y), 0.0)
            return y

        with nn.intercept_methods(interceptor):
            loss, grads = jax_loss_and_grads(jtr, params, target, batch)
        return loss, grads, count, largest

    return jax.jit(run)


def jax_grads_with_port_gates(jtr, params, target, batch, port_pre):
    """JAX's TD gradients at ``params`` with the port's ReLU gates: in the
    online forward (the first ``net.apply``; not the target's), a unit
    whose JAX pre-activation lies on the other side of zero from the
    port's ``port_pre`` takes the port's value, in the forward only, so
    that its gate is the port's. Returns (loss, gradients, the number of
    such units, the largest |JAX pre-activation| among them)."""
    loss, grads, count, largest = _gated_grads(jtr)(params, target, batch,
                                                    port_pre)
    return float(loss), grads, int(count), float(largest)


def record_updates(tr, monkeypatch) -> list:
    """Keeps, for every TD update ``tr`` computes, its parameters, target
    parameters and minibatch (cloned) and whether the update was kept
    (the chunk body computes every update and selects)."""
    records = []
    loss_and_grads, select = tr.loss_and_grads, tr._select_update

    def recorded(params, target, batch, acting=None):
        records.append([{k: v.clone() for k, v in d.items()}
                        for d in (params, target)]
                       + [tuple(x.clone() for x in batch)])
        return loss_and_grads(params, target, batch, acting)

    def selected(can_update, new, old):
        records[-1].append(bool(can_update))
        return select(can_update, new, old)

    monkeypatch.setattr(tr, 'loss_and_grads', recorded)
    monkeypatch.setattr(tr, '_select_update', selected)
    return records


def replay_with_port_gates(jtr, tr, params, opt, records, hw):
    """JAX's updates from (``params``, ``opt``) along JAX's own parameters,
    on the minibatches and target parameters the port recorded, each
    gradient with the port's ReLU gates (at the port's parameters of that
    update). Returns (params, opt, the mean loss of the updates, units
    gated, the largest |JAX pre-activation| among them)."""
    losses, flips, largest = [], 0, 0.0
    for p, target, batch, kept in records:
        if not kept:
            continue
        loss, grads, n, big = jax_grads_with_port_gates(
            jtr, params, dqn_to_flax(target, hw),
            tuple(jnp.asarray(x.numpy()) for x in batch),
            port_preacts(tr, p, batch[0]))
        losses.append(loss)
        flips, largest = flips + n, max(largest, big)
        updates, opt = jtr.tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    return params, opt, np.mean(losses), flips, largest


@pytest.mark.parametrize('mode,kinks', [
    pytest.param(dict(update_every=1), False, id='every-1'),
    pytest.param(dict(update_every=2), False, id='every-2'),
    pytest.param(dict(fused_act_update=True), False, id='fused'),
    pytest.param(dict(obs_format='packed'), False, id='packed'),
    pytest.param(dict(obs_format='packed', frame_stack=2), False,
                 id='packed-stack2'),
    pytest.param(dict(vision_range=2, frame_stack=2), False,
                 id='vision2-stack2'),
    pytest.param(dict(num_envs=3, min_buffer_size=14), True,
                 id='warm-late-relu-kink')])
def test_episode_matches_jax(mode, kinks, monkeypatch):
    """Two episodes of 8x8 with 2 snakes, 2 envs, 12 steps, batch 8, a
    ring of 24 (the second starts with a warm ring and wraps it). With
    packed obs the ring holds the packed bytes in both packages; the
    frame stack and the vision window pass through the trainer's hold of
    finished envs.

    At 3 envs with ``min_buffer_size=14`` the ring turns warm late in the
    first episode, and JAX's fourth update has a conv3 unit at +3.5e-8 in
    XLA's float32 forward where the port's lies below zero. Its gate, and
    Adam's lr-sized first steps, put JAX's parameters 1.4e-3 from the
    port's after the episode and 2.6e-3 after the second (and the second
    episode's mean loss 3.4e-4 apart). There the parameters and the mean
    loss are held against ``replay_with_port_gates`` over both episodes
    instead, at the same tolerances: every other field stays held against
    JAX's episode, each gated unit must lie within 1e-6 of zero, and at
    least one must be gated."""
    jtr, tr = trainers(**dict(SMALL, **mode))
    hw = (tr.env_cfg.obs_height, tr.env_cfg.obs_width)
    jts = jtr.init_state()
    assert jts.buffer.obs_shape == tr.env_cfg.obs_shape[1:]
    ts = train_state_from_flax(numpy_state(jts), hw, 'cpu')
    records = record_updates(tr, monkeypatch) if kinks else None
    params, opt = jts.params, jtr.tx.init(jts.params)
    flips, largest = 0, 0.0
    total_updates = 0
    for ep in range(2):
        reset, draws = episode_draws(jtr, jts, tr)
        jts, jm = jtr._train_episode(jts)
        ts, m = tr.train_episode(ts, draws, reset)
        where = f'episode {ep}'
        assert_rings_equal(jts.buffer, ts.buffer, where)
        assert m.episode_length == float(jm.episode_length), where
        assert m.updates == int(jm.updates), where
        assert float(m.mean_reward) == float(jm.mean_reward), where
        assert float(ts.epsilon) == float(jts.epsilon), where
        assert ts.episode == int(jts.episode) == ep + 1
        assert ts.global_step == int(jts.global_step)
        want_params, want_loss = jts.params, float(jm.mean_loss)
        if kinks:
            assert sum(r[-1] for r in records) == m.updates, where
            params, opt, want_loss, n, big = replay_with_port_gates(
                jtr, tr, params, opt, records, hw)
            records.clear()
            want_params, where = params, f'{where}, replayed'
            flips, largest = flips + n, max(largest, big)
        np.testing.assert_allclose(float(m.mean_loss), want_loss,
                                   rtol=1e-4, err_msg=where)
        assert_params_close(want_params, ts.params, hw, 1e-3, where)
        assert int(ts.opt_state.count) == int(jts.opt_state[1][0].count)
        total_updates += m.updates
    assert total_updates > 0 and int(ts.buffer.size) == 24
    if kinks:
        assert flips > 0 and largest <= 1e-6, (flips, largest)


def test_episode_sampling_with_replacement_matches_jax():
    """A batch of 32 from a ring of 24: JAX then samples with replacement,
    ``randint(k_sample, (32,), 0, size)``. From a ring that is full (two
    JAX episodes fill it, and a full ring stays full) the indices are
    known up front and go to the port as ``TrainDraws.sample_idx``."""
    hw = (8, 8)
    jtr, tr = trainers(**dict(SMALL, batch_size=32, epsilon_decay=1.0))
    jts = jtr.init_state()
    for _ in range(2):
        jts, _ = jtr._train_episode(jts)
    assert int(jts.buffer.size) == 24
    ts = train_state_from_flax(numpy_state(jts), hw, 'cpu')
    reset, draws = episode_draws(jtr, jts, tr, ring_size=24)
    assert draws.sample_idx.shape == (12, 32)
    jts, jm = jtr._train_episode(jts)
    ts, m = tr.train_episode(ts, draws, reset)
    assert_rings_equal(jts.buffer, ts.buffer)
    assert m.updates == int(jm.updates) > 0
    assert m.episode_length == float(jm.episode_length)
    assert float(m.mean_reward) == float(jm.mean_reward)
    np.testing.assert_allclose(float(m.mean_loss), float(jm.mean_loss),
                               rtol=1e-4)
    assert_params_close(jts.params, ts.params, hw, 1e-3, 'with replacement')
    # the port's own draws for this case are uniforms, one per batch row
    ts, m = tr.train_episode(ts)
    assert m.updates > 0 and bool(torch.isfinite(m.mean_loss))


def test_episode_with_own_draws_is_reproducible_and_stops_when_all_done():
    cfg = dict(SMALL, max_steps_per_episode=64)
    runs = []
    for _ in range(2):
        tr = DQNTrainer(DQNConfig(**cfg), device='cpu')
        ts, m = tr.train_episode(tr.init_state())
        runs.append((ts, m, tr.generator.get_state()))
    (a, ma, ga), (b, mb, gb) = runs
    assert ma.episode_length == mb.episode_length < 64
    assert float(ma.mean_loss) == float(mb.mean_loss)
    assert torch.equal(ga, gb)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    # a finished env was pushed no more: the ring holds what the live
    # agents produced, at most one row per agent and step
    assert int(a.buffer.size) <= 2 * 2 * int(ma.episode_length)
    # the parameters moved and the target net did not (no sync is due)
    init = tr.init_state()
    assert not torch.equal(a.params['fc3.weight'], init.params['fc3.weight'])
    assert all(torch.equal(a.target_params[k], init.params[k])
               for k in init.params)


# --- (e) epsilon and target sync --------------------------------------------

def test_epsilon_decays_to_its_floor_and_target_syncs_on_schedule():
    tr = DQNTrainer(DQNConfig(**dict(
        SMALL, epsilon_start=0.0501, epsilon_decay=0.999,
        target_update_freq=2)), device='cpu')
    ts = tr.init_state()
    eps = np.float32(0.0501)
    for ep in range(1, 5):
        ts, _ = tr.train_episode(ts)
        eps = np.maximum(np.float32(0.05), eps * np.float32(0.999))
        assert float(ts.epsilon) == float(eps), ep
        same = all(ts.target_params[k] is ts.params[k] for k in ts.params)
        assert same == (ep % 2 == 0), ep
    assert float(ts.epsilon) == float(np.float32(0.05))


def test_config_defaults_and_checks_match_jax():
    import dataclasses
    jdefaults = {f.name: f.default for f in dataclasses.fields(JConfig)
                 if f.default is not dataclasses.MISSING}
    defaults = {f.name: f.default for f in dataclasses.fields(DQNConfig)
                if f.default is not dataclasses.MISSING}
    assert list(defaults) == list(jdefaults)
    assert jdefaults.pop('compute_dtype') is jnp.float32
    assert defaults.pop('compute_dtype') is torch.float32
    assert defaults == jdefaults
    assert DQNConfig().reward_dict == JConfig().reward_dict
    with pytest.raises(ValueError):
        DQNTrainer(DQNConfig(max_steps_per_episode=10, update_every=3),
                   device='cpu')
    with pytest.raises(ValueError):
        DQNTrainer(DQNConfig(fused_act_update=True, update_every=4,
                             max_steps_per_episode=16), device='cpu')
    # re-encoding the acting obs is exact only for the plain full obs:
    # both packages refuse it for the same configs, with the same words
    for kwargs in (dict(obs_format='packed'), dict(frame_stack=2),
                   dict(vision_range=3)):
        messages = []
        for cls, trainer, extra in ((JConfig, JTrainer, {}),
                                    (DQNConfig, DQNTrainer,
                                     dict(device='cpu'))):
            tr = trainer(cls(height=8, width=8, num_snakes=2,
                             reencode_acting_obs=True, **kwargs), **extra)
            assert tr.env_cfg.obs_format == kwargs.get('obs_format', 'uint8')
            with pytest.raises(ValueError, match='pure function') as info:
                tr._acting_obs(None, None)
            messages.append(str(info.value))
        assert messages[0] == messages[1]


@pytest.mark.parametrize('kwargs', [
    dict(obs_format='packed'), dict(obs_format='packed', frame_stack=4),
    dict(vision_range=3, frame_stack=2, obs_format='packed')])
def test_prep_unpacks_packed_obs_before_the_pad(kwargs):
    """``_prep`` against the JAX trainer's: the unpacked planes first, the
    pad channels behind them; the net and the ring take their shapes from
    the config."""
    jtr, tr = trainers(**SMALL, obs_pad_channels=4, **kwargs)
    ecfg = tr.env_cfg
    shape = ecfg.obs_shape[1:]
    obs = np.random.default_rng(0).integers(0, 256, size=(5,) + shape,
                                            dtype=np.uint8)
    got = tr._prep(_t(obs))
    assert got.dtype == torch.uint8
    assert got.shape == (5,) + shape[:2] + (8 * ecfg.frame_stack + 4,)
    np.testing.assert_array_equal(np.asarray(jtr._prep(jnp.asarray(obs))),
                                  got.numpy())
    ts = tr.init_state()
    assert ts.buffer.obs_shape == shape
    assert ts.params['conv1.weight'].shape[1] == 8 * ecfg.frame_stack + 4
    assert ts.params['fc1.weight'].shape[1] == 64 * shape[0] * shape[1]
    q = tr._q(ts.params, _t(obs))
    assert q.shape == (5, 3) and bool(torch.isfinite(q).all())


# --- (f) compute_dtype and channel padding ----------------------------------

def test_bfloat16_forward_is_close_to_float32_and_to_flax_bfloat16():
    hw = (10, 10)
    params = FlaxDQN(num_actions=3).init(
        jax.random.key(4), jnp.zeros((1,) + hw + (8,), jnp.float32))
    obs = (np.random.default_rng(4).random((12,) + hw + (8,)) < 0.2
           ).astype(np.uint8)
    nets = {}
    for dt in (torch.float32, torch.bfloat16):
        nets[dt] = DQN(hw, 8, 3, assume_binary_obs=True, device='cpu',
                       compute_dtype=dt)
        nets[dt].load_state_dict(dqn_from_flax(params, hw))
    with torch.no_grad():
        q32 = nets[torch.float32](_t(obs))
        q16 = nets[torch.bfloat16](_t(obs))
        f16 = nets[torch.bfloat16].features(_t(obs))
    assert q16.dtype == torch.float32 and f16.dtype == torch.float32
    assert nets[torch.bfloat16].fc1.weight.dtype == torch.float32
    np.testing.assert_allclose(q16.numpy(), q32.numpy(), rtol=0, atol=5e-2)
    jq16 = FlaxDQN(num_actions=3, compute_dtype=jnp.bfloat16,
                   assume_binary_obs=True).apply(params, obs)
    assert jq16.dtype == jnp.float32
    np.testing.assert_allclose(q16.numpy(), np.asarray(jq16), rtol=0,
                               atol=5e-2)


def test_padded_channels_give_the_unpadded_forward():
    """obs_pad_channels=8: conv1 of the padded net, zero-extended from
    the unpadded net's, gives the same Q-values on the padded obs."""
    _, plain = trainers(**SMALL)
    _, padded = trainers(**SMALL, obs_pad_channels=8)
    params = plain.init_state().params
    wide = dict(params)
    wide['conv1.weight'] = torch.cat(
        [params['conv1.weight'], torch.zeros(32, 8, 3, 3)], 1)
    assert padded.init_state().params['conv1.weight'].shape == (32, 16, 3, 3)
    obs = _t((np.random.default_rng(5).random((6, 8, 8, 8)) < 0.2
              ).astype(np.uint8))
    assert padded._prep(obs).shape == (6, 8, 8, 16)
    assert padded._prep(obs).dtype == torch.uint8
    assert not padded._prep(obs)[..., 8:].any()
    with torch.no_grad():
        assert torch.equal(padded._q(wide, obs), plain._q(params, obs))


def test_reencoded_acting_obs_equals_the_carried_obs():
    _, tr = trainers(**SMALL, reencode_acting_obs=True)
    from marlsnake_torch.rng import reset_draws
    states, obs = tr._reset_env(reset_draws(tr.env_cfg, 2, tr.generator,
                                            'cpu'))
    assert torch.equal(tr._acting_obs(states, obs), obs)
    assert tr._acting_obs(states, None) is not None


def test_main_runs_two_episodes_on_the_cpu(tmp_path, monkeypatch, capsys):
    from marlsnake_torch.algo import dqn_trainer
    monkeypatch.chdir(tmp_path)
    dqn_trainer.main(['--device', 'cpu', '--episodes', '2', '--no-log',
                      '--height', '8', '--width', '8', '--num-snakes', '2',
                      '--num-envs', '2'])
    assert 'Ep     2 | Mean Reward' in capsys.readouterr().out
    assert (tmp_path / 'checkpoints' / 'shared_model_final.pt').exists()
    assert not (tmp_path / 'runs_dqn').exists()
