"""The port's DQN, weight conversion and acting against the flax DQN.

Float32 on both sides with TF32 off; Q-values and features within atol
1e-4 (oneDNN and XLA sum the convolutions in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlsnake_tpu.models.dqn import DQN as FlaxDQN
from marlsnake_tpu.models.torch_interop import (dqn_params_from_torch,
                                                dqn_params_to_torch)
from marlsnake_torch.algo.acting import select_actions
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.models.dqn import DQN, make_dqn
from marlsnake_torch.models.weights import (dqn_from_flax,
                                            dqn_from_reference,
                                            load_reference_checkpoint)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

HW = (10, 10)


def flax_params(seed=0, hw=HW):
    return FlaxDQN(num_actions=3).init(
        jax.random.key(seed), jnp.zeros((1,) + hw + (8,), jnp.float32))


def port_dqn(params, hw=HW, assume_binary_obs=False):
    net = DQN(hw, 8, 3, assume_binary_obs=assume_binary_obs, device='cpu')
    net.load_state_dict(dqn_from_flax(params, hw))
    return net


def one_hot_obs(rng, b, hw=HW):
    return (rng.random((b,) + hw + (8,)) < 0.2).astype(np.uint8)


@pytest.mark.parametrize('binary', [False, True])
def test_q_values_and_features_match_flax(binary):
    params = flax_params(1)
    net = port_dqn(params, assume_binary_obs=binary)
    fnet = FlaxDQN(num_actions=3, assume_binary_obs=binary)
    obs = one_hot_obs(np.random.default_rng(1), 12)
    with torch.no_grad():
        q = net(torch.as_tensor(obs)).numpy()
        f = net.features(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(q, np.asarray(fnet.apply(params, obs)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        f, np.asarray(fnet.apply(params, obs, method=FlaxDQN.features)),
        rtol=0, atol=1e-4)


def test_byte_inputs_are_scaled_like_flax():
    params = flax_params(2)
    obs = np.random.default_rng(2).integers(0, 256, (4,) + HW + (8,),
                                            dtype=np.uint8)
    with torch.no_grad():
        q = port_dqn(params)(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(
        q, np.asarray(FlaxDQN(num_actions=3).apply(params, obs)),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize('hw', [(10, 10), (20, 20), (7, 12)])
def test_dqn_from_flax_agrees_with_dqn_params_to_torch(hw):
    params = flax_params(3, hw)
    got = dqn_from_flax(params, hw)
    want = dqn_params_to_torch(params, hw)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize('hw,channels', [((11, 11), 8), ((10, 10), 32),
                                         ((7, 7), 16)],
                         ids=['vision5', 'stack4', 'vision3-stack2'])
def test_weights_round_trip_for_stacked_and_windowed_obs(hw, channels):
    """fc1 is 64 * Ho * Wo wide and conv1 takes 8 * frame_stack channels:
    flax parameters of those shapes carry over, give the flax Q-values,
    and go back unchanged; ``make_dqn`` has the same shapes."""
    from marlsnake_torch.models.weights import dqn_to_flax
    params = FlaxDQN(num_actions=3).init(
        jax.random.key(2), jnp.zeros((1,) + hw + (channels,), jnp.float32))
    state = dqn_from_flax(params, hw)
    assert state['conv1.weight'].shape == (32, channels, 3, 3)
    assert state['fc1.weight'].shape == (256, 64 * hw[0] * hw[1])
    net = DQN(hw, channels, 3, assume_binary_obs=True, device='cpu')
    net.load_state_dict(state)
    obs = (np.random.default_rng(2).random((6,) + hw + (channels,)) < 0.2
           ).astype(np.uint8)
    with torch.no_grad():
        q = net(torch.as_tensor(obs)).numpy()
    want = FlaxDQN(num_actions=3, assume_binary_obs=True).apply(params, obs)
    np.testing.assert_allclose(q, np.asarray(want), rtol=0, atol=1e-4)
    back = dqn_to_flax(state, hw)['params']
    for layer, leaves in params['params'].items():
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(back[layer][name],
                                          np.asarray(leaf))
    vision = hw[0] if hw[0] != 10 else None
    cfg = EnvConfig(height=10, width=10, num_snakes=2,
                    vision_range=None if vision is None else vision // 2,
                    frame_stack=channels // 8, obs_format='packed')
    made = make_dqn(cfg, seed=0, device='cpu').state_dict()
    assert {k: v.shape for k, v in made.items()} == {
        k: v.shape for k, v in state.items()}


def test_reference_checkpoint_reader(tmp_path):
    """A reference-layout state_dict (DataParallel 'module.' keys) loads
    into the port and gives the Q-values flax gives after the JAX
    package's own reader converts it."""
    ref = {f'module.{k}': torch.as_tensor(np.array(v))
           for k, v in dqn_params_to_torch(flax_params(4), HW).items()}
    path = tmp_path / 'shared_model_best.pth'
    torch.save(ref, path)
    net = DQN(HW, 8, 3, device='cpu')
    net.load_state_dict(load_reference_checkpoint(str(path)))
    for k, v in dqn_from_reference(ref).items():
        assert torch.equal(net.state_dict()[k], v)
    obs = one_hot_obs(np.random.default_rng(4), 6)
    with torch.no_grad():
        q = net(torch.as_tensor(obs)).numpy()
    fparams = dqn_params_from_torch(ref, HW, in_channels=8)
    np.testing.assert_allclose(
        q, np.asarray(FlaxDQN(num_actions=3).apply(fparams, obs)),
        rtol=0, atol=1e-4)


def test_greedy_acting_matches_jax_argmax():
    params = flax_params(5)
    net = port_dqn(params, assume_binary_obs=True)
    rng = np.random.default_rng(5)
    e, n = 16, 3
    obs = one_hot_obs(rng, e * n).reshape((e, n) + HW + (8,))
    dones = rng.random((e, n)) < 0.25
    qj = np.asarray(FlaxDQN(num_actions=3).apply(
        params, obs.reshape((e * n,) + HW + (8,)))).reshape(e, n, 3)
    want = np.where(dones, 0, qj.argmax(-1))
    gen = torch.Generator().manual_seed(0)
    got = select_actions(net, torch.as_tensor(obs), torch.as_tensor(dones),
                         0.0, gen, 3)
    assert got.dtype == torch.int32 and got.shape == (e, n)
    top2 = np.sort(qj, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])


def test_exploring_acting_stays_in_range_and_dead_agents_act_zero():
    cfg = EnvConfig(height=10, width=10, num_snakes=2)
    net = make_dqn(cfg, seed=0, device='cpu')
    obs = torch.as_tensor(one_hot_obs(np.random.default_rng(6), 20)
                          ).view(10, 2, 10, 10, 8)
    dones = torch.zeros(10, 2, dtype=torch.bool)
    dones[:, 1] = True
    acts = select_actions(net, obs, dones, 1.0,
                          torch.Generator().manual_seed(1), 3)
    assert int(acts.min()) >= 0 and int(acts.max()) < 3
    assert bool((acts[:, 1] == 0).all())
    assert len(set(acts[:, 0].tolist())) > 1


def test_make_dqn_is_seeded():
    cfg = EnvConfig(height=10, width=10, num_snakes=2)
    a = make_dqn(cfg, seed=3, device='cpu').state_dict()
    b = make_dqn(cfg, seed=3, device='cpu').state_dict()
    c = make_dqn(cfg, seed=4, device='cpu').state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['fc1.weight'], c['fc1.weight'])
    assert a['fc1.weight'].shape == (256, 64 * 10 * 10)


# --- the PPO ActorCritic -----------------------------------------------------

def flax_actor_critic(seed, hw, channels=8):
    from marlsnake_tpu.models.ppo import ActorCritic as FlaxAC
    return FlaxAC(num_actions=3).init(
        jax.random.key(seed), jnp.zeros((1,) + hw + (channels,), jnp.float32))


@pytest.mark.parametrize('hw,channels,feats', [
    ((8, 8), 8, 128), ((10, 10), 16, 128), ((20, 20), 8, 128),
    ((11, 11), 8, 128), ((6, 6), 8, 32), ((20, 12), 8, 128)],
    ids=['8x8', '10x10-stack2', '20x20', 'vision-11x11', '6x6-pool-1x1',
         '20x12'])
def test_actor_critic_matches_flax(hw, channels, feats):
    """Logits, value and features of the same weights: float32 within
    1e-5; the weights go flax -> torch -> flax unchanged."""
    from marlsnake_tpu.models.ppo import ActorCritic as FlaxAC
    from marlsnake_torch.models.ppo import ActorCritic, feature_size
    from marlsnake_torch.models.weights import (actor_critic_from_flax,
                                                actor_critic_to_flax)
    params = flax_actor_critic(2, hw, channels)
    net = ActorCritic(hw, channels, 3, assume_binary_obs=True, device='cpu')
    net.load_state_dict(actor_critic_from_flax(params))
    assert feature_size(hw) == feats == net.actor_fc1.in_features
    obs = (np.random.default_rng(2).random((12,) + hw + (channels,)) < 0.2
           ).astype(np.uint8)
    fnet = FlaxAC(num_actions=3, assume_binary_obs=True)
    want_logits, want_value = fnet.apply(params, obs)
    with torch.no_grad():
        logits, value = net(torch.as_tensor(obs))
        f = net.features(torch.as_tensor(obs))
    assert logits.dtype == value.dtype == torch.float32
    assert logits.shape == (12, 3) and value.shape == (12,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        f.numpy(), np.asarray(fnet.apply(params, obs,
                                         method=FlaxAC.features)),
        rtol=0, atol=1e-5)
    back = actor_critic_to_flax(net.state_dict())['params']
    for layer, leaves in params['params'].items():
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(back[layer][name],
                                          np.asarray(leaf))


def test_actor_critic_scaling_bfloat16_and_make():
    """Byte inputs are scaled like flax's; bfloat16 is close to float32
    and to flax's bfloat16; make_actor_critic sizes the net by the config
    and is seeded."""
    from marlsnake_tpu.models.ppo import ActorCritic as FlaxAC
    from marlsnake_torch.models.ppo import ActorCritic, make_actor_critic
    from marlsnake_torch.models.weights import actor_critic_from_flax
    hw = (10, 10)
    params = flax_actor_critic(3, hw)
    rng = np.random.default_rng(3)
    obs = (rng.random((8,) + hw + (8,)) < 0.2).astype(np.uint8)
    wide = obs * np.uint8(255)
    nets = {}
    for dt in (torch.float32, torch.bfloat16):
        nets[dt] = ActorCritic(hw, 8, 3, device='cpu', compute_dtype=dt)
        nets[dt].load_state_dict(actor_critic_from_flax(params))
    with torch.no_grad():
        l32, v32 = nets[torch.float32](torch.as_tensor(wide))
        l16, v16 = nets[torch.bfloat16](torch.as_tensor(obs))
    jl, jv = FlaxAC(num_actions=3).apply(params, wide)
    np.testing.assert_allclose(l32.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(v32.numpy(), np.asarray(jv), atol=1e-5)
    assert l16.dtype == v16.dtype == torch.float32
    assert nets[torch.bfloat16].conv1.weight.dtype == torch.float32
    jl16, jv16 = FlaxAC(num_actions=3, compute_dtype=jnp.bfloat16,
                        assume_binary_obs=True).apply(params, obs)
    for got, want in ((l16, l32), (v16, v32), (l16, jl16), (v16, jv16)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=5e-2)
    cfg = EnvConfig(height=10, width=10, num_snakes=2, vision_range=3,
                    frame_stack=2, obs_format='packed')
    a = make_actor_critic(cfg, seed=1, device='cpu').state_dict()
    b = make_actor_critic(cfg, seed=1, device='cpu').state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a['conv1.weight'].shape == (32, 16, 3, 3)
    # a 7x7 window pools to 3x3, then 1x1: 32 features
    assert a['actor_fc1.weight'].shape == (256, 32)
    with pytest.raises(ValueError, match='4x4'):
        ActorCritic((3, 3), device='cpu')


def test_actor_critic_reference_checkpoint_reader():
    """A synthetic state_dict in the reference's PPO layout
    (``CNN_feature.0/.3``, ``actor.0/.2``, ``critic.0/.2``, DataParallel
    'module.' keys) loads into the port, and gives the outputs flax gives
    after the JAX package's own reader converts it."""
    from marlsnake_tpu.models.ppo import ActorCritic as FlaxAC
    from marlsnake_tpu.models.torch_interop import ppo_params_from_torch
    from marlsnake_torch.models.ppo import ActorCritic
    from marlsnake_torch.models.weights import actor_critic_from_reference
    hw = (20, 20)
    source = ActorCritic(hw, 8, 3, device='cpu').state_dict()
    names = {'conv1': 'CNN_feature.0', 'conv2': 'CNN_feature.3',
             'actor_fc1': 'actor.0', 'actor_fc2': 'actor.2',
             'critic_fc1': 'critic.0', 'critic_fc2': 'critic.2'}
    ref = {f'module.{names[k.split(".")[0]]}.{k.split(".")[1]}': v.clone()
           for k, v in source.items()}
    state = actor_critic_from_reference(ref)
    assert list(state) == list(source)
    assert all(torch.equal(state[k], source[k]) for k in source)
    net = ActorCritic(hw, 8, 3, device='cpu')
    net.load_state_dict(state)
    obs = (np.random.default_rng(9).random((5,) + hw + (8,)) < 0.2
           ).astype(np.uint8)
    with torch.no_grad():
        logits, value = net(torch.as_tensor(obs))
    want_logits, want_value = FlaxAC(num_actions=3).apply(
        ppo_params_from_torch(ref), obs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               rtol=0, atol=1e-5)


# --- fresh nets start from flax's initialisation -----------------------------

TRUNC_STD = 0.87962566103423978  # std of a normal truncated to [-2, 2]


def assert_lecun_normal(name, kernels, biases, fan_in):
    """Weights pooled over seeds: std within 5% of sqrt(1 / fan_in), none
    beyond two of the untruncated normal's standard deviations; biases
    exactly 0."""
    std = np.sqrt(1.0 / fan_in)
    w = np.concatenate([np.ravel(k) for k in kernels])
    assert abs(w.std() / std - 1) < 0.05, (name, w.std(), std)
    assert np.abs(w).max() <= 2 * std / TRUNC_STD * (1 + 1e-6), name
    assert all(not np.any(b) for b in biases), name


@pytest.mark.parametrize('kind', ['dqn', 'actor_critic'])
def test_fresh_nets_start_from_flax_init(kind):
    """make_dqn / make_actor_critic give every conv and linear layer
    flax's lecun-normal truncated weights and zero biases, as the JAX
    nets' ``init`` does (checked on both: 8 seeds pooled, so the smallest
    layer has 2,048 draws)."""
    from marlsnake_tpu.models.ppo import ActorCritic as FlaxAC
    from marlsnake_torch.models.ppo import make_actor_critic
    cfg = EnvConfig(height=8, width=8, num_snakes=2)
    make, flax_net = ((make_dqn, FlaxDQN(num_actions=3)) if kind == 'dqn'
                      else (make_actor_critic, FlaxAC(num_actions=3)))
    seeds = range(8)
    nets = [make(cfg, seed=s, device='cpu') for s in seeds]
    layers = [(n, m) for n, m in nets[0].named_modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    for name, m in layers:
        mods = [net.get_submodule(name) for net in nets]
        assert_lecun_normal(name, [x.weight.detach().numpy() for x in mods],
                            [x.bias.detach().numpy() for x in mods],
                            m.weight[0].numel())
    trees = [flax_net.init(jax.random.key(s),
                           jnp.zeros((1, 8, 8, 8), jnp.float32))['params']
             for s in seeds]
    assert sorted(trees[0]) == sorted(n for n, _ in layers)
    for name in trees[0]:
        kernels = [np.asarray(t[name]['kernel']) for t in trees]
        assert_lecun_normal(f'flax {name}', kernels,
                            [np.asarray(t[name]['bias']) for t in trees],
                            int(np.prod(kernels[0].shape[:-1])))


# --- the distilled acting trunk ----------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_distilled_dqn_matches_flax(dtype):
    """Random flax DistilledDQN parameters (flax's names and layouts:
    ``Conv_i`` (kh, kw, I, O), ``Dense_j`` (in, out), non-zero biases)
    carried over by ``distilled_dqn_from_flax``: Q-values within 1e-5 at
    float32 and within 2e-2 at bfloat16 (a few bfloat16 ulps at |q| < 1:
    each package rounds its layers' outputs in its own places), float32
    out; byte inputs scaled like flax's; a narrower net maps too."""
    from marlsnake_tpu.models.dqn import DistilledDQN as FlaxDistilled
    from marlsnake_torch.models.dqn import DistilledDQN
    from marlsnake_torch.models.weights import distilled_dqn_from_flax
    hw = (10, 12)
    rng = np.random.default_rng(4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    atol = 1e-5 if dtype == 'float32' else 2e-2
    for convs, fcs, binary in (((16, 32), (64,), True),
                               ((8,), (32, 16), False)):
        shapes = {}
        chans = (8,) + convs
        for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
            shapes[f'Conv_{i}'] = (3, 3, a, b)
        feats = (chans[-1] * hw[0] * hw[1],) + fcs + (3,)
        for j, (a, b) in enumerate(zip(feats[:-1], feats[1:])):
            shapes[f'Dense_{j}'] = (a, b)
        params = {'params': {
            name: {'kernel': (rng.normal(size=shape)
                              / np.sqrt(np.prod(shape[:-1]))
                              ).astype(np.float32),
                   'bias': (rng.normal(size=shape[-1:]) * 0.3
                            ).astype(np.float32)}
            for name, shape in shapes.items()}}
        flax_net = FlaxDistilled(conv_channels=convs, fc_features=fcs,
                                 compute_dtype=jdt, assume_binary_obs=binary)
        net = DistilledDQN(hw, conv_channels=convs, fc_features=fcs,
                           compute_dtype=tdt, assume_binary_obs=binary,
                           device='cpu')
        net.load_state_dict(distilled_dqn_from_flax(params))
        assert net.convs[0].weight.dtype == torch.float32
        obs = one_hot_obs(rng, 16, hw)
        if not binary:
            obs = obs * 255
        with torch.no_grad():
            q = net(torch.as_tensor(obs))
        want = np.asarray(jax.jit(flax_net.apply)(params, obs))
        assert q.dtype == torch.float32 and q.shape == (16, 3)
        np.testing.assert_allclose(q.numpy(), want, rtol=0, atol=atol)
