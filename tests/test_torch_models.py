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
