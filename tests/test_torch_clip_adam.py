"""The learners' optimizer step: gradient clipping by global norm and Adam
over every leaf (``ops/clip_adam.py``, ``csrc/clip_adam.cu``, and
``algo/optim.py`` above them).

On the CPU:

- the plain version with ``can_update`` False leaves the parameters,
  moments and count as they were, given fresh outputs or in place; with
  True, and without the flag, it equals the optimizer as the port
  computed it before the kernel (``_step_before``: clip, Adam, add, each
  a chain of PyTorch passes), bit for bit, with the clip active and not;
- in place it writes those numbers into the tensors it was given;
- a norm handed in is the norm the clip divides by;
- the wrapper takes the plain version for CPU tensors and raises on a
  leaf that is not float32, not contiguous or on another device, on a
  count or flag of the wrong type, and on lists of unequal lengths;
- ``optim.clip_adam`` on the CPU gives the plain version's numbers;
- the wrapper's constants and the launcher's arguments match the CUDA
  source.

On the card (marker ``cuda``; skipped without one; run with
``python -m pytest -p no:cacheprovider --noconftest -m cuda -s
tests/test_torch_clip_adam.py``): the kernel pair against the plain
version on the card at the DQN's 12 leaves (6,644,899 parameters), the
ActorCritic's, and 211 leaves of sizes 1, 3 and odd lengths (five launches
of each kernel), some at addresses off 16 bytes; with the clip active and
not, with the flag 0 and 1, in place and into fresh outputs. Handed the
same norm, the kernel's parameters and moments equal the plain version's
bit for bit; with the norm its own, they differ by what the norm's
rounding moves (the largest gap is printed in ulps). Replayed in a
captured graph the kernel gives what it gives uncaptured, and its
launches are counted, two a DQN chunk step and two a PPO minibatch.
"""

import re

import pytest
import torch

from marlsnake_torch.algo import optim
from marlsnake_torch.ops import clip_adam as CA
from marlsnake_torch.ops import cuda_build

LR, B1, B2 = 5e-4, 0.9, 0.999


def _step_before(params, grads, mu, nu, count, lr, max_norm, eps):
    """The optimizer step as ``algo/optim.py`` computed it before the
    kernel: the global norm, the clip, Adam and the add, in PyTorch
    passes."""
    squares = torch._foreach_mul(grads, grads)
    norm = torch.stack([s.sum() for s in squares]).sum().sqrt()
    scaled = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    below = norm < max_norm
    grads = [torch.where(below, g, s) for g, s in zip(grads, scaled)]
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    mu = add(mul(grads, 1 - B1), mul(mu, B1))
    nu = add(mul(mul(grads, grads), 1 - B2), mul(nu, B2))
    count = count + 1
    mu_hat = div(mu, 1 - B1 ** count)
    nu_hat = div(nu, 1 - B2 ** count)
    updates = div(mu_hat, add(torch._foreach_sqrt(nu_hat), eps))
    updates = mul(updates, -lr)
    return list(torch._foreach_add(params, updates)), list(mu), list(nu), count


def _leaves(shapes, seed, scale=1.0, device='cpu', count=3):
    """(params, grads, mu, nu, count) of random numbers: moments as a few
    steps of Adam would leave them."""
    g = torch.Generator().manual_seed(seed)

    def rand(shape, s=1.0):
        return (torch.randn(shape, generator=g) * s).to(device)

    params = [rand(s) for s in shapes]
    grads = [rand(s, scale) for s in shapes]
    mu = [rand(s, 0.01) for s in shapes]
    nu = [rand(s, 1e-3).square() for s in shapes]
    return params, grads, mu, nu, torch.tensor(count, dtype=torch.int32,
                                               device=device)


def _clone(step):
    params, grads, mu, nu, count = step
    return ([p.clone() for p in params], [g.clone() for g in grads],
            [m.clone() for m in mu], [v.clone() for v in nu], count.clone())


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


SMALL = [(8, 3, 3), (8,), (5, 7), (1,), (3,), (129,)]
# the global norm of unit normals over SMALL is ~20: a max_norm of 1
# clips, of 1,000 does not
CLIP = {'clipped': 1.0, 'unclipped': 1000.0}


@pytest.mark.parametrize('eps', [1e-8, 1e-5])
@pytest.mark.parametrize('clip', list(CLIP))
@pytest.mark.parametrize('flag', [None, True])
def test_plain_equals_the_step_before_bit_for_bit(clip, flag, eps):
    params, grads, mu, nu, count = _leaves(SMALL, seed=1)
    want = _step_before(params, grads, mu, nu, count, LR, CLIP[clip], eps)
    got = CA.clip_adam_plain(
        params, grads, mu, nu, count, lr=LR, max_norm=CLIP[clip], eps=eps,
        can_update=None if flag is None else torch.tensor(flag))
    for a, b in zip(got[:3], want[:3]):
        assert _equal(a, b)
    assert got[3].dtype == torch.int32 and int(got[3]) == int(count) + 1


@pytest.mark.parametrize('in_place', [False, True])
def test_plain_with_the_flag_off_keeps_everything(in_place):
    step = _leaves(SMALL, seed=2)
    held = _clone(step)
    params, grads, mu, nu, count = step
    got = CA.clip_adam_plain(params, grads, mu, nu, count, lr=LR,
                             max_norm=1.0, can_update=torch.tensor(False),
                             in_place=in_place)
    for a, b in zip(got[:3], (held[0], held[2], held[3])):
        assert _equal(a, b)
    assert int(got[3]) == int(held[4])
    for a, b in zip((params, mu, nu), (held[0], held[2], held[3])):
        assert _equal(a, b)


@pytest.mark.parametrize('clip', list(CLIP))
def test_plain_in_place_writes_the_fresh_numbers_into_its_inputs(clip):
    step = _leaves(SMALL, seed=3)
    want = CA.clip_adam_plain(*_clone(step)[:4], step[4].clone(), lr=LR,
                              max_norm=CLIP[clip])
    params, grads, mu, nu, count = step
    got = CA.clip_adam_plain(params, grads, mu, nu, count, lr=LR,
                             max_norm=CLIP[clip], in_place=True)
    assert all(a is b for a, b in zip(got[0], params))
    assert all(a is b for a, b in zip(got[1], mu))
    assert got[3] is count
    for a, b in zip((params, mu, nu), want[:3]):
        assert _equal(a, b)
    assert int(count) == int(want[3])


def test_a_norm_handed_in_is_the_one_the_clip_divides_by():
    params, grads, mu, nu, count = _leaves(SMALL, seed=4)
    norm = torch.tensor(2.5)
    got = CA.clip_adam_plain(params, grads, mu, nu, count, lr=LR,
                             max_norm=1.0, norm=norm)
    want = CA.clip_adam_plain(params, [g / 2.5 for g in grads], mu, nu,
                              count, lr=LR, max_norm=1e9)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    kept = CA.clip_adam_plain(params, grads, mu, nu, count, lr=LR,
                              max_norm=3.0, norm=norm)
    plain = _step_before(params, grads, mu, nu, count, LR, 1e9, 1e-8)
    for a, b in zip(kept[:3], plain[:3]):
        assert _equal(a, b)


@pytest.mark.parametrize('flag', [None, False, True])
@pytest.mark.parametrize('in_place', [False, True])
def test_optim_clip_adam_on_the_cpu_is_the_plain_version(flag, in_place):
    step = _leaves(SMALL, seed=5)
    can = None if flag is None else torch.tensor(flag)
    want = CA.clip_adam_plain(*_clone(step), lr=LR, max_norm=1.0,
                              can_update=can)
    params, grads, mu, nu, count = step
    state = optim.AdamState(count, mu, nu)
    new, st = optim.clip_adam(params, grads, state, LR, 1.0, can_update=can,
                              in_place=in_place)
    for a, b in zip((new, st.mu, st.nu), want[:3]):
        assert _equal(a, b)
    assert int(st.count) == int(want[3])
    assert all(a is b for a, b in zip(new, params)) == in_place
    assert (st.count is count) == in_place


def test_the_wrapper_takes_the_plain_version_for_cpu_tensors():
    step = _leaves(SMALL, seed=6)
    launches = CA.clip_adam.launches
    got = CA.clip_adam(*_clone(step), lr=LR, max_norm=1.0)
    want = CA.clip_adam_plain(*step, lr=LR, max_norm=1.0)
    for a, b in zip(got[:3], want[:3]):
        assert _equal(a, b)
    assert CA.clip_adam.launches == launches


def _bad(kind):
    params, grads, mu, nu, count = _leaves(SMALL, seed=7)
    kw = {}
    if kind == 'float64':
        grads[1] = grads[1].double()
    elif kind == 'bfloat16-param':
        params[0] = params[0].bfloat16()
    elif kind == 'strided':
        grads[0] = torch.randn(8, 3, 3, 8).permute(3, 0, 1, 2)
    elif kind == 'strided-mu':
        mu[0] = torch.empty_strided((8, 3, 3), (1, 24, 8))
    elif kind == 'other-device':
        nu[2] = torch.empty(nu[2].shape, device='meta')
    elif kind == 'shape':
        grads[2] = grads[2].reshape(-1)
    elif kind == 'unequal':
        grads = grads[:-1]
    elif kind == 'empty':
        params, grads, mu, nu = [], [], [], []
    elif kind == 'count-int64':
        count = count.long()
    elif kind == 'flag-float':
        kw['can_update'] = torch.tensor(1.0)
    elif kind == 'flag-other-device':
        kw['can_update'] = torch.empty((), dtype=torch.bool, device='meta')
    return (params, grads, mu, nu, count), kw


@pytest.mark.parametrize('kind,error,match', [
    ('float64', TypeError, 'float32'),
    ('bfloat16-param', TypeError, 'float32'),
    ('strided', ValueError, 'contiguous'),
    ('strided-mu', ValueError, 'contiguous'),
    ('other-device', ValueError, 'meta'),
    ('shape', ValueError, 'shape'),
    ('unequal', ValueError, 'length'),
    ('empty', ValueError, 'length'),
    ('count-int64', TypeError, 'count'),
    ('flag-float', TypeError, 'can_update'),
    ('flag-other-device', ValueError, 'can_update')])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(kind, error,
                                                            match):
    args, kw = _bad(kind)
    with pytest.raises(error, match=match):
        CA.clip_adam(*args, lr=LR, max_norm=1.0, **kw)


def _source() -> str:
    with open(CA.SOURCE) as fp:
        return fp.read()


def test_source_constants_match_the_wrapper():
    src = _source()
    for name, value in (('THREADS', CA.THREADS), ('MAX_LEAVES', CA.MAX_LEAVES),
                        ('SUM_BLOCKS_PER_SM', CA.SUM_BLOCKS_PER_SM)):
        assert re.search(rf'constexpr int {name} = {value};', src), name
    assert re.search(r'constexpr int TILE = THREADS \* VEC;', src)
    assert re.search(r'constexpr int VEC = (\d+);', src).group(1) == str(
        CA.TILE // CA.THREADS)


def test_launcher_arguments_match_the_ctypes_signature(monkeypatch):
    """The C entry's parameters, in order, against the argtypes the wrapper
    sets (a pointer where C takes one, an int, a float)."""
    src = _source()
    sig = re.search(r'extern "C" int marlsnake_clip_adam\((.*?)\)\s*\{',
                    src, re.S).group(1)
    kinds = []
    for param in sig.split(','):
        param = param.strip()
        kinds.append('p' if '*' in param else
                     'f' if param.startswith('float') else 'i')

    class Lib:
        class Fn:
            pass
        marlsnake_clip_adam = Fn()
        marlsnake_clip_adam_error_string = Fn()

    monkeypatch.setattr(cuda_build, 'build', lambda *s: [('lib.so', '')])
    monkeypatch.setattr(CA.ctypes, 'CDLL', lambda path: Lib())
    CA.load_library.cache_clear()
    try:
        lib = CA.load_library()
    finally:
        CA.load_library.cache_clear()
    names = {CA.ctypes.c_void_p: 'p', CA.ctypes.c_int: 'i',
             CA.ctypes.c_float: 'f'}
    got = [names.get(t, 'p') for t in lib.marlsnake_clip_adam.argtypes]
    assert got == kinds


@pytest.mark.parametrize('n,launches', [(1, 1), (12, 1), (48, 1), (49, 2),
                                        (211, 5)])
def test_chunks_hold_at_most_one_argument_block_of_leaves(n, launches):
    assert CA.chunks(n) == launches


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the clip-Adam kernels run only there')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _dqn_shapes():
    from marlsnake_torch.core.types import EnvConfig
    from marlsnake_torch.models.dqn import make_dqn
    net = make_dqn(EnvConfig(height=20, width=20, num_snakes=4), 0, 'cpu')
    return [tuple(v.shape) for v in net.state_dict().values()]


def _actor_critic_shapes():
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    tr = PPOTrainer(PPOConfig(num_envs=2, rollout_steps=2), device='cpu')
    return [tuple(v.shape) for v in tr.init_state().params.values()]


def _many_shapes():
    """211 leaves: sizes 1 and 3, odd lengths, a few of thousands."""
    sizes = [1, 3] + [2 * k + 1 for k in range(1, 200)] + [
        4097, 1023, 1025, 99_999, 7, 5, 1, 3, 2048, 12_345]
    return [(s,) for s in sizes]


SETS = {'dqn': (_dqn_shapes, {'clipped': 1.0, 'unclipped': 1e-4}),
        'actor_critic': (_actor_critic_shapes,
                         {'clipped': 1.0, 'unclipped': 1e-3}),
        'many': (_many_shapes, {'clipped': 1.0, 'unclipped': 1e-3})}


def _ordered(x):
    """float32 bits as integers in the floats' order, for gaps in ulps."""
    i = x.view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def _ulps(a, b):
    return max(int((_ordered(x) - _ordered(y)).abs().max())
               for x, y in zip(a, b))


def _off_16_bytes(step):
    """The same leaves, each at an address 4 bytes past a 16-byte one."""
    out = []
    for xs in step[:4]:
        moved = []
        for x in xs:
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            view = buf[1:].view(x.shape)
            view.copy_(x)
            moved.append(view)
        out.append(moved)
    return (*out, step[4])


@pytest.mark.cuda
@pytest.mark.parametrize('in_place', [False, True], ids=['fresh', 'in-place'])
@pytest.mark.parametrize('flag', [None, 0, 1])
@pytest.mark.parametrize('clip', ['clipped', 'unclipped'])
@pytest.mark.parametrize('leaves', list(SETS))
def test_card_kernel_against_the_plain_version(card, leaves, clip, flag,
                                                in_place):
    shapes, scales = SETS[leaves]
    step = _leaves(shapes(), seed=11, scale=scales[clip], device=card)
    if leaves == 'many':
        step = _off_16_bytes(step)
    can = None if flag is None else torch.tensor(bool(flag), device=card)
    max_norm = 10.0
    norm = CA.global_norm(step[1])
    assert bool(norm < max_norm) == (clip == 'unclipped'), float(norm)
    held = _clone(step)
    launches = CA.clip_adam.launches
    for given in (norm, None):
        mine = _clone(held) if given is None or not in_place else step
        got = CA.clip_adam(*mine, lr=LR, max_norm=max_norm,
                           can_update=can, norm=given, in_place=in_place)
        want = CA.clip_adam_plain(*_clone(held), lr=LR, max_norm=max_norm,
                                  can_update=can, norm=given)
        torch.cuda.synchronize()
        if in_place:
            assert all(a is b for a, b in zip(got[0], mine[0]))
            assert got[3] is mine[4]
        assert int(got[3]) == int(want[3])
        if given is not None or flag == 0:
            for a, b in zip(got[:3], want[:3]):
                assert _equal(a, b)
        else:
            gaps = [_ulps(a, b) for a, b in zip(got[:3], want[:3])]
            print(f'\nULPS {leaves} {clip} flag={flag} {in_place=}: params '
                  f'{gaps[0]} mu {gaps[1]} nu {gaps[2]}')
            for a, b in zip(got[:3], want[:3]):
                for x, y in zip(a, b):
                    torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)
    chunks = CA.chunks(len(step[0]))
    assert CA.clip_adam.launches - launches == 2 * 2 * chunks


@pytest.mark.cuda
def test_card_kernel_is_deterministic_and_equal_under_graph_replay(card):
    from marlsnake_torch.utils.cuda_graph import CapturedLoop
    step = _leaves(_many_shapes() + _dqn_shapes(), seed=12, device=card)
    twin = _clone(step)
    flag = torch.tensor(True, device=card)
    flags = [True, False, True, True]

    def body():
        CA.clip_adam(*step, lr=LR, max_norm=10.0, can_update=flag,
                     in_place=True)

    loop = CapturedLoop(body, card)
    launches = CA.clip_adam.launches
    for f in flags:
        flag.fill_(f)
        loop()
        CA.clip_adam(*twin, lr=LR, max_norm=10.0,
                     can_update=torch.tensor(f, device=card), in_place=True)
    torch.cuda.synchronize()
    for a, b in zip(step, twin):
        assert _equal(a, b) if isinstance(a, list) else torch.equal(a, b)
    assert int(step[4]) == int(twin[4]) == 3 + sum(flags)
    chunks = CA.chunks(len(step[0]))
    # the first call runs the body once and captures it; each later one
    # replays the graph, whose launches are counted as they run
    assert loop.tally.by_name() == {'clip_adam': 2 * chunks}
    assert CA.clip_adam.launches - launches == 2 * 2 * chunks * len(flags)


@pytest.mark.cuda
def test_card_dqn_chunk_launches_the_pair_each_step(card):
    from marlsnake_torch.algo.dqn_trainer import DQNConfig, DQNTrainer
    tr = DQNTrainer(DQNConfig(height=8, width=8, num_snakes=2, num_envs=4,
                              batch_size=16, buffer_size=64,
                              min_buffer_size=16, max_steps_per_episode=16),
                    device=card)
    ts = tr.init_state()
    for _ in range(2):
        ts, m = tr.train_episode(ts)
    assert m.updates > 0
    (loop,) = tr.captured_loops()
    assert loop.tally.by_name()['clip_adam'] == 2 * tr.chunk_steps


@pytest.mark.cuda
def test_card_ppo_learn_launches_the_pair_each_minibatch(card):
    from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
    cfg = PPOConfig(height=8, width=8, num_snakes=2, snake_length=2,
                    num_envs=4, rollout_steps=8, num_minibatches=2,
                    update_epochs=3)
    tr = PPOTrainer(cfg, device=card)
    ts = tr.init_state()
    launches = CA.clip_adam.launches
    ts, _ = tr.update(ts)
    torch.cuda.synchronize()
    assert CA.clip_adam.launches - launches == 2 * 2 * 3
    assert int(ts.opt_state.count) == 6
