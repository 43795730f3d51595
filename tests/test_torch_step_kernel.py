"""The CUDA step kernel's launch path, on the CPU.

The kernel itself runs only on the card (chip_smoke.py holds it against
the plain version there). What surrounds it is plain Python and is
checked here: the argument struct's ctypes mirror against the C source,
the output arena's layout, the typed views cut from it, and the whole
launch path of both entries (with and without auto-reset) driven on CPU
tensors with a stand-in library that runs the plain version on the arenas
it is handed, and the hold that leaves finished envs still inside a step.
"""

import ctypes
import dataclasses
import pickle
import re

import numpy as np
import pytest
import torch

from marlsnake_torch.core import engine
from marlsnake_torch.core.state import EnvState
from marlsnake_torch.core.types import EnvConfig
from marlsnake_torch.ops import step_kernel
from marlsnake_torch.rng import StepDraws, reset_draws, step_draws

C_TYPES = {'int64_t': ctypes.c_int64, 'int': ctypes.c_int,
           'float': ctypes.c_float}


def _struct_fields(source: str):
    """(name, ctypes type) of every member of ``struct StepArgs``."""
    body = re.search(r'struct StepArgs \{(.*?)\n\};', source, re.S).group(1)
    body = re.sub(r'//[^\n]*', '', body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(';'))):
        m = re.fullmatch(r'(const\s+)?(\w+)\s*(\*?)\s*(\w+)', decl)
        assert m, decl
        ctype = ctypes.c_void_p if m.group(3) else C_TYPES[m.group(2)]
        fields.append((m.group(4), ctype))
    return fields


def test_struct_mirror_matches_the_cuda_source():
    with open(step_kernel.SOURCE) as fp:
        want = _struct_fields(fp.read())
    assert [(n, t) for n, t in step_kernel._StepArgs._fields_] == want
    offsets = [n for n, t in want if n.startswith('o_')]
    assert offsets == [f'o_{n}' for n in step_kernel.STATE_FIELDS
                       + step_kernel.OUTPUT_FIELDS]


# the options that add fields to the arena or change the obs' shape
HIST = dict(frame_stack=3, obs_format='packed', spawn_mode='procedural',
            spawn_orientations='both')
STACK = dict(vision_range=2, frame_stack=2)


@pytest.mark.parametrize('h,w,n,b,options', [
    (10, 10, 2, 7, {}), (20, 20, 4, 4096, {}), (11, 9, 3, 5, {}),
    (10, 10, 2, 7, HIST), (11, 9, 3, 5, STACK),
    (20, 20, 4, 4096, dict(vision_range=5, obs_format='packed'))],
    ids=['10-10-2-7', '20-20-4-4096', '11-9-3-5', 'hist', 'stack',
         'vision5-packed'])
def test_output_layout(h, w, n, b, options):
    cfg = EnvConfig(height=h, width=w, num_snakes=n, snake_length=3,
                    **options)
    fields, nbytes = step_kernel.output_layout(cfg, b)
    assert tuple(f.name for f in fields) == (step_kernel.STATE_FIELDS
                                             + step_kernel.OUTPUT_FIELDS)
    # every field has the plain version's dtype and shape (at a small B)
    small = dict(zip((f.name for f in fields),
                     step_kernel.output_layout(cfg, 3)[0]))
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(0)
    state, _ = engine.reset(cfg, tables, reset_draws(cfg, 3, gen, 'cpu'))
    new_state, out = engine.step_autoreset(
        cfg, tables, state, torch.zeros((3, n), dtype=torch.int32),
        step_draws(cfg, 3, gen, 'cpu'))
    for name, t in new_state.fields() + out.fields():
        assert (small[name].dtype, small[name].shape) == (t.dtype,
                                                          tuple(t.shape))
    # 16-byte aligned, in order, not overlapping, inside the arena
    end = 0
    for f in fields:
        size = int(np.prod(f.shape)) * f.dtype.itemsize
        assert f.offset % 16 == 0 and f.offset >= end
        end = f.offset + size
    assert end <= nbytes and nbytes % 16 == 0 and nbytes - end < 16
    by_name = {f.name: f for f in fields}
    assert by_name['obs'].shape == (b,) + cfg.obs_shape
    fs = cfg.frame_stack
    assert by_name['hist_grid'].shape == (
        b, fs - 1 if fs > 1 and not cfg.vision_range else 0, h, w)
    assert by_name['obs_stack'].shape[:2] == (
        b, fs if fs > 1 and cfg.vision_range else 0)


def test_field_views_cover_their_bytes():
    _field_views_cover_their_bytes({})


@pytest.mark.parametrize('options', [HIST, STACK], ids=['hist', 'stack'])
def test_field_views_cover_the_history_fields(options):
    _field_views_cover_their_bytes(options)


def _field_views_cover_their_bytes(options):
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3,
                    **options)
    fields, nbytes = step_kernel.output_layout(cfg, 5)
    arena = torch.zeros(nbytes, dtype=torch.uint8)
    for i, f in enumerate(fields):
        v = step_kernel.field_view(arena, f)
        assert v.dtype == f.dtype and tuple(v.shape) == f.shape
        assert v.is_contiguous()
        if v.numel():            # an empty view has no address
            assert v.data_ptr() == arena.data_ptr() + f.offset
        v.view(torch.uint8).fill_(i + 1)
    for i, f in enumerate(fields):
        size = int(np.prod(f.shape)) * f.dtype.itemsize
        assert bool((arena[f.offset:f.offset + size] == i + 1).all())


def _tensor_at(address: int, nbytes: int) -> torch.Tensor:
    buf = (ctypes.c_uint8 * nbytes).from_address(address)
    return torch.from_numpy(np.ctypeslib.as_array(buf))


class _PlainLibrary:
    """Stands in for the CUDA library: reads the struct the wrapper
    passes, runs the plain version on the state arena and the inputs it
    points at, and writes every output into the output arena."""

    def __init__(self):
        self.plan = None
        self.calls = 0

    def marlsnake_error_string(self, rc):
        return b'stand-in'

    def marlsnake_step_autoreset(self, args_ref, stream):
        return self._run(args_ref._obj, autoreset=True)

    def marlsnake_step(self, args_ref, stream):
        return self._run(args_ref._obj, autoreset=False)

    def _run(self, a, autoreset):
        plan = self.plan
        b, n, nf = a.B, a.N, a.NF
        fields = plan.fields
        src = _tensor_at(a.state, plan.nbytes if a.keep
                         else plan.state_nbytes)
        state = EnvState(*[step_kernel.field_view(src, f).clone()
                           for f in fields[:len(step_kernel.STATE_FIELDS)]])

        def typed(address, dtype, shape):
            if not np.prod(shape):
                return torch.zeros(shape, dtype=dtype)
            size = int(np.prod(shape)) * dtype.itemsize
            return _tensor_at(address, size).view(dtype).view(shape).clone()

        actions = typed(a.actions, torch.int32, (b, n))
        fruit_u = typed(a.fruit_u, torch.float32, (b, n))
        if autoreset:
            draws = StepDraws(fruit_u,
                              typed(a.reset_spawn_u, torch.float32,
                                    (b, n, 4) if a.procedural else (b,)),
                              typed(a.reset_fruit_u, torch.float32, (b, nf)))
            # the procedural spawn hands over no table
            assert bool(a.procedural) == (not a.pool_cells
                                          and not a.base_grid)
            spawn = None if a.procedural else engine.SpawnTables(
                typed(a.pool_cells, torch.int32,
                      tuple(plan.spawn.cells.shape)),
                typed(a.base_grid, torch.int32, (a.H, a.W)))
            new_state, out = engine.step_autoreset(plan.cfg, spawn, state,
                                                   actions, draws)
        else:
            # the entry without auto-reset reads no reset input
            new_state, out = engine.step(plan.cfg, state, actions, fruit_u)
        dst = _tensor_at(a.out, plan.nbytes)
        for f, (_, t) in zip(fields, new_state.fields() + out.fields()):
            step_kernel.field_view(dst, f).copy_(t)
        if a.keep:
            # held envs: every field's row comes from the input arena
            assert not autoreset
            keep = typed(a.keep, torch.bool, (b,))
            for f in fields:
                step_kernel.field_view(dst, f)[keep] = \
                    step_kernel.field_view(src, f)[keep]
        self.calls += 1
        return 0


@pytest.fixture
def plain_library(monkeypatch):
    """The CUDA launch path on CPU tensors, with the stand-in library."""
    lib = _PlainLibrary()
    monkeypatch.setattr(step_kernel, 'load_library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: -1)
    monkeypatch.setattr(torch._C, '_cuda_getCurrentRawStream', lambda i: 0,
                        raising=False)
    init = step_kernel._LaunchPlan.__init__

    def cpu_plan(self, cfg, num_envs, device):
        init(self, cfg, num_envs, device)
        self.index = -1   # what get_device() says of a CPU tensor
        lib.plan = self

    monkeypatch.setattr(step_kernel._LaunchPlan, '__init__', cpu_plan)
    step_kernel._plan.cache_clear()
    yield lib
    step_kernel._plan.cache_clear()


@pytest.mark.parametrize('kwargs', [
    dict(height=10, width=10, num_snakes=2, snake_length=3),
    dict(height=11, width=9, num_snakes=3, snake_length=3,
         done_mode='any', max_episode_steps=7),
    dict(height=10, width=10, num_snakes=2, snake_length=3,
         max_episode_steps=9, **HIST),
    dict(height=11, width=9, num_snakes=3, snake_length=3,
         max_episode_steps=7, **STACK)],
    ids=['10x10x2', '11x9x3', 'hist-packed-procedural', 'vision-stack'])
def test_launch_path_feeds_its_arenas_back(plain_library, kwargs):
    """A reset state is packed into an arena once; each returned state
    then goes back as its arena, and every output equals the plain
    version's, step after step."""
    cfg = EnvConfig(**kwargs)
    b, n = 6, cfg.num_snakes
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(n)
    want_state, _ = engine.reset(cfg, tables, reset_draws(cfg, b, gen, 'cpu'))
    plan = step_kernel._plan(cfg, b, torch.device('cpu'))
    state, resets = None, 0
    before = step_kernel.step_autoreset.launches
    for t in range(16):
        actions = torch.randint(0, 3, (b, n), generator=gen)  # int64
        draws = step_draws(cfg, b, gen, 'cpu')
        want = engine.step_autoreset(cfg, tables, want_state, actions, draws)
        if state is None:
            got = plan.launch(plan.pack(want_state), tables, actions, draws)
        else:
            assert state._plan is plan
            got = step_kernel.step_autoreset(cfg, tables, state, actions,
                                             draws)
        for g, w in zip(got, want):
            for (name, a), (_, e) in zip(g.fields(), w.fields()):
                assert a.dtype == e.dtype and a.shape == e.shape, name
                assert torch.equal(a, e), (t, name)
        state, want_state = got[0], want[0]
        resets += int(got[1].done_all.sum())
    assert resets > 0
    assert plain_library.calls == 16
    assert step_kernel.step_autoreset.launches - before == 16


def test_launch_path_checks_its_inputs(plain_library):
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3)
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(0)
    state, _ = engine.reset(cfg, tables, reset_draws(cfg, 4, gen, 'cpu'))
    plan = step_kernel._plan(cfg, 4, torch.device('cpu'))
    arena = plan.pack(state)
    actions = torch.zeros((4, 2), dtype=torch.int32)
    draws = step_draws(cfg, 4, gen, 'cpu')
    bad = [
        (actions[:3], draws),
        (torch.zeros((2, 4), dtype=torch.int32).t(), draws),
        (actions, draws._replace(fruit_u=draws.fruit_u.double())),
        (actions, draws._replace(reset_spawn_u=draws.reset_spawn_u[:2])),
    ]
    for a, d in bad:
        with pytest.raises(ValueError):
            plan.launch(arena, tables, a, d)
    with pytest.raises(ValueError):
        plan.pack(state.replace(grid=state.grid.double()))
    assert plain_library.calls == 0


def test_carved_outputs_are_lazy_frozen_and_plain_when_copied(
        plain_library):
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3)
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(1)
    state, _ = engine.reset(cfg, tables, reset_draws(cfg, 4, gen, 'cpu'))
    plan = step_kernel._plan(cfg, 4, torch.device('cpu'))
    new_state, out = plan.launch(plan.pack(state), tables,
                                 torch.zeros((4, 2), dtype=torch.int32),
                                 step_draws(cfg, 4, gen, 'cpu'))
    assert 'reward' not in out.__dict__
    assert out.reward.data_ptr() == (out._arena.data_ptr()
                                     + plan.by_name['reward'].offset)
    assert out.reward is out.reward and 'reward' in out.__dict__
    with pytest.raises(AttributeError):
        new_state.no_such_field
    with pytest.raises(dataclasses.FrozenInstanceError):
        new_state.grid = None
    copied = pickle.loads(pickle.dumps(new_state))
    assert type(copied) is EnvState and not hasattr(copied, '_plan')
    for (name, a), (_, b) in zip(copied.fields(), new_state.fields()):
        assert torch.equal(a, b), name
    assert getattr(new_state.replace(grid=new_state.grid.clone()),
                   '_plan', None) is None


# --- the entry without auto-reset -------------------------------------------

def _assert_pairs_equal(got, want, where):
    for g, w in zip(got, want):
        for (name, a), (_, e) in zip(g.fields(), w.fields()):
            assert a.dtype == e.dtype and a.shape == e.shape, (where, name)
            assert torch.equal(a, e), (where, name)


@pytest.mark.parametrize('kwargs', [
    dict(height=8, width=8, num_snakes=2, snake_length=3),
    dict(height=11, width=9, num_snakes=3, snake_length=3,
         done_mode='any', max_episode_steps=7),
    dict(height=8, width=8, num_snakes=2, snake_length=3, **HIST),
    dict(height=11, width=9, num_snakes=3, snake_length=3,
         max_episode_steps=7, **STACK)],
    ids=['8x8x2', '11x9x3', 'hist-packed-procedural', 'vision-stack'])
def test_step_launch_path_feeds_its_arenas_back(plain_library, kwargs):
    """``step`` packs a reset state once, then takes its own arenas back;
    finished envs go on being stepped, and every field equals
    ``engine.step``'s, step after step. No reset input is set."""
    cfg = EnvConfig(**kwargs)
    b, n = 6, cfg.num_snakes
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(n)
    want_state, _ = engine.reset(cfg, tables, reset_draws(cfg, b, gen, 'cpu'))
    plan = step_kernel._plan(cfg, b, torch.device('cpu'))
    state = want_state
    before = (step_kernel.step.launches, step_kernel.step_autoreset.launches)
    after_done = 0
    for t in range(40):
        actions = torch.randint(0, 3, (b, n), generator=gen)  # int64
        fruit_u = torch.rand((b, n), generator=gen)
        want = engine.step(cfg, want_state, actions, fruit_u)
        if t == 0:
            got = plan.launch_step(plan.pack(state), actions, fruit_u)
        else:
            assert state._plan is plan
            got = step_kernel.step(cfg, state, actions, fruit_u)
        _assert_pairs_equal(got, want, t)
        after_done += int((~want_state.alive.any(1)).sum())
        state, want_state = got[0], want[0]
    assert after_done > 0, 'no finished env was stepped again'
    assert plain_library.calls == 40
    assert step_kernel.step.launches - before[0] == 40
    assert step_kernel.step_autoreset.launches == before[1]
    assert not plan.args.reset_spawn_u and not plan.args.pool_cells
    with pytest.raises(ValueError):
        plan.launch_step(state._arena, actions, fruit_u[:3])


def test_step_on_cpu_tensors_is_the_plain_version():
    cfg = EnvConfig(height=10, width=10, num_snakes=2, snake_length=3)
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(4)
    state, _ = engine.reset(cfg, tables, reset_draws(cfg, 5, gen, 'cpu'))
    from marlsnake_torch.envs.vector import build_vector_fns
    _, step_fn = build_vector_fns(cfg, autoreset=False, device='cpu')
    before = step_kernel.step.launches
    for t in range(6):
        actions = torch.randint(0, 3, (5, 2), generator=gen)
        draws = step_draws(cfg, 5, gen, 'cpu')
        want = engine.step(cfg, state, actions, draws.fruit_u)
        _assert_pairs_equal(step_kernel.step(cfg, state, actions,
                                             draws.fruit_u), want, t)
        _assert_pairs_equal(step_fn(state, actions, draws), want, t)
        state = want[0]
    assert type(state) is EnvState
    assert step_kernel.step.launches == before


def test_select_envs_takes_kept_envs_from_the_older_pair():
    cfg = EnvConfig(height=8, width=8, num_snakes=2, snake_length=3)
    b = 6
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(5)
    state, _ = engine.reset(cfg, tables, reset_draws(cfg, b, gen, 'cpu'))
    pairs = []
    for _ in range(2):
        actions = torch.randint(0, 3, (b, 2), generator=gen)
        pairs.append(engine.step(cfg, state, actions,
                                 torch.rand((b, 2), generator=gen)))
        state = pairs[-1][0]
    keep = torch.tensor([True, False, False, True, False, True])
    got = step_kernel.select_envs(keep, *pairs)
    assert type(got[0]) is EnvState and type(got[1]) is engine.StepOutput
    for (name, a), (_, o), (_, n_) in zip(
            got[0].fields() + got[1].fields(),
            pairs[0][0].fields() + pairs[0][1].fields(),
            pairs[1][0].fields() + pairs[1][1].fields()):
        assert torch.equal(a[keep], o[keep]), name
        assert torch.equal(a[~keep], n_[~keep]), name


@pytest.mark.parametrize('kwargs', [
    dict(height=8, width=8, num_snakes=2, snake_length=3),
    dict(height=11, width=9, num_snakes=3, snake_length=3,
         done_mode='any', max_episode_steps=7),
    dict(height=8, width=8, num_snakes=2, snake_length=3, **HIST),
    dict(height=11, width=9, num_snakes=3, snake_length=3,
         max_episode_steps=7, **STACK)],
    ids=['8x8x2', '11x9x3', 'hist-packed-procedural', 'vision-stack'])
def test_step_holds_finished_envs_inside_the_launch(plain_library, kwargs):
    """Envs whose episode is over are held from the next step on, as the
    DQN trainer holds them: through the launch path the held rows come
    from the arena of the step before, with no launch besides the step's,
    the returned state is still the kernel's own, and every field equals
    the plain version's (``engine.step``, then ``select_envs``)."""
    cfg = EnvConfig(**kwargs)
    b, n = 6, cfg.num_snakes
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(7 + n)
    want_state, _ = engine.reset(cfg, tables, reset_draws(cfg, b, gen, 'cpu'))
    plan = step_kernel._plan(cfg, b, torch.device('cpu'))
    state, want_out, out = want_state, None, None
    frozen = torch.zeros(b, dtype=torch.bool)
    before, held_steps, mixed = step_kernel.step.launches, 0, 0
    for t in range(40):
        actions = torch.randint(0, 3, (b, n), generator=gen)
        fruit_u = torch.rand((b, n), generator=gen)
        want = engine.step(cfg, want_state, actions, fruit_u)
        if t == 0:
            got = plan.launch_step(plan.pack(state), actions, fruit_u)
        else:
            want = step_kernel.select_envs(frozen, (want_state, want_out),
                                           want)
            assert state._plan is plan and out._arena is state._arena
            got = step_kernel.step(cfg, state, actions, fruit_u,
                                   hold=(frozen, out))
            assert got[0]._plan is plan
        _assert_pairs_equal(got, want, t)
        held_steps += int(frozen.sum())
        mixed += 0 < int(frozen.sum()) < b   # some held, some stepped
        (state, out), (want_state, want_out) = got, want
        frozen = frozen | out.done_all
    assert held_steps > 0 and mixed > 0
    assert plain_library.calls == step_kernel.step.launches - before == 40
    # the mask is checked like any input, and needs a whole arena
    with pytest.raises(ValueError):
        step_kernel.step(cfg, state, actions, fruit_u,
                         hold=(frozen[:3], out))
    with pytest.raises(ValueError):
        plan.launch_step(plan.pack(want_state), actions, fruit_u, frozen)
    # a state the kernel did not make is packed with its output
    plain = tuple(pickle.loads(pickle.dumps(x)) for x in (state, out))
    got = plan.launch_step(plan.pack(*plain), actions, fruit_u, frozen)
    _assert_pairs_equal(got, step_kernel.select_envs(
        frozen, plain, engine.step(cfg, plain[0], actions, fruit_u)), 'packed')


def test_step_with_hold_on_cpu_tensors_is_the_plain_version():
    cfg = EnvConfig(height=8, width=8, num_snakes=2, snake_length=3)
    tables = engine.spawn_tables(cfg, 'cpu')
    gen = torch.Generator().manual_seed(9)
    state, _ = engine.reset(cfg, tables, reset_draws(cfg, 5, gen, 'cpu'))
    from marlsnake_torch.envs.vector import build_vector_fns
    _, step_fn = build_vector_fns(cfg, autoreset=False, device='cpu')
    actions = torch.randint(0, 3, (5, 2), generator=gen)
    state, out = engine.step(cfg, state, actions, torch.rand((5, 2),
                                                              generator=gen))
    keep = torch.tensor([False, True, True, False, True])
    fruit_u = torch.rand((5, 2), generator=gen)
    before = step_kernel.step.launches
    want = step_kernel.select_envs(
        keep, (state, out), engine.step(cfg, state, actions, fruit_u))
    _assert_pairs_equal(step_kernel.step(cfg, state, actions, fruit_u,
                                         hold=(keep, out)), want, 'step')
    _assert_pairs_equal(step_fn(state, actions,
                                StepDraws(fruit_u, None, None),
                                hold=(keep, out)), want, 'step_fn')
    for (name, a), (_, o) in zip(want[0].fields() + want[1].fields(),
                                 state.fields() + out.fields()):
        assert torch.equal(a[keep], o[keep]), name
    assert step_kernel.step.launches == before
