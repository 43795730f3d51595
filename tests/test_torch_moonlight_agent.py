"""The Moonlight agent (``models/moonlight.py``), its expert dispatch
(``ops/moe_dispatch.py``) and its PPO path on the CPU at tiny widths:
against the plain reference (``perfbench/reference/moonlight.py``), the
experts' shares against the uncut layer, the dispatch under the most
uneven routing, the prompt's cell tokens, an update through
``PPOTrainer``, the ActorCritic's first update unchanged, and the
agent's marks and device counts in the traced rollout."""

import dataclasses

import pytest
import torch

from marlsnake_torch.algo import optim
from marlsnake_torch.algo.ppo_trainer import PPOConfig, PPOTrainer
from marlsnake_torch.models import moonlight as M
from marlsnake_torch.ops import moe_dispatch
from marlsnake_torch.ops.obs_pack import pack_frame
from marlsnake_torch.rng import ppo_draws
from marlsnake_torch.utils.profiling import LoopSlots, tracer
from perfbench.reference import moonlight as ref
from perfbench.reference import nets

PROMPT = M.AgentPrompt(prefix=tuple(range(10, 22)),
                       cells=tuple(range(300, 309)), newline=310,
                       actions=(311, 312, 313))
TINY = dict(hidden_size=64, num_attention_heads=2, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            intermediate_size=128, moe_intermediate_size=32,
            n_routed_experts=16, n_shared_experts=2, num_experts_per_tok=3,
            num_hidden_layers=3, vocab_size=320, prompt=PROMPT)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(held=(4, 4)) -> M.MoonlightConfig:
    return M.MoonlightConfig(held=held, **TINY)


def _settings(c: M.MoonlightConfig) -> dict:
    """The reference's view of a program config."""
    keys = ('hidden_size', 'num_attention_heads', 'kv_lora_rank',
            'qk_nope_head_dim', 'qk_rope_head_dim', 'v_head_dim',
            'intermediate_size', 'moe_intermediate_size', 'n_shared_experts',
            'num_experts_per_tok', 'routed_scaling_factor',
            'first_k_dense_replace', 'rms_norm_eps', 'rope_theta',
            'vocab_size')
    m = {k: getattr(c, k) for k in keys}
    m.update(layers=c.num_hidden_layers, router_experts=c.n_routed_experts,
             held=c.held)
    return m


def _prompt_dict(p: M.AgentPrompt) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(p).items()}


def _planes(b, h, w, seed):
    """Random one-hot cells (B, H, W, 8), about half of them empty."""
    g = torch.Generator().manual_seed(seed)
    ch = torch.randint(0, 16, (b, h, w), generator=g)
    return torch.nn.functional.one_hot(ch, 16)[..., :8].to(torch.uint8)


def _split(net):
    held = {k for k, _ in net.named_buffers()}
    state = net.state_dict()
    return ({k: v for k, v in state.items() if k not in held},
            {k: v for k, v in state.items() if k in held})


def test_agent_matches_the_reference_with_its_gradients():
    c = _cfg()
    net = M.make_moonlight_agent(c, (6, 5, 1), seed=1, device='cpu')
    params, buffers = _split(net)
    g = torch.Generator().manual_seed(2)
    for b in buffers.values():
        b.copy_(0.05 * torch.randn(b.shape, generator=g))
    planes = _planes(3, 6, 5, seed=3)
    action = torch.tensor([0, 2, 1])

    def loss(logits, value):
        lp = torch.log_softmax(logits, -1)
        return lp.gather(-1, action[:, None]).sum() + (value ** 2).sum(), lp

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logits, value = torch.func.functional_call(
        net, (leaves, buffers), (pack_frame(planes),))
    total, lp = loss(logits, value)
    grads = torch.autograd.grad(total, list(leaves.values()))

    agent = ref.Agent(_settings(c), _prompt_dict(PROMPT))
    ids = ref.prompt_ids(planes, _prompt_dict(PROMPT))
    got = {}

    def ref_loss(p):
        r_logits, r_value, _ = agent(p, list(buffers.values()), ids)
        got['out'] = loss(r_logits, r_value)[1], r_value
        return loss(r_logits, r_value)[0]

    _, r_grads = nets.grads_of(ref_loss, params)
    torch.testing.assert_close(lp, got['out'][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(value, got['out'][1], rtol=1e-5, atol=1e-6)
    for name, gr in zip(params, grads):
        scale = float(r_grads[name].abs().max()) or 1.0
        assert float((gr - r_grads[name]).abs().max()) <= 1e-4 * scale, name


def test_the_shares_add_up_to_the_uncut_layer():
    """Four devices of 4 experts each: their parts of the routed output,
    with the shared experts counted once, are the layer with all 16."""
    full = _cfg(held=(0, 16))
    g = torch.Generator().manual_seed(4)
    whole = M.MoE(full, 'cpu')
    for p in whole.parameters():
        p.data.copy_(0.2 * torch.randn(p.shape, generator=g))
    whole.gate.e_score_correction_bias.copy_(0.1 * torch.randn(16,
                                                               generator=g))
    x = torch.randn(2, 7, 64, generator=g)
    outs, shared = [], whole.shared_experts(x)
    for first in (0, 4, 8, 12):
        part = M.MoE(_cfg(held=(first, 4)), 'cpu')
        state = dict(whole.state_dict())
        for name in ('experts.gate_up_proj', 'experts.down_proj'):
            state[name] = state[name][first:first + 4]
        part.load_state_dict(state)
        outs.append(part(x)[0] - shared)
    m = _settings(full)
    p = {'l.' + k: v for k, v in whole.state_dict().items()}
    uncut, loads = ref.Agent(m, _prompt_dict(PROMPT))._moe(
        p, 'l.', x, whole.gate.e_score_correction_bias)
    torch.testing.assert_close(sum(outs) + shared, uncut, rtol=1e-5,
                               atol=1e-5)
    assert int(loads.sum()) == 14 * 3


@pytest.mark.parametrize('choices', ['one expert', 'all held'])
def test_the_dispatch_drops_nothing_under_uneven_routing(choices):
    """Every pair on one held expert, or every choice of every token held
    (the worst case the buffers are sized for): each token gets all its
    experts' weighted outputs, and its gradient."""
    g = torch.Generator().manual_seed(5)
    t, k, d, i, first, n = 11, 3, 8, 4, 2, 4
    x = torch.randn(t, d, generator=g, requires_grad=True)
    gate_up = torch.randn(n, 2 * i, d, generator=g)
    down = torch.randn(n, d, i, generator=g)
    idx = (torch.full((t, k), first + 1) if choices == 'one expert'
           else first + torch.arange(k).expand(t, k))
    w = torch.rand(t, k, generator=g)
    out = moe_dispatch.routed_experts(x, idx, w, first, gate_up, down)
    want = torch.zeros(t, d)
    for j in range(k):
        e = idx[:, j] - first
        h = torch.einsum('tod,td->to', gate_up[e], x)
        a = torch.nn.functional.silu(h[:, :i]) * h[:, i:]
        want = want + w[:, j, None] * torch.einsum('tdi,ti->td', down[e], a)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    (gx,) = torch.autograd.grad(out.sum(), x)
    (gw,) = torch.autograd.grad(want.sum(), x)
    torch.testing.assert_close(gx, gw, rtol=1e-5, atol=1e-5)
    assert moe_dispatch.expert_loads(idx, 8).sum() == t * k


class _Undefined(torch.autograd.Function):
    """``grouped_mm_plain`` with the rows that ``grouped_mm`` leaves
    undefined (past the last offset) NaN, in the output and in the input's
    gradient: what the card's grouped product may leave there."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        y = moe_dispatch.grouped_mm_plain(x, w, offs)
        y[int(offs[-1]):] = float('nan')
        return y

    @staticmethod
    def backward(ctx, grad):
        x, w, offs = ctx.saved_tensors
        with torch.enable_grad():
            x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
            gx, gw = torch.autograd.grad(
                moe_dispatch.grouped_mm_plain(x, w, offs), (x, w), grad)
        gx = gx.clone()
        gx[int(offs[-1]):] = float('nan')
        return gx, gw, None


def _moe_case(part: str, g: torch.Generator, device='cpu',
              dtype=torch.float32):
    """The inputs of ``part`` (the dispatch alone, or an expert layer with
    its router) with 4 of 16 experts held, on ``device``, the input and
    the experts' weights in ``dtype``, and a function of them that
    returns the output and the gradients of every input and weight."""
    if part == 'dispatch':
        # widths of 16-byte rows in bfloat16, as torch._grouped_mm takes
        t, k, d, i, first, n = 13, 3, 16, 8, 4, 4
        x = torch.randn(t, d, generator=g).to(device, dtype)
        w = torch.rand(t, k, generator=g).to(device)
        gate_up = torch.randn(n, 2 * i, d, generator=g).to(device, dtype)
        down = torch.randn(n, d, i, generator=g).to(device, dtype)
        idx = torch.stack([torch.randperm(16, generator=g)[:k]
                           for _ in range(t)]).to(device)
        leaves = [x, w, gate_up, down]

        def run(*leaves):
            x, w, gate_up, down = leaves
            return moe_dispatch.routed_experts(x, idx, w, first, gate_up,
                                               down)
    else:
        layer = M.MoE(_cfg(held=(4, 4)), 'cpu')
        for p in layer.parameters():
            p.data.copy_(0.2 * torch.randn(p.shape, generator=g))
        layer.to(device)
        x = torch.randn(2, 7, 64, generator=g).to(device, dtype)
        state = dict(layer.named_parameters())
        leaves = [x] + list(state.values())

        def run(x, *weights):
            return torch.func.functional_call(
                layer, dict(zip(state, weights)), (x,))[0]
    probe = None

    def outputs(leaves, poison=lambda: None):
        """The output and the gradients; ``poison`` runs before the
        forward and again before the backward."""
        nonlocal probe
        leaves = [v.detach().requires_grad_(True) for v in leaves]
        poison()
        out = run(*leaves)
        if probe is None:
            probe = torch.randn(out.shape, generator=g)
        loss = (out * probe.to(out.device, out.dtype)).sum()
        poison()
        return [out.detach()] + list(torch.autograd.grad(loss, leaves))

    return leaves, outputs


@pytest.mark.parametrize('part', ['dispatch', 'layer with its router'])
def test_rows_past_the_last_offset_reach_no_output_and_no_gradient(
        part, monkeypatch):
    """Whatever the grouped product leaves in the rows of the pairs that
    are not held (75% here), the output and every gradient, of the input,
    the experts, the routing weights and through them the router, are
    those of a grouped product that leaves zeros there."""
    leaves, outputs = _moe_case(part, torch.Generator().manual_seed(14))
    want = outputs(leaves)
    monkeypatch.setattr(moe_dispatch, 'grouped_mm', _Undefined.apply)
    got = outputs(leaves)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('part', ['dispatch', 'layer with its router'])
def test_card_dispatch_reads_no_uninitialised_row(part, monkeypatch):
    """On the card, in bfloat16, with the caching allocator's free memory
    filled with NaN before every pass: the output and the gradients of
    ``torch._grouped_mm``'s dispatch are finite and near those of the
    plain product a group (``grouped_mm_plain``) on the card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: torch._grouped_mm runs only there')
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    leaves, outputs = _moe_case(part, torch.Generator().manual_seed(15),
                                dev, torch.bfloat16)

    def poison():
        """Memory the allocator holds free, in blocks of the small and the
        large pool, set to 0xff bytes (NaN in bfloat16 and float32)."""
        torch.cuda.synchronize()
        for size, count in ((1 << 19, 64), (1 << 22, 16), (1 << 26, 8)):
            junk = [torch.full((size,), 255, dtype=torch.uint8, device=dev)
                    for _ in range(count)]
            del junk

    got = [v.float().cpu() for v in outputs(leaves, poison)]
    monkeypatch.setattr(moe_dispatch, 'grouped_mm',
                        moe_dispatch.grouped_mm_plain)
    want = [v.float().cpu() for v in outputs(leaves, poison)]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 2e-2 * scale


def test_the_cell_tokens_follow_the_planes():
    table = M.cell_token_table(PROMPT)
    assert int(table[0]) == PROMPT.cells[0]
    for c in range(8):
        assert int(table[1 << c]) == PROMPT.cells[1 + c]
    planes = _planes(4, 5, 6, seed=6)
    net = M.MoonlightAgent(_cfg(), 'cpu', weights=False)
    got = net.prompt_ids(pack_frame(planes))
    assert got.shape == (4, len(PROMPT.prefix) + 5 * 7)
    assert torch.equal(got, ref.prompt_ids(planes, _prompt_dict(PROMPT)))


def _agent_trainer(**kw) -> PPOTrainer:
    cfg = PPOConfig(height=6, width=6, num_snakes=2, snake_length=2,
                    num_envs=2, rollout_steps=3, num_minibatches=2,
                    update_epochs=1, net='moonlight_agent',
                    obs_format='packed', moonlight=_cfg(), **kw)
    return PPOTrainer(cfg, device='cpu')


def test_ppo_trainer_runs_an_agent_update_on_the_cpu():
    tr = _agent_trainer()
    ts = tr.init_state()
    before = {k: v.clone() for k, v in ts.params.items()}
    assert list(ts.buffers) == ['layers.1.mlp.gate.e_score_correction_bias',
                                'layers.2.mlp.gate.e_score_correction_bias']
    ts, m = tr.update(ts)
    assert all(torch.isfinite(x) for x in (m.loss_actor, m.loss_value,
                                           m.entropy))
    moved = [k for k in before if not torch.equal(before[k], ts.params[k])]
    assert len(moved) == len(before)
    for b in ts.buffers.values():
        steps = b / tr.config.moonlight.bias_update_rate
        assert torch.allclose(steps, steps.round(), atol=1e-3)
        assert float(b.abs().max()) > 0


def test_the_agents_step_in_place_is_the_functional_step():
    tr = _agent_trainer(seed=7, in_place=True)
    params, _ = _split(M.make_moonlight_agent(tr.config.moonlight,
                                              (6, 6, 1), 7, 'cpu'))
    g = torch.Generator().manual_seed(8)
    grads = [torch.randn(p.shape, generator=g) for p in params.values()]
    state = optim.adam_init(list(params.values()))
    clipped = optim.clip_by_global_norm(grads, tr.config.max_grad_norm)
    updates, want_state = optim.adam_update(clipped, state, tr.config.lr,
                                            eps=1e-5)
    want = optim.apply_updates(list(params.values()), updates)
    got, got_state = tr.apply_gradients(
        {k: v.clone() for k, v in params.items()},
        optim.AdamState(state.count.clone(), [m.clone() for m in state.mu],
                        [v.clone() for v in state.nu]), list(grads))
    assert all(torch.equal(a, b) for a, b in zip(got.values(), want))
    assert all(torch.equal(a, b) for a, b in zip(got_state.mu,
                                                 want_state.mu))
    assert all(torch.equal(a, b) for a, b in zip(got_state.nu,
                                                 want_state.nu))
    assert int(got_state.count) == int(want_state.count) == 1


@pytest.mark.parametrize('net', ['actor_critic', 'moonlight_agent'])
def test_an_update_in_place_equals_the_functional_update(net):
    """Either net, one update from one state: ``in_place`` gives the
    functional step's parameters, moments and routers' biases bit for
    bit, written into the state it was given; the functional step leaves
    that state as it was."""
    runs = []
    for in_place in (False, True):
        if net == 'actor_critic':
            tr = PPOTrainer(PPOConfig(
                height=6, width=6, num_snakes=2, snake_length=2, num_envs=2,
                rollout_steps=3, num_minibatches=2, update_epochs=2,
                seed=5, in_place=in_place), device='cpu')
        else:
            tr = _agent_trainer(seed=5, in_place=in_place)
        ts0 = tr.init_state()
        held = {k: v.clone() for k, v in ts0.params.items()}
        ts, _ = tr.update(ts0)
        runs.append(ts)
        for k, v in ts0.params.items():
            assert (v is ts.params[k]) == in_place
        kept = [torch.equal(v, held[k]) for k, v in ts0.params.items()]
        assert all(kept) if not in_place else not any(kept[:3])
    (a, b) = runs
    for x, y in ((a.params, b.params), (a.buffers, b.buffers)):
        assert list(x) == list(y)
        assert all(torch.equal(x[k], y[k]) for k in x)
    for x, y in ((a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu)):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    steps = tr.config.update_epochs * tr.config.num_minibatches
    assert int(a.opt_state.count) == int(b.opt_state.count) == steps


def test_the_default_net_keeps_the_actor_critic_and_its_first_update():
    """The ActorCritic's layout, no buffers, and one update's numbers as
    the trainer gave them before the agent was added (one thread)."""
    cfg = PPOConfig(height=8, width=8, num_snakes=2, snake_length=3,
                    num_envs=2, rollout_steps=4, num_minibatches=2,
                    update_epochs=2, seed=3)
    tr = PPOTrainer(cfg, device='cpu')
    ts = tr.init_state()
    assert [(k, tuple(v.shape)) for k, v in ts.params.items()] == \
        nets.actor_critic_layout(8, 8, 8, 3)
    assert ts.buffers == {}
    ts, m = tr.update(ts)
    assert float(sum(v.double().sum() for v in ts.params.values())) == \
        -21.78527153737707
    assert (float(m.loss_actor), float(m.loss_value), float(m.entropy)) == (
        -0.005822035018354654, 0.013938146643340588, 1.0760128498077393)
    assert float(sum(v.double().abs().sum() for v in ts.opt_state.mu)) == \
        8.209226462256083


def test_the_rollout_places_the_agents_marks_and_device_counts():
    tr = _agent_trainer()
    ts = tr.init_state()
    cfg = tr.config
    draws = ppo_draws(tr.env_cfg, cfg.num_envs, cfg.rollout_steps,
                      cfg.update_epochs, torch.Generator().manual_seed(9),
                      'cpu')
    tracer.enable('cpu')
    try:
        tr.collect(ts, draws)
        got = tracer.flush()
    finally:
        tracer.disable()
        tracer.flush()
    names = [s['name'] for s in got['stamps']]
    forwards = cfg.rollout_steps + 1
    layers = cfg.moonlight.num_hidden_layers
    assert names.count('agent.embed') == forwards
    assert names.count('agent.attn') == forwards * layers
    assert names.count('agent.dense') == forwards
    assert names.count('agent.moe') == forwards * (layers - 1)
    tokens = len(PROMPT.prefix) + 6 * 7
    agents = cfg.num_envs * cfg.num_snakes
    c = got['counts']
    assert c['agent.routed'] == (forwards * agents * tokens * 3
                                 * (layers - 1))
    assert sum(map(sum, c['agent.held_load'])) == c['agent.held'] > 0
    assert len(c['agent.held_load']) == layers - 1


def test_a_graphs_device_counts_reach_the_tracer():
    """The captured path's counts: a loop's own sums (first count copies,
    later ones add), added to the tracer's after each replay."""
    tracer.enable('cpu')
    try:
        sink = LoopSlots(torch.device('cpu'))
        sink.count('n', torch.tensor(3))
        sink.count('n', torch.tensor(4))
        sink.count('v', torch.tensor([1, 2]))
        for _ in range(2):
            tracer.replayed(sink.slots[:0], [], sink.counts)
        got = tracer.flush()
    finally:
        tracer.disable()
        tracer.flush()
    assert got['counts'] == {'n': 14, 'v': [2, 4]}
