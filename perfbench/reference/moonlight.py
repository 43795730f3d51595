"""The plain reference of the Moonlight agent and of its PPO update, in
plain torch, float32, TF32 off. Imports nothing of the program.

The decoder of Moonlight-16B-A3B (deepseek_v3) at the configuration
file's widths, with the file's depth and held experts:

* RMSNorm: ``w * x / sqrt(mean(x^2) + eps)``, statistics in float32.
* Attention (MLA, no q-LoRA): per head a query of ``nope + rope``
  (``q_proj``); a shared latent of ``kv_lora`` and a shared rope key
  (``kv_a_proj_with_mqa``); the latent normed and expanded to each head's
  key part and value (``kv_b_proj``). The rope parts of query and key hold
  (cos, sin) pairs: pair i of position p turns by ``p / theta ** (2i /
  rope)``, its turned halves laid out first all first components, then
  all second ones. Scores ``q . k / sqrt(nope + rope)`` over every key
  (the shared rope key copied to each head), masked above the diagonal,
  a softmax, times the values; ``o_proj``.
* Feed-forward: layer 0 a SwiGLU ``down(silu(gate x) * up x)``; later
  layers: router scores ``sigmoid(x . W_e)`` of every expert in float32,
  the top k by score plus the layer's correction bias, weights the
  chosen scores over their sum times the scaling factor; each held
  expert in turn over the tokens that chose it (an index mask), weighted;
  plus the shared SwiGLU. The absent experts are left out.
* The agent: a prompt of the fixed ids, then each board row's cell ids
  (the empty id, or the id of the cell's one set plane of the eight)
  and a newline id; the final-normed last hidden state times the
  ``lm_head`` rows of the three actions, log-softmax over them; the
  value a linear layer of the same vector.

The PPO update (``ppo_update``) follows the program's recorded actions,
so that both see the same trajectory: each rollout step the log-prob of
the recorded action and the value of every agent, the env stepped with
those actions, GAE, then epochs of minibatches, each a clipped-surrogate
loss over its valid rows (advantages normalised over them), a value loss
and an entropy bonus, computed in blocks of samples whose gradients add
up, a clipped Adam step, and the bias step of each router: ``bias + rate
* sign(mean load - load)`` over the minibatch's expert loads.

``dtype`` runs every product and the residual stream in that precision
(the control: bfloat16), the router, the norms' statistics, the softmax
and the head in float32. ``fault`` plants a defect in the reference put
in the program's place: 'fp8_experts' rounds the held experts' inputs
through float8_e4m3fn; 'zero_expert' leaves out the first held expert's
output; 'top5' routes to one expert fewer; 'no_scale' leaves out the
routing scale; 'half_batch' takes each minibatch's first half.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import nets

F32 = torch.float32
Params = Dict[str, torch.Tensor]


def layout(m: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, in the module's order (the names
    HF gives them; the held experts stacked)."""
    d, h = m['hidden_size'], m['num_attention_heads']
    nope, rope, v = (m['qk_nope_head_dim'], m['qk_rope_head_dim'],
                     m['v_head_dim'])
    lora, e, i = (m['kv_lora_rank'], m['held'][1],
                  m['moe_intermediate_size'])
    out = [('embed_tokens.weight', (m['vocab_size'], d))]
    for n in range(m['layers']):
        pre = f'layers.{n}.'
        out += [(pre + 'input_layernorm.weight', (d,)),
                (pre + 'self_attn.q_proj.weight', (h * (nope + rope), d)),
                (pre + 'self_attn.kv_a_proj_with_mqa.weight',
                 (lora + rope, d)),
                (pre + 'self_attn.kv_a_layernorm.weight', (lora,)),
                (pre + 'self_attn.kv_b_proj.weight', (h * (nope + v), lora)),
                (pre + 'self_attn.o_proj.weight', (d, h * v)),
                (pre + 'post_attention_layernorm.weight', (d,))]
        if n < m['first_k_dense_replace']:
            w = m['intermediate_size']
            out += [(pre + 'mlp.gate_proj.weight', (w, d)),
                    (pre + 'mlp.up_proj.weight', (w, d)),
                    (pre + 'mlp.down_proj.weight', (d, w))]
        else:
            w = m['n_shared_experts'] * i
            out += [(pre + 'mlp.gate.weight', (m['router_experts'], d)),
                    (pre + 'mlp.experts.gate_up_proj', (e, 2 * i, d)),
                    (pre + 'mlp.experts.down_proj', (e, d, i)),
                    (pre + 'mlp.shared_experts.gate_proj.weight', (w, d)),
                    (pre + 'mlp.shared_experts.up_proj.weight', (w, d)),
                    (pre + 'mlp.shared_experts.down_proj.weight', (d, w))]
    return out + [('norm.weight', (d,)),
                  ('lm_head.weight', (m['vocab_size'], d)),
                  ('v_head.weight', (1, d)), ('v_head.bias', (1,))]


def bias_names(m: dict) -> List[str]:
    """The routers' correction biases, one an expert layer."""
    return [f'layers.{n}.mlp.gate.e_score_correction_bias'
            for n in range(m['first_k_dense_replace'], m['layers'])]


def init_params(lay, generator: torch.Generator, device,
                std: float = 0.02) -> Params:
    """Weights from ONE normal draw on the device, times ``std`` (HF's
    initializer_range); RMSNorm weights 1, the value head's bias 0."""
    weights = [(n, s) for n, s in lay
               if not (n.endswith('norm.weight') or n == 'v_head.bias')]
    sizes = [torch.Size(s).numel() for _, s in weights]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=F32).mul_(std)
    out = {n: part.view(s) for (n, s), part in zip(weights, flat.split(sizes))}
    return {n: out[n] if n in out else (
        torch.zeros(s, device=device) if n == 'v_head.bias'
        else torch.ones(s, device=device)) for n, s in lay}


def prompt_ids(planes: torch.Tensor, prompt: dict) -> torch.Tensor:
    """(B, S) int64 ids of one-hot obs planes (B, H, W, 8)."""
    dev = planes.device
    b, h, w = planes.shape[:3]
    cells = torch.tensor(prompt['cells'], device=dev)
    tok = torch.where(planes.bool().any(-1), cells[1 + planes.argmax(-1)],
                      cells[0])
    rows = torch.cat([tok, torch.full((b, h, 1), prompt['newline'],
                                      device=dev)], -1)
    prefix = torch.tensor(prompt['prefix'], device=dev).expand(b, -1)
    return torch.cat([prefix, rows.reshape(b, -1)], -1)


class Agent:
    """The agent's forward over parameters handed in."""

    def __init__(self, m: dict, prompt: dict, dtype=F32,
                 fault: Optional[str] = None):
        self.m, self.prompt, self.dt, self.fault = m, prompt, dtype, fault

    def _lin(self, x, w):
        return F.linear(x.to(self.dt), w.to(self.dt))

    def _rms(self, x, w, dtype=None):
        dt = dtype or self.dt
        x32 = x.float()
        y = x32 / torch.sqrt(x32.pow(2).mean(-1, keepdim=True)
                             + self.m['rms_norm_eps'])
        return w.to(dt) * y.to(dt)

    def _rope(self, x, s: int):
        """The pairs of x (..., s, rope) turned by their positions."""
        r = x.shape[-1]
        inv = 1.0 / (self.m['rope_theta'] ** (torch.arange(
            0, r, 2, device=x.device).float() / r))
        ang = torch.arange(s, device=x.device).float()[:, None] * inv
        cos, sin = ang.cos().to(self.dt), ang.sin().to(self.dt)
        a, b = x[..., 0::2], x[..., 1::2]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    def _attention(self, p, pre, x):
        m = self.m
        b, s, _ = x.shape
        h, nope, rope, v = (m['num_attention_heads'], m['qk_nope_head_dim'],
                            m['qk_rope_head_dim'], m['v_head_dim'])
        q = self._lin(x, p[pre + 'q_proj.weight']).view(b, s, h, -1) \
            .transpose(1, 2)
        kv_a = self._lin(x, p[pre + 'kv_a_proj_with_mqa.weight'])
        latent, k_rope = kv_a[..., :m['kv_lora_rank']], kv_a[..., -rope:]
        kv = self._lin(self._rms(latent, p[pre + 'kv_a_layernorm.weight']),
                       p[pre + 'kv_b_proj.weight'])
        kv = kv.view(b, s, h, nope + v).transpose(1, 2)
        k_rope = self._rope(k_rope, s)[:, None].expand(b, h, s, rope)
        query = torch.cat([q[..., :nope], self._rope(q[..., nope:], s)], -1)
        key = torch.cat([kv[..., :nope], k_rope], -1)
        scores = (query @ key.transpose(-1, -2)).float() \
            * (nope + rope) ** -0.5
        above = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        probs = torch.softmax(scores.masked_fill(above, float('-inf')), -1)
        out = (probs.to(self.dt) @ kv[..., nope:].to(self.dt))
        out = out.transpose(1, 2).reshape(b, s, h * v)
        return self._lin(out, p[pre + 'o_proj.weight'])

    def _swiglu(self, p, pre, x):
        g = self._lin(x, p[pre + 'gate_proj.weight'])
        u = self._lin(x, p[pre + 'up_proj.weight'])
        return self._lin(F.silu(g) * u, p[pre + 'down_proj.weight'])

    def _moe(self, p, pre, x, bias):
        """(the layer's output, its loads (router_experts,))."""
        m, fault = self.m, self.fault
        b, s, d = x.shape
        x = x.reshape(b * s, d)
        scores = torch.sigmoid(x.float() @ p[pre + 'gate.weight'].t())
        k = m['num_experts_per_tok'] - (fault == 'top5')
        idx = (scores + bias).topk(k, -1).indices
        w = scores.gather(-1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        if fault != 'no_scale':
            w = w * m['routed_scaling_factor']
        loads = torch.bincount(idx.reshape(-1),
                               minlength=m['router_experts'])
        first, n = m['held']
        gate_up = p[pre + 'experts.gate_up_proj']
        down = p[pre + 'experts.down_proj']
        i = m['moe_intermediate_size']
        y = torch.zeros(b * s, d, device=x.device, dtype=F32)
        for e in range(n):
            chose = idx == first + e
            tok = chose.any(-1).nonzero()[:, 0]
            if fault == 'zero_expert' and e == 0 or not tok.numel():
                continue
            xe = x[tok]
            if fault == 'fp8_experts':
                xe = xe.to(torch.float8_e4m3fn).to(xe.dtype)
            ye = self._lin(F.silu(self._lin(xe, gate_up[e, :i]))
                           * self._lin(xe, gate_up[e, i:]), down[e])
            we = (w * chose).sum(-1)[tok]
            y = y.index_add(0, tok, we[:, None] * ye.float())
        shared = self._swiglu(p, pre + 'shared_experts.', x)
        return (y + shared.float()).to(self.dt).view(b, s, d), loads

    def __call__(self, p: Params, bias: List[torch.Tensor],
                 ids: torch.Tensor):
        """(logits (B, 3), value (B,), loads (expert layers,
        router_experts)) of prompts ``ids`` (B, S)."""
        m = self.m
        x = p['embed_tokens.weight'][ids].to(self.dt)
        loads = []
        for n in range(m['layers']):
            pre = f'layers.{n}.'
            x = x + self._attention(p, pre + 'self_attn.', self._rms(
                x, p[pre + 'input_layernorm.weight']))
            y = self._rms(x, p[pre + 'post_attention_layernorm.weight'])
            if n < m['first_k_dense_replace']:
                y = self._swiglu(p, pre + 'mlp.', y)
            else:
                y, got = self._moe(p, pre + 'mlp.', y,
                                   bias[n - m['first_k_dense_replace']])
                loads.append(got)
            x = x + y
        last = self._rms(x[:, -1], p['norm.weight'], F32)
        logits = last @ p['lm_head.weight'][
            torch.tensor(self.prompt['actions'], device=ids.device)].t()
        value = last @ p['v_head.weight'][0] + p['v_head.bias'][0]
        return logits, value, torch.stack(loads)


def ppo_update(env, hp: dict, agent: Agent, params: Params,
               bias: List[torch.Tensor], adam: nets.Adam, carry, draws,
               actions: torch.Tensor, block: int):
    """One update following the recorded ``actions`` (T, E, N). ``carry``
    = (state, obs, agent_done); ``draws`` = (fruit_u, reset_spawn_u,
    reset_fruit_u, perm), step axis first. Returns (params, bias, {'logp',
    'value', 'valid' (T, E, N), 'actor', 'value_loss', 'entropy', 'adv',
    'grad1': each leaf's norm of the first minibatch's gradient})."""
    fruit_u, spawn_u, rfruit_u, perm = draws
    state, obs, agent_done = carry
    e, n = obs.shape[:2]
    T = hp['rollout_steps']
    rec = {k: [] for k in ('ids', 'logp', 'value', 'reward', 'valid',
                           'next_done')}

    def policy(ids):
        got = [agent(params, bias, part)[:2] for part in ids.split(block)]
        return [torch.cat(x) for x in zip(*got)]

    with torch.no_grad():
        for t in range(T):
            ids = prompt_ids(obs.reshape((e * n,) + obs.shape[2:]),
                             agent.prompt)
            logits, value = policy(ids)
            logp = torch.log_softmax(logits, -1).gather(
                -1, actions[t].reshape(-1, 1).long())[:, 0]
            state, out = env.step_autoreset(state, actions[t], fruit_u[t],
                                            spawn_u[t], rfruit_u[t])
            valid = ~agent_done
            rec['ids'].append(ids)
            rec['logp'].append(logp.view(e, n))
            rec['value'].append(value.view(e, n))
            rec['reward'].append(torch.where(valid, out.reward, 0.0))
            rec['valid'].append(valid)
            rec['next_done'].append(out.done | out.done_all[:, None])
            agent_done = out.done & ~out.done_all[:, None]
            obs = out.obs
        _, last = policy(prompt_ids(obs.reshape((e * n,) + obs.shape[2:]),
                                    agent.prompt))
    r = {k: torch.stack(v) for k, v in rec.items()}
    nonterm = 1.0 - r['next_done'].to(F32)
    next_v = torch.cat([r['value'][1:], last.view(1, e, n)])
    delta = r['reward'] + hp['gamma'] * next_v * nonterm - r['value']
    decay = hp['gamma'] * hp['gae_lambda'] * nonterm
    adv = torch.zeros_like(r['value'])
    gae = torch.zeros((e, n), device=obs.device)
    for t in reversed(range(T)):
        gae = delta[t] + decay[t] * gae
        adv[t] = gae
    rows = adv.numel()
    flat = dict(ids=r['ids'].reshape(rows, -1),
                action=actions.reshape(rows).long(),
                logp=r['logp'].reshape(rows), adv=adv.reshape(rows),
                ret=(adv + r['value']).reshape(rows),
                valid=r['valid'].reshape(rows))
    mb = rows // hp['num_minibatches']
    terms, grad1 = [], None
    for epoch in perm:
        for idx in epoch[:mb * hp['num_minibatches']].view(-1, mb):
            if agent.fault == 'half_batch':
                idx = idx[:idx.numel() // 2]
            params, bias, got, grads = _minibatch(
                hp, agent, params, bias, adam,
                {k: v[idx] for k, v in flat.items()}, block)
            if grad1 is None:
                grad1 = {k: g.double().norm().cpu() for k, g in grads.items()}
            terms.append(got)
            del grads
    actor, value_loss, ent = torch.stack(terms).mean(0).tolist()
    return params, bias, {'logp': r['logp'], 'value': r['value'],
                          'valid': r['valid'], 'actor': actor,
                          'value_loss': value_loss, 'entropy': ent,
                          'adv': adv, 'grad1': grad1}


def _minibatch(hp, agent: Agent, params, bias, adam: nets.Adam, m: dict,
               block: int):
    """One minibatch's step, its loss and gradients summed over blocks of
    samples: (params, bias, its (actor, value, entropy) terms, its
    gradients)."""
    v = m['valid'].to(F32)
    vsum = v.sum().clamp_min(1.0)
    mean = (m['adv'] * v).sum() / vsum
    a = (m['adv'] - mean) / (torch.sqrt(
        ((m['adv'] - mean) ** 2 * v).sum() / vsum) + 1e-8)
    grads, terms, loads = None, 0.0, 0
    for rows in torch.arange(v.numel(), device=v.device).split(block):
        got = {}

        def loss_fn(p):
            logits, value, load = agent(p, bias, m['ids'][rows])
            got['loads'] = load
            lp_all = torch.log_softmax(logits, -1)
            lp = lp_all.gather(-1, m['action'][rows, None])[:, 0]
            vb, ab = v[rows], a[rows]
            ratio = torch.exp(lp - m['logp'][rows])
            eps = hp['clip_eps']
            pg = torch.maximum(-ab * ratio,
                               -ab * torch.clamp(ratio, 1 - eps, 1 + eps))
            actor = (pg * vb).sum() / vsum
            value_loss = (0.5 * (value - m['ret'][rows]) ** 2 * vb).sum() \
                / vsum
            ent = (-(torch.exp(lp_all) * lp_all).sum(-1) * vb).sum() / vsum
            got['terms'] = torch.stack([actor, value_loss, ent]).detach()
            return actor + hp['vf_coef'] * value_loss - hp['ent_coef'] * ent

        _, g = nets.grads_of(loss_fn, params)
        grads = g if grads is None else {k: grads[k] + g[k] for k in g}
        terms = terms + got['terms']
        loads = loads + got['loads']
    params = adam.step(params, grads)
    load = loads.float()
    step = hp['bias_update_rate'] * torch.sign(load.mean(-1, keepdim=True)
                                               - load)
    return params, [b + s for b, s in zip(bias, step)], terms, grads
