"""Moonlight-16B-A3B as an LLM snake agent: the decoder as published, one
device's share of its experts, a prompt of the board, and the agent head.

The decoder is Moonlight's (https://huggingface.co/moonshotai/
Moonlight-16B-A3B, ``model_type`` deepseek_v3), written from its layer
equations:

* Pre-norm RMSNorm (in float32) before attention and before the
  feed-forward, a final RMSNorm, SiLU, no biases.
* Attention is MLA with no q-LoRA: ``q_proj`` d -> H * (nope + rope);
  ``kv_a_proj_with_mqa`` d -> kv_lora + rope, ``kv_a_layernorm`` on the
  first part, ``kv_b_proj`` kv_lora -> H * (nope + v). The rope parts
  take RoPE (theta 50,000, no scaling) after the de-interleave that HF's
  ``modeling_deepseek`` applies to them (pairs (x0, x1), (x2, x3), ...
  become halves [x0, x2, ...], [x1, x3, ...] before ``rotate_half``); the
  key's rope part is one head shared by all. Causal attention with
  scale ``(nope + rope) ** -0.5`` through ``F.scaled_dot_product_attention``
  with query and key heads of 192 and value heads of 128, unpadded (on
  the H100 PyTorch takes cuDNN's attention for these shapes).
* Layer 0 is a dense SwiGLU; every later layer is a mixture of
  experts: a router of all ``n_routed_experts`` in float32, sigmoid
  scores, the top ``num_experts_per_tok`` by score plus the
  ``e_score_correction_bias`` (a buffer: it chooses, it does not weigh;
  ``noaux_tc`` with one group), each choice weighted by its unbiased
  score over the sum of the chosen ones (``norm_topk_prob``) times
  ``routed_scaling_factor``; plus the shared experts, one SwiGLU of
  ``n_shared_experts`` times the expert width, added once.
* The layer holds only the experts ``held[0] .. held[0] + held[1] - 1``
  and computes their part of the routed output
  (``ops/moe_dispatch.routed_experts``); what the other experts would add
  lies on other devices and is left out (expert parallelism without its
  exchange).

The agent (``MoonlightAgent``): the packed obs bytes of a board (one byte
a cell, ``EnvConfig(obs_format='packed')``) become a prompt on the
device: the fixed instruction ids, then each row's cell tokens
(``prompt.cells[0]`` for an empty cell, ``prompt.cells[1 + c]`` for one
whose plane c is set) followed by the newline id. The action logits are
the final-normed last hidden state times the rows of ``lm_head`` of the
env's three actions, a restricted softmax over them (TWOSOME,
arXiv:2401.14151); the value is a linear layer on the same vector (trl's
``AutoModelForCausalLMWithValueHead``, without its dropout).

Precision: parameters are float32; with ``compute_dtype=torch.bfloat16``
every product and attention run in bfloat16, the weights cast as they
are used, and the residual stream is bfloat16, as the model runs in
bfloat16. Router scores, top-k, the weight normalisation, RMSNorm
(rounded once at its output), the sum of the experts' outputs (each
scaled by its routing weight in bfloat16), the final norm, the action
logits and the value are float32.

In training (autograd on), each decoder layer is recomputed in the
backward (``torch.utils.checkpoint``): a minibatch of 65,536 tokens does
not fit on one H100 otherwise (``PERF.md``). ``loads`` keeps the last
forward's expert loads, (MoE layers, n_routed_experts) int64 counts of
the router's choices, from which ``step_buffers`` takes the routers'
bias step after each optimizer step. With
``phases=True`` the forward places the tracer's marks ``agent.embed``
(the decoder starts), ``agent.attn`` (after each layer's attention),
``agent.dense`` (after layer 0's feed-forward) and ``agent.moe`` (after
each expert layer's), and counts on the device the router's choices:
``agent.routed`` all, ``agent.held`` those of held experts and
``agent.held_load`` (layers, held) each held expert's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from marlsnake_torch.core.types import FEATURE_CHANNEL
from marlsnake_torch.device import resolve_device
from marlsnake_torch.ops.moe_dispatch import expert_loads, routed_experts
from marlsnake_torch.utils.profiling import tracer

@dataclasses.dataclass(frozen=True)
class AgentPrompt:
    """The prompt's ids: ``prefix`` before the board, ``cells`` (the empty
    cell, then planes 0-7), ``newline`` after each row, and ``actions``,
    the ids whose ``lm_head`` rows give the env's actions, in its order.
    They are the tokenizer's, which is not in the repository: a deployment
    states them (the benchmark's, in its configuration file)."""
    prefix: Tuple[int, ...]
    cells: Tuple[int, ...]
    newline: int
    actions: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    """The decoder's settings under their ``config.json`` names, the
    published values by default; ``num_hidden_layers`` is the depth
    built here, ``held`` (first, count) the experts held here and
    ``prompt`` the agent's token ids, which have no default."""
    hidden_size: int = 2048
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    first_k_dense_replace: int = 1
    num_hidden_layers: int = 27
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    vocab_size: int = 163840
    held: Tuple[int, int] = (0, 64)
    # aux-loss-free balancing: the bias step after each optimizer step
    # (DeepSeek-V3 section 2.1.2; Megatron-LM's moe_router_bias_update_rate)
    bias_update_rate: float = 1e-3
    prompt: Optional[AgentPrompt] = None


def cell_token_table(prompt: AgentPrompt, device=None) -> torch.Tensor:
    """(256,) int64: the token of each packed cell byte: the empty id for
    0, and for any other byte the id of its lowest set plane (an obs byte
    has at most one)."""
    byte = torch.arange(256)
    low = (byte & -byte).clamp_min(1).log2().round().long()
    ids = torch.tensor(prompt.cells, dtype=torch.int64)
    return torch.where(byte == 0, ids[0], ids[1 + low]).to(device)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """``x`` normalised and weighted in float32 (PyTorch's fused
        ``rms_norm`` on the card), rounded once to ``dtype`` (by default
        ``x``'s). HF's ``DeepseekV3RMSNorm`` rounds the normalised ``x``
        before the weight; this rounds after it."""
        dt = x.dtype if dtype is None else dtype
        x = x.to(dt)
        return F.rms_norm(x, x.shape[-1:], self.weight.to(dt), self.eps)


def _linear(dim_in: int, dim_out: int, device) -> nn.Linear:
    return nn.Linear(dim_in, dim_out, bias=False, device=device)


def rope_tables(cfg: MoonlightConfig, positions: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (positions, qk_rope_head_dim) float32."""
    dim = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, dim, 2, dtype=torch.int64, device=device).float() / dim))
    freqs = torch.outer(torch.arange(positions, device=device).float(), inv)
    emb = torch.cat([freqs, freqs], -1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """RoPE on (..., S, D) after the interleaved pairs are de-interleaved
    into halves (HF ``modeling_deepseek.apply_rotary_pos_emb``)."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + half * sin


class Attention(nn.Module):
    def __init__(self, cfg: MoonlightConfig, device):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.num_attention_heads, cfg.hidden_size
        nope, rope, v = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
        self.q_proj = _linear(d, h * (nope + rope), device)
        self.kv_a_proj_with_mqa = _linear(d, cfg.kv_lora_rank + rope, device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps,
                                      device)
        self.kv_b_proj = _linear(cfg.kv_lora_rank, h * (nope + v), device)
        self.o_proj = _linear(h * v, d, device)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
        cfg, dt = self.cfg, x.dtype
        b, s, _ = x.shape
        h, nope, rope = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim)
        q = F.linear(x, self.q_proj.weight.to(dt)).view(b, s, h, nope + rope)
        q = q.transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], -1)
        kv_a = F.linear(x, self.kv_a_proj_with_mqa.weight.to(dt))
        c_kv, k_pe = kv_a.split([cfg.kv_lora_rank, rope], -1)
        kv = F.linear(self.kv_a_layernorm(c_kv), self.kv_b_proj.weight.to(dt))
        kv = kv.view(b, s, h, nope + cfg.v_head_dim).transpose(1, 2)
        k_nope, v = kv.split([nope, cfg.v_head_dim], -1)
        cos, sin = cos.to(dt), sin.to(dt)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, None], cos, sin).expand(b, h, s, rope)
        out = F.scaled_dot_product_attention(
            torch.cat([q_nope, q_pe], -1), torch.cat([k_nope, k_pe], -1), v,
            is_causal=True, scale=(nope + rope) ** -0.5)
        out = out.transpose(1, 2).reshape(b, s, h * cfg.v_head_dim)
        return F.linear(out, self.o_proj.weight.to(dt))


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, dim: int, width: int, device):
        super().__init__()
        self.gate_proj = _linear(dim, width, device)
        self.up_proj = _linear(dim, width, device)
        self.down_proj = _linear(width, dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        a = F.silu(F.linear(x, self.gate_proj.weight.to(dt)))
        return F.linear(a * F.linear(x, self.up_proj.weight.to(dt)),
                        self.down_proj.weight.to(dt))


class Router(nn.Module):
    def __init__(self, cfg: MoonlightConfig, device):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(
            cfg.n_routed_experts, cfg.hidden_size, device=device))
        self.register_buffer('e_score_correction_bias', torch.zeros(
            cfg.n_routed_experts, device=device))

    def forward(self, x: torch.Tensor):
        """(topk_idx (T, k), topk_weight (T, k) float32) of tokens x."""
        cfg = self.cfg
        scores = F.linear(x.float(), self.weight).sigmoid()
        choice = scores + self.e_score_correction_bias
        idx = choice.topk(cfg.num_experts_per_tok, -1).indices
        w = scores.gather(-1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * cfg.routed_scaling_factor


class Experts(nn.Module):
    """The held experts' weights, stacked: ``gate_up_proj`` (E, 2I, d)
    (each expert's gate rows, then its up rows) and ``down_proj`` (E, d,
    I)."""

    def __init__(self, cfg: MoonlightConfig, device):
        super().__init__()
        e, i, d = cfg.held[1], cfg.moe_intermediate_size, cfg.hidden_size
        self.gate_up_proj = nn.Parameter(torch.empty(e, 2 * i, d,
                                                     device=device))
        self.down_proj = nn.Parameter(torch.empty(e, d, i, device=device))


class MoE(nn.Module):
    def __init__(self, cfg: MoonlightConfig, device):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg, device)
        self.experts = Experts(cfg, device)
        self.shared_experts = MLP(
            cfg.hidden_size, cfg.n_shared_experts * cfg.moe_intermediate_size,
            device)

    def forward(self, x: torch.Tensor):
        """(the layer's output, its loads (n_routed_experts,))."""
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        idx, w = self.gate(flat)
        dt = x.dtype
        routed = routed_experts(flat, idx, w, self.cfg.held[0],
                                self.experts.gate_up_proj.to(dt),
                                self.experts.down_proj.to(dt))
        out = (routed + self.shared_experts(flat).float()).to(dt)
        return out.view(b, s, d), expert_loads(idx,
                                               self.cfg.n_routed_experts)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MoonlightConfig, index: int, device):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device)
        self.self_attn = Attention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, device)
        self.dense = index < cfg.first_k_dense_replace
        self.mlp = (MLP(cfg.hidden_size, cfg.intermediate_size, device)
                    if self.dense else MoE(cfg, device))

    def forward(self, x, cos, sin, phases: bool):
        """(the layer's output, its expert loads or None)."""
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        if phases:
            tracer.mark('agent.attn')
        y = self.mlp(self.post_attention_layernorm(x))
        loads = None
        if not self.dense:
            y, loads = y
        if phases:
            tracer.mark('agent.dense' if self.dense else 'agent.moe')
        return x + y, loads


class MoonlightAgent(nn.Module):
    """(logits (B, 3), value (B,)), both float32, of packed obs bytes (B,
    H, W, 1) uint8. Its weights are drawn on the device from ``seed``
    (``init_weights_``). With ``weights=False`` its parameters and
    routers' biases lie on the meta device, holding no memory: a net that
    runs only on tensors handed in (``torch.func.functional_call``)."""

    def __init__(self, cfg: MoonlightConfig, device='cuda',
                 compute_dtype: torch.dtype = torch.float32,
                 weights: bool = True, seed: int = 0):
        super().__init__()
        if cfg.prompt is None:
            raise ValueError('the agent needs its prompt\'s token ids: '
                             'MoonlightConfig(prompt=AgentPrompt(...))')
        dev = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.seed = seed
        d = cfg.hidden_size
        w = dev if weights else torch.device('meta')
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d, device=w)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i, w) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(d, cfg.rms_norm_eps, w)
        self.lm_head = _linear(d, cfg.vocab_size, w)
        self.v_head = nn.Linear(d, 1, device=w)
        p = cfg.prompt
        self.register_buffer('cell_tokens', cell_token_table(p, dev),
                             persistent=False)
        self.register_buffer('prefix', torch.tensor(p.prefix, device=dev),
                             persistent=False)
        self.register_buffer('action_ids', torch.tensor(p.actions,
                                                        device=dev),
                             persistent=False)
        self.loads: Optional[torch.Tensor] = None
        if weights:
            init_weights_(self, torch.Generator(device=dev).manual_seed(seed))

    @staticmethod
    def ingress(obs: torch.Tensor) -> torch.Tensor:
        """The packed obs bytes as they are: the prompt reads them."""
        return obs

    def initial_state(self) -> Dict[str, torch.Tensor]:
        """The parameters and routers' biases that training starts from,
        drawn afresh from ``seed`` on the agent's device: an agent without
        weights holds none."""
        return MoonlightAgent(self.cfg, self.prefix.device,
                              self.compute_dtype, seed=self.seed).state_dict()

    def step_buffers(self, buffers: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The routers' correction biases (``state_dict`` names, in the
        layers' order) after one bias step at ``bias_update_rate``
        (``balance_bias``) over the last forward's loads."""
        rate = self.cfg.bias_update_rate
        return {k: balance_bias(b, load, rate)
                for (k, b), load in zip(buffers.items(), self.loads)}

    def prompt_ids(self, obs: torch.Tensor) -> torch.Tensor:
        """(B, len(prefix) + H * (W + 1)) int64 token ids of packed obs
        (B, H, W, 1)."""
        b, h, w = obs.shape[:3]
        cells = self.cell_tokens[obs[..., 0].long()]
        newline = torch.full((b, h, 1), self.cfg.prompt.newline,
                             dtype=torch.int64, device=obs.device)
        board = torch.cat([cells, newline], -1).reshape(b, h * (w + 1))
        return torch.cat([self.prefix.expand(b, -1), board], -1)

    def forward(self, obs: torch.Tensor, phases: bool = False):
        cfg, dt = self.cfg, self.compute_dtype
        ids = self.prompt_ids(obs)
        x = F.embedding(ids, self.embed_tokens.weight).to(dt)
        cos, sin = rope_tables(cfg, ids.shape[1], ids.device)
        if phases:
            tracer.mark('agent.embed')
        loads = []
        for layer in self.layers:
            if torch.is_grad_enabled():
                # the recompute in the backward runs after the caller's
                # functional_call has put the module's own tensors back:
                # it is handed the ones this forward used
                state = dict(layer.named_parameters())
                state.update(layer.named_buffers())
                x, got = checkpoint(_recomputed, layer, state, x, cos, sin,
                                    use_reentrant=False)
            else:
                x, got = layer(x, cos, sin, phases)
            if got is not None:
                loads.append(got)
        self.loads = torch.stack(loads) if loads else None
        if phases and loads:
            first, n = cfg.held
            held = self.loads[:, first:first + n]
            tracer.count_device('agent.routed', self.loads.sum())
            tracer.count_device('agent.held', held.sum())
            tracer.count_device('agent.held_load', held)
        last = self.norm(x[:, -1], torch.float32)
        logits = last @ self.lm_head.weight[self.action_ids].t()
        value = F.linear(last, self.v_head.weight, self.v_head.bias)
        return logits, value[:, 0]


def _recomputed(layer: DecoderLayer, state: dict, x, cos, sin):
    return torch.func.functional_call(layer, state, (x, cos, sin, False))


def balance_bias(bias: torch.Tensor, loads: torch.Tensor, rate: float
                 ) -> torch.Tensor:
    """One step of aux-loss-free balancing of a router's correction bias
    (n_experts,) from its expert loads (n_experts,) over a minibatch:
    ``bias + rate * sign(mean load - load)``."""
    load = loads.float()
    return bias + rate * torch.sign(load.mean() - load)


def init_weights_(net: MoonlightAgent, generator: torch.Generator,
                  std: float = 0.02) -> MoonlightAgent:
    """HF's initialisation in place: every weight matrix, the embedding
    and the experts normal(0, ``std``), RMSNorm weights 1, the value
    head's bias and the correction biases 0; one draw a tensor from
    ``generator``, in the module's order."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith('layernorm.weight') or name == 'norm.weight':
                p.fill_(1.0)
            elif name == 'v_head.bias':
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
        for name, b in net.named_buffers():
            if name.endswith('e_score_correction_bias'):
                b.zero_()
    return net


def make_moonlight_agent(cfg: MoonlightConfig, obs_shape, seed: int = 0,
                         device='cuda',
                         compute_dtype: torch.dtype = torch.float32,
                         weights: bool = True) -> MoonlightAgent:
    """The agent for packed obs of ``obs_shape`` (H, W, 1), its weights
    drawn on the device from ``seed`` (``init_weights_``); with
    ``weights=False`` none (``MoonlightAgent``)."""
    if tuple(obs_shape[2:]) != (1,):
        raise ValueError(f'the agent reads packed obs of one frame (H, W, '
                         f'1), not {tuple(obs_shape)}')
    prompt = cfg.prompt
    if prompt is not None and len(prompt.cells) != 1 + FEATURE_CHANNEL:
        raise ValueError('the prompt needs an id for the empty cell and one '
                         f'a plane: {1 + FEATURE_CHANNEL}')
    return MoonlightAgent(cfg, device, compute_dtype, weights, seed)
