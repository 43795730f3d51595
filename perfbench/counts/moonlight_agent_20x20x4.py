"""Counts of the moonlight_agent_20x20x4 configuration
(``configs/moonlight_agent_20x20x4.json``): the agent's model FLOPs in
PPO. A multiply-add is two FLOPs; the routed experts count at their
nominal share, ``num_experts_per_tok`` choices a token of which the held
experts' share (``held / router_experts``) lands here."""

from __future__ import annotations


def prompt_tokens(config: dict) -> int:
    """The prompt: the instruction ids, then each board row and a
    newline."""
    e = config['env']
    return len(config['prompt']['prefix']) + e['height'] * (e['width'] + 1)


def forward_flops_per_token(config: dict, tokens: int) -> float:
    """One token's share of a causal forward over a prompt of ``tokens``:
    every projection, attention over ``(tokens + 1) / 2`` keys on
    average, the dense SwiGLU of the leading layers, and in every expert
    layer the router, the shared experts and the held routed experts'
    nominal share."""
    c = config
    d, h = c['hidden_size'], c['num_attention_heads']
    nope, rope, v = c['qk_nope_head_dim'], c['qk_rope_head_dim'], \
        c['v_head_dim']
    lora = c['kv_lora_rank']
    keys = (tokens + 1) / 2
    attn = 2 * (d * h * (nope + rope) + d * (lora + rope)
                + lora * h * (nope + v) + h * v * d) \
        + 2 * h * keys * (nope + rope + v)
    dense = 3 * 2 * d * c['intermediate_size']
    dep = c['deployment']
    held_share = dep['held_experts'][1] / dep['router_experts']
    expert = 3 * 2 * d * c['moe_intermediate_size']
    moe = (2 * d * dep['router_experts']
           + c['n_shared_experts'] * expert
           + c['num_experts_per_tok'] * held_share * expert)
    leading = c['first_k_dense_replace']
    return c['layers'] * attn + leading * dense + (c['layers'] - leading) \
        * moe


def forward_flops_per_sample(config: dict) -> float:
    """A prompt's forward and its head: the final-normed last state times
    the three action rows and the value row."""
    s = prompt_tokens(config)
    return s * forward_flops_per_token(config, s) \
        + 2 * config['hidden_size'] * 4


def train_flops_per_env_step(config: dict, params: dict) -> float:
    """Model FLOPs a trained env-step costs: an update's rollout (a forward
    of every agent every step, and one more for the bootstrap value) and
    its epochs (a forward and a backward, twice the forward, of every
    sample each epoch; the backward's recompute of each layer is not
    model work), over the update's env-steps."""
    n = config['env']['num_snakes']
    envs, steps = params['num_envs'], params['rollout_steps']
    fwd = forward_flops_per_sample(config)
    rollout = (steps + 1) * envs * n * fwd
    epochs = params['update_epochs'] * steps * envs * n * 3 * fwd
    return (rollout + epochs) / (steps * envs)
