"""Gradient clipping and Adam as plain functions on lists of tensors, with
optax's arithmetic, so that one update gives what ``optax.chain(
clip_by_global_norm(max_norm), adam(lr))`` gives on the same gradients.

Where they differ from ``torch.nn.utils.clip_grad_norm_`` and
``torch.optim.Adam``: the clip leaves the gradients as they are where the
norm is below ``max_norm`` and computes ``(g / norm) * max_norm``
elsewhere, with no 1e-6 added to the norm; Adam computes
``m_hat / (sqrt(v_hat) + eps)`` with both moments bias-corrected by
``1 - decay ** count`` first, ``count`` an int32 that starts at 1 on the
first update. Nothing is updated in place: every function returns new
tensors, and the state lives wherever the parameters live.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor       # () int32: updates made so far
    mu: List[torch.Tensor]    # first moments, one per parameter
    nu: List[torch.Tensor]    # second moments


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over all tensors of their summed squares."""
    squares = torch._foreach_mul(tensors, tensors)
    return torch.stack([s.sum() for s in squares]).sum().sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    norm = global_norm(grads)
    scaled = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    below = norm < max_norm
    return [torch.where(below, g, s) for g, s in zip(grads, scaled)]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    count = torch.zeros((), dtype=torch.int32, device=params[0].device)
    return AdamState(count, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def adam_update(grads: Sequence[torch.Tensor], state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                ) -> Tuple[List[torch.Tensor], AdamState]:
    """(the updates to add to the parameters, the new state)."""
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    mu = add(mul(grads, 1 - b1), mul(state.mu, b1))
    nu = add(mul(mul(grads, grads), 1 - b2), mul(state.nu, b2))
    count = state.count + 1
    mu_hat = div(mu, 1 - b1 ** count)
    nu_hat = div(nu, 1 - b2 ** count)
    updates = div(mu_hat, add(torch._foreach_sqrt(nu_hat), eps))
    return mul(updates, -lr), AdamState(count, list(mu), list(nu))


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return list(torch._foreach_add(params, updates))
