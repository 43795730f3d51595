"""Gradient clipping and Adam on lists of tensors, with optax's arithmetic,
so that one update gives what ``optax.chain(clip_by_global_norm(max_norm),
adam(lr))`` gives on the same gradients.

Where they differ from ``torch.nn.utils.clip_grad_norm_`` and
``torch.optim.Adam``: the clip leaves the gradients as they are where the
norm is below ``max_norm`` and computes ``(g / norm) * max_norm``
elsewhere, with no 1e-6 added to the norm; Adam computes
``m_hat / (sqrt(v_hat) + eps)`` with both moments bias-corrected by
``1 - decay ** count`` first, ``count`` an int32 that starts at 1 on the
first update. The arithmetic is ``ops/clip_adam.py``'s plain version.

``clip_adam`` is the learners' whole step. On CUDA tensors it is the
kernel pair of ``ops/clip_adam.py``; elsewhere it is that module's plain
version, which adds the updates with ``apply_updates`` as this module
names it. Both keep the step only where a device flag says so, and both
can write the results into the state they are given. The other
functions return new tensors, and the state lives wherever the
parameters live. ``mean_of`` is the JAX trainers' compiled mean, for the
losses and metrics.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from marlsnake_torch.ops import clip_adam as kernel


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor       # () int32: updates made so far
    mu: List[torch.Tensor]    # first moments, one per parameter
    nu: List[torch.Tensor]    # second moments


global_norm = kernel.global_norm


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """``grads`` clipped to the global norm ``max_norm``; ``norm``, where
    given, is their global norm (of a larger set that they are a part
    of)."""
    return kernel.clip(grads, max_norm,
                       global_norm(grads) if norm is None else norm)


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    count = torch.zeros((), dtype=torch.int32, device=params[0].device)
    return AdamState(count, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def adam_update(grads: Sequence[torch.Tensor], state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                ) -> Tuple[List[torch.Tensor], AdamState]:
    """(the updates to add to the parameters, the new state)."""
    updates, mu, nu, count = kernel.adam(grads, state.mu, state.nu,
                                         state.count, lr, b1, b2, eps)
    return updates, AdamState(count, mu, nu)


apply_updates = kernel.apply_updates


def clip_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamState, lr: float, max_norm: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              can_update: Optional[torch.Tensor] = None,
              in_place: bool = False
              ) -> Tuple[List[torch.Tensor], AdamState]:
    """Clip to the global norm ``max_norm``, then one Adam step: (the new
    parameters, the new state). Where ``can_update`` (a device bool) is
    False, the parameters and the state as they were. With ``in_place``
    the results are written into ``params`` and ``state``, which come
    back."""
    kwargs = dict(lr=lr, max_norm=max_norm, b1=b1, b2=b2, eps=eps,
                  can_update=can_update, in_place=in_place)
    if params[0].is_cuda:
        new, mu, nu, count = kernel.clip_adam(params, grads, state.mu,
                                              state.nu, state.count, **kwargs)
    else:
        new, mu, nu, count = kernel.clip_adam_plain(
            params, grads, state.mu, state.nu, state.count,
            add=apply_updates, **kwargs)
    return list(new), AdamState(count, list(mu), list(nu))


def mean_of(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """The mean (over ``dim``, or of every element) as the JAX trainers'
    compiled ``jnp.mean`` gives it: XLA turns the division of the sum by
    the count into a product with the count's float32 reciprocal.
    ``Tensor.mean`` divides, and differs in the last bit where the count
    is no power of two."""
    if dim is None:
        return x.sum() * (1.0 / x.numel())
    return x.sum(dim) * (1.0 / x.shape[dim])
