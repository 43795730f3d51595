"""The routed experts' part of a mixture-of-experts layer on the device
that holds some of them, with no host sync and no dropped token.

The router chooses ``k`` of all the layer's experts for every token; a
device holds the experts ``first .. first + E - 1`` and computes their
part of the result alone (expert parallelism, without the exchange).
``routed_experts`` does it with shapes that depend on the token count
alone, so that it runs inside a captured CUDA graph:

1. Every (token, choice) pair gets a key: its local expert where the
   expert is held, ``E`` where it is not. One stable sort of the ``T * k``
   keys groups the held pairs by expert, in token order, and puts the
   others last; ``searchsorted`` gives each group's end (the offsets).
2. The pairs' rows of the input, in that order, go through one grouped
   product per projection over the held experts (``grouped_mm``): gate
   and up together, SiLU(gate) * up, then down. Each group's rows meet
   its own expert's weights; rows past the last offset are not computed.
3. The outputs, each scaled by its pair's routing weight, go back to
   their pairs' places (the sort's inverse, a permutation) and are added
   up over each token's ``k`` choices in float32.

Buffers are sized for the worst case, every choice of every token held:
``T * k`` rows. Nothing is dropped however uneven the routing is. The
rows of pairs that are not held are zero on the way in, their routing
weights are 0, and their rows are set to zero on the way out: no output
and no gradient (of the input, the experts or the routing weights) reads
what the grouped product leaves there. Every step is deterministic: the only sums
are the products' own and the fixed sum over the ``k`` choices.

``grouped_mm`` is ``torch._grouped_mm`` (CUTLASS's grouped GEMM on sm90,
bfloat16, device offsets) for a CUDA tensor, with its own autograd; for a
CPU tensor it is the plain version, a loop over the groups, which the CPU
tests run. It replaces no kernel of the JAX package, which has no
mixture of experts; it is bound by the tensor cores at these widths
(2,048 x 2,816 and 1,408 x 2,048 an expert).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """(M, K) rows times (G, N, K) weights, group by group: rows
    ``offs[g-1]:offs[g]`` (from 0 for g = 0) by ``w[g].T``; (M, N). Rows
    past ``offs[-1]`` are left undefined."""
    if x.device.type == 'cuda':
        if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
            raise TypeError('grouped_mm on the card takes bfloat16, got '
                            f'{x.dtype} and {w.dtype}')
        return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    return grouped_mm_plain(x, w, offs)


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
                     ) -> torch.Tensor:
    """The plain version of ``grouped_mm``: a product a group; rows past
    the last offset are zero."""
    parts, start = [], 0
    for g, end in enumerate(offs.tolist()):
        parts.append(x[start:end] @ w[g].t())
        start = end
    parts.append(x.new_zeros(x.shape[0] - start, w.shape[1]))
    return torch.cat(parts)


def routed_experts(x: torch.Tensor, topk_idx: torch.Tensor,
                   topk_weight: torch.Tensor, first: int,
                   gate_up: torch.Tensor, down: torch.Tensor
                   ) -> torch.Tensor:
    """The held experts' part of the layer's output, (T, d) float32.

    ``x`` (T, d) in the compute dtype; ``topk_idx`` (T, k) the chosen
    experts over the whole layer; ``topk_weight`` (T, k) float32 their
    weights; ``gate_up`` (E, 2I, d) and ``down`` (E, d, I) the held
    experts' weights in the compute dtype, expert ``first + e`` at index
    ``e``. Each pair's weight scales its activation before the down
    projection, which is the same product as scaling its output."""
    t, k = topk_idx.shape
    n_held = gate_up.shape[0]
    local = topk_idx.reshape(-1) - first
    held = (local >= 0) & (local < n_held)
    key = torch.where(held, local, n_held)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    offs = torch.searchsorted(
        sorted_key, torch.arange(n_held, device=key.device, dtype=key.dtype),
        right=True).to(torch.int32)
    valid = (sorted_key < n_held)[:, None]
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=order.device))
    rows = _PairRows.apply(x, order, inverse, valid, k)
    gate, up = grouped_mm(rows, gate_up, offs).chunk(2, dim=-1)
    # rows past the last offset hold whatever the products left there: a
    # weight of 0 chosen (not multiplied) keeps their gradient off the
    # router's weights
    weight = torch.where(valid, topk_weight.reshape(-1)[order, None],
                         0).to(x.dtype)
    y = grouped_mm(F.silu(gate) * (up * weight), down, offs)
    return _Combine.apply(y, order, inverse, valid, k)


class _PairRows(torch.autograd.Function):
    """``x``'s row of each pair in the sorted order (``x[order // k]``),
    zero for the pairs that are not held; the gradient of the held pairs
    goes back through the inverse permutation and is summed over each
    token's ``k`` pairs, with no atomic add."""

    @staticmethod
    def forward(ctx, x, order, inverse, valid, k):
        ctx.save_for_backward(inverse, valid)
        ctx.k = k
        pad = torch.cat([x, x.new_zeros(1, x.shape[1])])
        return pad[torch.where(valid[:, 0], order // k, x.shape[0])]

    @staticmethod
    def backward(ctx, grad):
        inverse, valid = ctx.saved_tensors
        t = inverse.numel() // ctx.k
        grad = torch.where(valid, grad, 0).index_select(0, inverse)
        return grad.view(t, ctx.k, -1).sum(1), None, None, None, None


class _Combine(torch.autograd.Function):
    """The sum, in float32, of each token's ``k`` pairs' rows of ``y`` (in
    the sorted order; the rows of pairs not held left out, whatever they
    hold); the gradient of each held row is its token's, gathered."""

    @staticmethod
    def forward(ctx, y, order, inverse, valid, k):
        ctx.save_for_backward(order, valid)
        ctx.k, ctx.dtype = k, y.dtype
        t = inverse.numel() // k
        y = torch.where(valid, y, 0).index_select(0, inverse)
        return y.view(t, k, -1).sum(1, dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        order, valid = ctx.saved_tensors
        rows = grad.to(ctx.dtype)[order // ctx.k]
        return torch.where(valid, rows, 0), None, None, None, None


def expert_loads(topk_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(n_experts,) int64: how many (token, choice) pairs chose each
    expert; a fixed-size scatter, so that it runs inside a graph."""
    flat = topk_idx.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
