"""Gradient clipping by global norm and Adam, in optax's arithmetic: the
plain version and the CUDA kernel pair that takes the whole step.

The arithmetic is ``optax.chain(clip_by_global_norm(max_norm),
adam(lr, b1, b2, eps))``'s: the gradients are left as they are where
their global norm is below ``max_norm`` and become ``(g / norm) *
max_norm`` elsewhere, with no 1e-6 added to the norm; both moments are
bias-corrected by ``1 - decay ** count`` before ``m_hat / (sqrt(v_hat)
+ eps)``, ``count`` an int32 that starts at 1 on the first update; the
parameters take ``p + u * (-lr)``. ``global_norm``, ``clip`` and
``adam`` are the plain pieces, on lists of tensors, and
``apply_updates`` adds the updates to the parameters; ``clip_adam_plain``
composes them into one step, the only composition of the step.

``clip_adam`` is the wrapper. On CPU tensors it is ``clip_adam_plain``;
on CUDA tensors it launches ``csrc/clip_adam.cu``'s two kernels, pass 1
(the sum of squares, one partial a block into scratch) and pass 2 (the
norm from the partials, then the update of every leaf), once each a
chunk of ``MAX_LEAVES`` leaves, on PyTorch's current stream, or raises:
on a leaf that is not float32 or not contiguous, on one on another
device, on lists of unequal lengths. A captured graph replays the
launches as they are. ``clip_adam.launches`` counts them.

Both take a device flag ``can_update`` (a bool tensor): where it is
False the step leaves the parameters, moments and count as they were.
With ``in_place`` the results are written into the tensors given (the
outputs alias the inputs, and a step not taken writes nothing); else
they are new tensors. ``norm``, where given, is the global norm to clip
by (of a larger set that these gradients are a part of, or the same
norm handed to both versions).

The library is built on first use with nvcc (``ops/cuda_build.py``)
into ``build/marlsnake_torch/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from marlsnake_torch.ops import cuda_build

SOURCE = os.path.join(cuda_build.CSRC_DIR, 'clip_adam.cu')

THREADS = 256            # threads a block
TILE = THREADS * 4       # elements a tile
MAX_LEAVES = 48          # leaves one launch's argument block holds
SUM_BLOCKS_PER_SM = 4    # pass 1's grid: blocks an SM, at most

Tensors = Sequence[torch.Tensor]
# (parameters, first moments, second moments, count)
Step = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor],
             torch.Tensor]


# --- the plain version ------------------------------------------------------

def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum over all tensors of their summed squares."""
    squares = torch._foreach_mul(tensors, tensors)
    return torch.stack([s.sum() for s in squares]).sum().sqrt()


def clip(grads: Tensors, max_norm: float, norm: torch.Tensor
         ) -> List[torch.Tensor]:
    """``grads``, of global norm ``norm``, clipped to ``max_norm``."""
    scaled = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    below = norm < max_norm
    return [torch.where(below, g, s) for g, s in zip(grads, scaled)]


def adam(grads: Tensors, mu: Tensors, nu: Tensors, count: torch.Tensor,
         lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                    List[torch.Tensor], torch.Tensor]:
    """(the updates to add to the parameters, the new moments, the new
    count)."""
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    mu = add(mul(grads, 1 - b1), mul(mu, b1))
    nu = add(mul(mul(grads, grads), 1 - b2), mul(nu, b2))
    count = count + 1
    mu_hat = div(mu, 1 - b1 ** count)
    nu_hat = div(nu, 1 - b2 ** count)
    updates = div(mu_hat, add(torch._foreach_sqrt(nu_hat), eps))
    return list(mul(updates, -lr)), list(mu), list(nu), count


def apply_updates(params: Tensors, updates: Tensors) -> List[torch.Tensor]:
    return list(torch._foreach_add(params, updates))


def select(can_update: Optional[torch.Tensor], new: Step, old: Step) -> Step:
    """``new`` where ``can_update``, else ``old`` (``new`` where it is
    None): the branch-free counterpart of JAX's ``lax.cond``. The count is
    selected too, or its bias correction would drift."""
    if can_update is None:
        return new
    params, mu, nu = ([torch.where(can_update, a, b) for a, b in zip(n, o)]
                      for n, o in zip(new[:3], old[:3]))
    return params, mu, nu, torch.where(can_update, new[3], old[3])


def write_into(dst: Step, src: Step) -> Step:
    """``src`` copied into the tensors of ``dst``; returns ``dst``."""
    for d, s in zip(dst, src):
        for a, b in zip(d, s) if isinstance(d, list) else ((d, s),):
            a.copy_(b)
    return dst


def clip_adam_plain(params: Tensors, grads: Tensors, mu: Tensors,
                    nu: Tensors, count: torch.Tensor, *, lr: float,
                    max_norm: float, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8,
                    can_update: Optional[torch.Tensor] = None,
                    norm: Optional[torch.Tensor] = None,
                    in_place: bool = False,
                    add: Callable[[Tensors, Tensors], List[torch.Tensor]]
                    = apply_updates) -> Step:
    """One clipped Adam step: (parameters, moments, count) after it;
    ``add`` adds the updates to the parameters."""
    check_lists(params, grads, mu, nu)
    clipped = clip(grads, max_norm,
                   global_norm(grads) if norm is None else norm)
    updates, new_mu, new_nu, new_count = adam(clipped, mu, nu, count, lr,
                                              b1, b2, eps)
    old = (list(params), list(mu), list(nu), count)
    new = select(can_update, (list(add(params, updates)), new_mu, new_nu,
                              new_count), old)
    return write_into(old, new) if in_place else new


# --- the kernel -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(cuda_build.build(SOURCE)[0][0])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.marlsnake_clip_adam.argtypes = [
        i, p, p, p, i, p, p, p, p, f, f, f, f, f, f, f, i, i, p,
        ctypes.POINTER(ctypes.c_int)]
    lib.marlsnake_clip_adam.restype = ctypes.c_int
    lib.marlsnake_clip_adam_error_string.argtypes = [ctypes.c_int]
    lib.marlsnake_clip_adam_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunks(n_leaves: int) -> int:
    """Launches of each kernel for ``n_leaves`` leaves."""
    return -(-n_leaves // MAX_LEAVES)


def check_lists(params: Tensors, grads: Tensors, mu: Tensors, nu: Tensors
                ) -> None:
    lengths = {len(params), len(grads), len(mu), len(nu)}
    if len(lengths) != 1 or not params:
        raise ValueError(
            'params, grads, mu and nu must be lists of one nonzero '
            f'length, not {[len(x) for x in (params, grads, mu, nu)]}')


def check_leaves(params: Tensors, grads: Tensors, mu: Tensors, nu: Tensors,
                 scalars: Sequence[Optional[torch.Tensor]]) -> torch.device:
    """The device of every tensor; raises on what the kernel does not
    take."""
    check_lists(params, grads, mu, nu)
    device = params[0].device
    for i, leaf in enumerate(zip(params, grads, mu, nu)):
        shape = leaf[0].shape
        for name, t in zip(('param', 'grad', 'mu', 'nu'), leaf):
            if t.device != device:
                raise ValueError(f'leaf {i}: {name} on {t.device}, the '
                                 f'parameters on {device}')
            if t.dtype != torch.float32:
                raise TypeError(f'leaf {i}: {name} is {t.dtype}; the '
                                'kernel takes float32')
            if not t.is_contiguous():
                raise ValueError(f'leaf {i}: {name} is not contiguous')
            if t.shape != shape:
                raise ValueError(f'leaf {i}: {name} of shape '
                                 f'{tuple(t.shape)}, the parameter of '
                                 f'{tuple(shape)}')
    for name, t, dtype in zip(('count', 'can_update', 'norm'), scalars,
                              (torch.int32, torch.bool, torch.float32)):
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f'{name} on {t.device}, the parameters on '
                             f'{device}')
        if t.dtype != dtype or t.numel() != 1:
            raise TypeError(f'{name} must be one {dtype}, not '
                            f'{t.dtype} of {t.numel()}')
    return device


def clip_adam(params: Tensors, grads: Tensors, mu: Tensors, nu: Tensors,
              count: torch.Tensor, *, lr: float, max_norm: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              can_update: Optional[torch.Tensor] = None,
              norm: Optional[torch.Tensor] = None,
              in_place: bool = False) -> Step:
    """``clip_adam_plain``'s step: on CUDA tensors the kernel pair."""
    device = check_leaves(params, grads, mu, nu, (count, can_update, norm))
    if device.type == 'cpu':
        return clip_adam_plain(params, grads, mu, nu, count, lr=lr,
                               max_norm=max_norm, b1=b1, b2=b2, eps=eps,
                               can_update=can_update, norm=norm,
                               in_place=in_place)
    if device.type != 'cuda':
        raise ValueError(f'clip_adam runs on the CPU or a CUDA card, not '
                         f'{device}')
    if in_place:
        out = (list(params), list(mu), list(nu), count)
    else:
        out = ([torch.empty_like(p) for p in params],
               [torch.empty_like(m) for m in mu],
               [torch.empty_like(v) for v in nu], torch.empty_like(count))
    n, index = len(params), device.index
    sms = _sm_count(index)
    capacity = chunks(n) * sms * SUM_BLOCKS_PER_SM
    # the partials, then one slot for the new count
    scratch = torch.empty(capacity + 1, dtype=torch.float32, device=device)
    ptrs = (ctypes.c_void_p * (7 * n))(*[
        t.data_ptr() for leaf in zip(grads, params, mu, nu, *out[:3])
        for t in leaf])
    sizes = (ctypes.c_longlong * n)(*[p.numel() for p in params])
    launches = ctypes.c_int(0)
    lib = load_library()
    rc = cuda_build.on_current_stream(index, lambda stream: (
        lib.marlsnake_clip_adam(
            n, ptrs, sizes, scratch.data_ptr(), capacity, count.data_ptr(),
            out[3].data_ptr(),
            None if can_update is None else can_update.data_ptr(),
            None if norm is None else norm.data_ptr(), max_norm, b1, b2,
            1 - b1, 1 - b2, eps, -lr, int(in_place), sms, stream,
            ctypes.byref(launches))))
    clip_adam.launches += launches.value
    cuda_build.raise_on(rc, 'clip_adam', lib.marlsnake_clip_adam_error_string)
    return out


clip_adam.launches = 0
