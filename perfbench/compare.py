"""The comparisons that decide ``correct``: gaps between what the
program produced and what the plain reference computes from the same
inputs."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch


def rel_gap(prog: float, ref: float, floor: float) -> float:
    """|prog - ref| over the larger of |ref| and ``floor``."""
    return abs(prog - ref) / max(abs(ref), floor)


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def median(values: Iterable[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                     + v[len(v) // 2])


def moving_leaves(ref_grad_norms: Dict[str, float]) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by rounding alone."""
    med = median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * med]


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Optional[list] = None, worst: bool = True) -> float:
    """The worst (or with ``worst=False`` the median) leaf's gap between
    the program's norm and the reference's, over the larger of the
    reference leaf's norm and the median leaf's."""
    pn, rn = norms(prog), norms(ref)
    med = median(rn.values())
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
            for k in (leaves if leaves is not None else rn)]
    if any(math.isnan(g) for g in gaps):
        return math.nan
    return max(gaps) if worst else median(gaps)


def mismatches(prog, ref) -> int:
    """Elements that differ (every element where the shapes differ)."""
    prog = torch.as_tensor(prog).cpu()
    ref = torch.as_tensor(ref).cpu()
    if prog.shape != ref.shape:
        return max(prog.numel(), ref.numel(), 1)
    return int((prog != ref).sum())
