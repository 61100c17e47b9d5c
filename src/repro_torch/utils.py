"""Small shared helpers (shape arithmetic, division by a constant)."""
from __future__ import annotations

import math
from typing import Iterable

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def prod(xs: Iterable[int]) -> int:
    return int(math.prod(xs))


def div_once(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d in x's dtype, rounded once: the divisor is held on x's device
    (CUDA divides by a host scalar as a product with its reciprocal)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)
