"""Small shared helpers (shape arithmetic, byte formatting)."""
from __future__ import annotations

import math
from typing import Iterable


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0 or unit == "PiB":
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


def prod(xs: Iterable[int]) -> int:
    return int(math.prod(xs))
