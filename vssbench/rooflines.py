"""The least bytes each codec entry point's work needs, counted from the
shapes and types of its arguments and results: every input read once,
every output written once.  Whatever implements the entry (one kernel,
several, a fused one), the count is of the call's work, so a share of
the roofline cannot pass 100 %.  Each element costs a few
floating-point operations at most, far under ``peaks.F32_FLOPS`` against
``peaks.HBM_BYTES_PER_S``, so the bound is the memory's."""
from __future__ import annotations

from typing import Iterable

from vssbench import peaks


def io_bytes(inputs: Iterable, outputs: Iterable) -> int:
    """Bytes of the tensors among ``inputs`` and ``outputs``."""
    total = 0
    for x in list(inputs) + list(outputs):
        if hasattr(x, "element_size") and hasattr(x, "numel"):
            total += x.numel() * x.element_size()
    return total


def bound_seconds(nbytes: int) -> float:
    return nbytes / peaks.HBM_BYTES_PER_S
