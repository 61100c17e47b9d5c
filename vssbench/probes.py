"""Timers the traced run wraps around public entry points of the program.

- ``repro_torch.kernels.ops.delta_encode`` / ``delta_decode`` /
  ``transcode``: the bytes each call's arguments and results hold
  (``rooflines.io_bytes``); ``devtrace`` times the entry's kernels;
- ``repro_torch.codec.encode_gop`` / ``decode_gop`` (the GOP entry the
  store calls): host seconds from entry to the return of a call whose
  device work is done (the current stream synchronized).

Each wrapper opens a ``torch.profiler.record_function`` range, so the
device trace can name what the host was doing.  Nothing is installed in
an untraced run.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Tuple

import torch

from vssbench import rooflines

KERNEL_ENTRIES = ("delta_encode", "delta_decode", "transcode")
GOP_ENTRIES = ("encode_gop", "decode_gop")


class Probes:
    def __init__(self, device: str):
        self.device = device
        self.lock = threading.Lock()
        # name -> the bytes of each call
        self.kernel_calls: Dict[str, List[int]] = {
            k: [] for k in KERNEL_ENTRIES}
        self.gop_seconds: Dict[str, List[float]] = {k: [] for k in GOP_ENTRIES}
        self.saved: List[Tuple[object, str, object]] = []


def _wrap_kernel(p: Probes, name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(f"vss.kernel.{name}"):
            out = fn(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        with p.lock:
            p.kernel_calls[name].append(rooflines.io_bytes(args, outs))
        return out
    return wrapper


def _wrap_gop(p: Probes, name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(f"vss.{name}"):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if p.device != "cpu":
                torch.cuda.current_stream().synchronize()
            dt = time.perf_counter() - t0
        with p.lock:
            p.gop_seconds[name].append(dt)
        return out
    return wrapper


def install(device: str) -> Probes:
    from repro_torch import codec
    from repro_torch.kernels import ops

    p = Probes(device)
    for name in KERNEL_ENTRIES:
        fn = getattr(ops, name)
        p.saved.append((ops, name, fn))
        setattr(ops, name, _wrap_kernel(p, name, fn))
    for name in GOP_ENTRIES:
        fn = getattr(codec, name)
        p.saved.append((codec, name, fn))
        setattr(codec, name, _wrap_gop(p, name, fn))
    return p


def uninstall(p: Probes) -> None:
    for mod, name, fn in reversed(p.saved):
        setattr(mod, name, fn)
    p.saved.clear()
