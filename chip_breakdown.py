#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 chip_breakdown.py

Run from the root of a checkout on a machine with a CUDA card, after or
instead of ``chip_smoke.py`` (it builds the kernels itself).  It drives
the same main path as ``chip_smoke.py`` (``drive_store``: a 1080p,
90-frame clip written as ``hevc``, one ``transcode_gop``, five reads) and
prints:

- one 1080p GOP's ``encode_gop`` and ``decode_gop`` wall time, each
  beside its host zlib stage alone (medians of 3, host clock);
- the host numpy box resample behind the half-resolution read;
- the wall time of one CUDA main-path run under ``torch.profiler``, the
  device time the profiler saw in it (kernels and copies), the idle
  share, and the device time by name.

Every time stands beside the card's ``nvidia-smi`` name and power
limit.  It checks nothing that ``chip_smoke.py`` does not; it is the
diagnosis behind PERF.md's "Where the time goes".
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke  # noqa: E402  (puts src/ on sys.path)
from repro_torch import codec  # noqa: E402
from repro_torch.codec import tvc  # noqa: E402
from repro_torch.core.store import resample  # noqa: E402
from repro_torch.data.video import synthesize_road  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def codec_breakdown(gop: np.ndarray, device: str, reps: int = 3):
    """Host-clock split of one GOP's encode and decode on ``device``:
    the entropy stage (zlib on the host) against the rest (upload,
    layout, kernel, download).  Medians of ``reps`` runs, in seconds."""
    enc = codec.encode_gop(gop, "hevc", device=device)  # warm up
    tier = tvc.TIERS["tvc-hi"]
    t, h, w, c = gop.shape
    raw = tvc._raw_payload(enc)
    iframe_u8 = np.frombuffer(bytes(raw[:h * w * c]), np.uint8)
    resid = np.frombuffer(bytes(raw[h * w * c:]), np.int8).reshape(
        t - 1, c, h, w)

    def med(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    return {
        "encode_s": med(lambda: codec.encode_gop(gop, "hevc", device=device)),
        "encode_zlib_s": med(lambda: tvc._chunked_gop(
            "tvc-hi", gop.shape, iframe_u8, resid, tier)),
        "decode_s": med(lambda: codec.decode_gop(enc, device=device)),
        "decode_zlib_s": med(lambda: tvc._raw_payload(enc)),
    }


def device_busy(root: str, clip: np.ndarray):
    """Wall seconds of one CUDA main-path run and the device time
    ``torch.profiler`` saw in it (kernels and copies; None when the
    profiler reports no device time), with that time by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.drive_store(root, clip, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    by_name = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        busy_us += us
        if us > 0:
            by_name[e.key] = us / 1e6
    return wall, (busy_us / 1e6 if busy_us > 0 else None), by_name


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_breakdown: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    _build.build_all()
    clip = synthesize_road(90, width=1920, height=1080, seed=0)

    br = codec_breakdown(clip[:30], "cuda")
    print(f"one 1080p GOP, hevc, cuda: encode_gop {br['encode_s']:.3f} s"
          f" (zlib {br['encode_zlib_s']:.3f} s), decode_gop"
          f" {br['decode_s']:.3f} s (zlib {br['decode_zlib_s']:.3f} s)"
          f" [{card}]")
    half = (clip.shape[2] // 2, clip.shape[1] // 2)
    t0 = time.perf_counter()
    resample(clip, half, device="cuda")  # integer factor: host numpy
    print(f"resample of the 90-frame clip to {half} (host numpy box"
          f" mean): {time.perf_counter() - t0:.3f} s [{card}]")
    with tempfile.TemporaryDirectory() as d:
        wall, busy, by_name = device_busy(os.path.join(d, "vss"), clip)
    if busy is None:
        print(f"profiled cuda main path: {wall:.3f} s wall; device time"
              " not measured (torch.profiler reported none)")
    else:
        print(f"profiled cuda main path: {wall:.3f} s wall, device busy"
              f" {busy:.3f} s, idle share {1 - busy / wall:.4f} [{card}]")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print("device time by name: " + "; ".join(
            f"{k[:60]} {v * 1e3:.2f} ms" for k, v in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
