#!/usr/bin/env python3
"""Where the time of the port's joint, serving and training paths goes,
on one NVIDIA GPU.

    python3 chip_breakdown.py

Run from the root of a checkout on a machine with a CUDA card, after or
instead of ``chip_smoke.py`` (it builds the kernels itself).  The main
path (writes and view reads of a store) is measured by ``vssbench``: its
traced runs name every idle second by the program's own spans.  This
prints:

- the wall time of one CUDA run of ``chip_smoke.py``'s joint path (two
  1080p camera pairs written, jointly compressed and read back) under
  ``torch.profiler``, the device time the profiler saw in it (kernels
  and copies), the idle share, and the device time by name, split by
  kernel name into the warp, the histogram, the codec kernels, copies
  and the rest;
- the same for one CUDA run of ``chip_smoke.py``'s serving path (the
  paged-KV engine over Qwen3-32B at full width, 16 layers, eight
  requests), with the device time split into the paged attention (its
  split kernel and its combine kernel, the combine also on a line of
  its own), the bf16 matrix products, the pool's indexed writes and the
  rest, and the host's share (wall time the device was idle);
- the same for one train step of ``chip_smoke.py``'s training phase
  (phi3-mini at full width cut to 8 layers, batch 8 x 1024 in two
  microbatches, after two warm-up steps), with the device time split
  into the f32 attention products, the bf16 matrix products, softmax,
  copies and casts, and the rest (elementwise passes and reductions:
  norms, rope, activations, the gradient sums, clip and AdamW).

Every time stands beside the card's ``nvidia-smi`` name and power
limit.  It checks nothing that ``chip_smoke.py`` does not; it is the
diagnosis of the paths that no benchmark cell runs yet.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

import torch

import chip_smoke  # noqa: E402  (puts src/ on sys.path)
from repro_torch.kernels import _build  # noqa: E402


def device_busy(run):
    """Wall seconds of ``run()`` (a CUDA path) and the device time
    ``torch.profiler`` saw in it (kernels and copies; None when the
    profiler reports no device time), with that time by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    cams = chip_smoke.joint_cameras()
    with tempfile.TemporaryDirectory() as d:
        wall, busy, by_name = device_busy(
            lambda: chip_smoke.drive_joint(os.path.join(d, "vss"), cams,
                                           "cuda"))
    report("joint path", wall, busy, by_name, card)
    if busy is not None:
        split = split_by_name(by_name, JOINT_PARTS)
        print("joint device time by part: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in split.items()) + f" [{card}]")
    cfg, model = chip_smoke.serving_model()
    prompts = chip_smoke.serving_prompts(cfg.vocab_size)
    chip_smoke.drive_serving(model, cfg, prompts)  # warm up cuBLAS, caches
    wall, busy, by_name = device_busy(
        lambda: chip_smoke.drive_serving(model, cfg, prompts))
    report("serving path", wall, busy, by_name, card)
    if busy is not None:
        split = split_by_name(by_name, SERVING_PARTS)
        print("serving device time by part: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in split.items())
              + f"; host (device idle) {wall - busy:.4f} s of {wall:.4f} s"
              f" [{card}]")
        combine = sum(v for k, v in by_name.items()
                      if PAGED_COMBINE in k.lower())
        share = combine / max(split["paged attention"], 1e-12)
        print(f"  of which the paged attention's combine kernel"
              f" {combine:.4f} s ({share:.4f} of the paged attention)"
              f" [{card}]")
    del model
    torch.cuda.empty_cache()
    train_breakdown(card)
    return 0


def train_breakdown(card) -> None:
    """One full-width train step of the training phase, profiled."""
    cs = chip_smoke
    cfg = dataclasses.replace(cs.get_config(cs.TRAIN_ARCH),
                              num_layers=cs.TRAIN_LAYERS)
    hyper = cs.TrainHyper(**cs.TRAIN_HYPER)
    state = cs.init_train_state(0, cfg, hyper, device="cuda")
    tok = cs.markov_corpus(cfg.vocab_size, cs.TRAIN_BATCH
                           * (cs.TRAIN_SEQ + 1))
    tok = tok.reshape(cs.TRAIN_BATCH, cs.TRAIN_SEQ + 1)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    grad_step = cs.make_grad_step(cfg, hyper)

    def step():
        nonlocal state
        loss, grads = grad_step(state["params"], batch)
        state, _metrics = cs.apply_grads(state, loss, grads, hyper)

    step()
    step()  # cuBLAS heuristics and the caching allocator warmed
    torch.cuda.synchronize()
    wall, busy, by_name = device_busy(step)
    report("train step", wall, busy, by_name, card)
    if busy is not None:
        split = split_by_name(by_name, TRAIN_PARTS)
        print("train step device time by part: " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" for k, v in split.items())
              + f"; host (device idle) {(wall - busy) * 1e3:.2f} ms of"
              f" {wall * 1e3:.2f} ms [{card}]")


# kernel-name fragments of each part of a serving run's device time; the
# paged attention is two kernels (csrc/paged_attention.cu)
PAGED_COMBINE = "paged_combine_kernel"
SERVING_PARTS = (
    ("paged attention", ("paged_split_kernel", PAGED_COMBINE)),
    ("bf16 GEMMs", ("gemm", "xmma", "cutlass", "nvjet", "splitk")),
    ("pool writes", ("index_put", "indexing", "index_elementwise")),
)


# the same for the joint path: its two kernels by their symbols
# (csrc/warp.cu, csrc/histogram.cu), the codec's, and the copies
JOINT_PARTS = (
    ("warp", ("warp_kernel",)),
    ("histogram", ("histogram_kernel",)),
    ("codec kernels", ("delta_encode_kernel", "delta_decode_kernel")),
    ("copies", ("memcpy", "memset")),
)


# the same for a train step: the f32 attention products (TF32 off: SIMT
# sgemm), then the bf16 ones (cuBLAS's Hopper kernels), softmax, copies
TRAIN_PARTS = (
    ("f32 GEMMs (attention)", ("f32f32", "sgemm")),
    ("bf16 GEMMs", ("nvjet", "gemm", "xmma", "cutlass")),
    ("softmax", ("softmax",)),
    ("copies and casts", ("copy", "memcpy", "memset", "catarray")),
)


def split_by_name(by_name, parts):
    """Device seconds by part; kernels that match no part are "other"
    (on the serving path: norms, rope, softmax, elementwise, copies)."""
    out = {part: 0.0 for part, _ in parts}
    out["other"] = 0.0
    for name, secs in by_name.items():
        low = name.lower()
        part = next((p for p, frags in parts
                     if any(f in low for f in frags)), "other")
        out[part] += secs
    return out


def report(label, wall, busy, by_name, card) -> None:
    if busy is None:
        print(f"profiled cuda {label}: {wall:.3f} s wall; device time"
              " not measured (torch.profiler reported none)")
        return
    print(f"profiled cuda {label}: {wall:.3f} s wall, device busy"
          f" {busy:.3f} s, idle share {1 - busy / wall:.4f} [{card}]")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"device time by name ({label}): " + "; ".join(
        f"{k[:60]} {v * 1e3:.2f} ms" for k, v in top))


if __name__ == "__main__":
    sys.exit(main())
