#!/usr/bin/env python3
"""Does ``CUBLAS_WORKSPACE_CONFIG`` move the serving path's times?

    python3 chip_cublas_ab.py

Run from the root of a checkout on a machine with one CUDA card.  It
runs ``chip_smoke.py``'s serving path (``drive_serving``: the paged-KV
engine over Qwen3-32B at full width cut to 16 layers, eight requests)
in four processes of its own, alternately without and with
``chip_smoke.DETERMINISTIC_ENV`` (off, on, on, off: the setting is read
once, before cuBLAS first runs, so each side needs a fresh process).
Each process serves the requests twice and prints the median decode
round at batch 7 and at batch 1, the prefills' seconds and the run's
wall time, then the device time of a third run (``torch.profiler``):
the GEMMs' and all.  Every line carries the card's ``nvidia-smi`` name
and power limit.  It checks nothing.  ``chip_smoke.py`` sets the
variable only in the process of its crash-and-resume check, which
needs it for ``torch.use_deterministic_algorithms``.
"""
from __future__ import annotations

import os
import subprocess
import sys

MODES = ("off", "on", "on", "off")


def serve(mode: str) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("chip_cublas_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs._build.build_all()
    cfg, model = cs.serving_model()
    prompts = cs.serving_prompts(cfg.vocab_size)
    setting = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    for rep in range(2):
        rec = cs.drive_serving(model, cfg, prompts)
        med = {b: float(np.median([t for t, bb in rec["round_s"]
                                   if bb == b])) * 1e3 for b in (7, 1)}
        print(f"{mode} run {rep}: CUBLAS_WORKSPACE_CONFIG={setting}: decode"
              f" rounds at batch 7 median {med[7]:.2f} ms, at batch 1"
              f" {med[1]:.2f} ms; prefills {sum(rec['prefill_s']):.4f} s;"
              f" wall {rec['wall_s']:.3f} s [{card}]", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.drive_serving(model, cfg, prompts)
        torch.cuda.synchronize()
    us = {e.key: e.self_device_time_total for e in prof.key_averages()}
    gemm = sum(v for k, v in us.items()
               if "nvjet" in k or "gemm" in k.lower())
    print(f"{mode}: device time of a run: GEMMs {gemm / 1e3:.2f} ms, all"
          f" {sum(us.values()) / 1e3:.2f} ms [{card}]", flush=True)
    return 0


def main() -> int:
    import chip_smoke as cs

    for mode in MODES:
        env = dict(os.environ)
        env.pop("CUBLAS_WORKSPACE_CONFIG", None)
        if mode == "on":
            env.update(cs.DETERMINISTIC_ENV)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              mode], env=env, timeout=900)
        if res.returncode:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(serve(sys.argv[1]) if sys.argv[1:] in (["on"], ["off"])
             else main())
