#!/usr/bin/env python3
"""Time design variants of the squared-error kernel on one CUDA card.

    python3 chip_mse_variants.py [--parent DIR]

Run from the root of a checkout, on a machine with one CUDA card and
nvcc.  It builds edited copies of ``src/repro_torch/csrc/mse.cu`` (one
``nvcc`` each, all started together, into ``build/mse_variants/``),
checks each against the true integer sum (uint8, bit for bit) or the
plain version (f32, rtol 1e-5), and times each with
``chip_smoke.time_ms`` at the main path's ninety (1080, 5760) uint8
planes and at thirty 1080p planes in uint8 and f32, in turns (first to
last, then last to first).  Then it times the shipped kernel over other
cluster sizes, with a and b off 16-byte alignment, and an empty kernel.
With ``--parent DIR`` (an unpacked checkout of another commit) it also
times ``ops.mse_sum`` of that tree and of this one, each in a process of
its own (parent, this, this, parent), and lists the device operations
of a warmed call of each.  It prints the card's name and power limit
first and last.  A variant that is not exact is reported, not failed
(``loads only`` sums no squares).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"uint8 (90,1080,5760)": ((90, 1080, 5760), "uint8"),
          "uint8 (30,1080,1920)": ((30, 1080, 1920), "uint8"),
          "f32 (30,1080,1920)": ((30, 1080, 1920), "f32")}

SQ = "  const unsigned int d = __vabsdiffu4(x, y);\n  return __dp4a(d, d, 0u);"
# name: (edits of the source as (old, new), loads a step of 16-byte vectors)
VARIANTS = {
    "shipped": ((), 4),
    "three dp4a a word": (((SQ, "  return __dp4a(x, x, __dp4a(y, y, 0u))"
                                " - 2u * __dp4a(x, y, 0u);"),), 4),
    # the uint4 loads fall to the template's __ldg
    "__ldg loads": ((("uint4 ld_stream(const uint4* p)",
                      "uint4 ld_stream_unused(const uint4* p)"),), 4),
    "256 threads": ((("constexpr int kThreads = 512;",
                      "constexpr int kThreads = 256;"),), 4),
    "8 vectors a step": ((("return vec == 16 ? 4 : 16;",
                           "return vec == 16 ? 8 : 16;"),), 8),
    "loads only": (((SQ, "  return x ^ y;"),), 4),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def inputs(torch, device="cuda"):
    """The timed planes, drawn on the card from seed 0."""
    gen = torch.Generator(device).manual_seed(0)
    out = {}
    for name, (shape, kind) in SHAPES.items():
        a, b = (torch.randint(0, 256, shape, generator=gen, device=device,
                              dtype=torch.uint8) for _ in range(2))
        out[name] = (a, b) if kind == "uint8" else (a.float(), b.float())
    return out


def time_tree(tree: str) -> None:
    """Time ``ops.mse_sum`` of the checkout at ``tree`` and list the device
    operations of one warmed call; prints one JSON line."""
    root = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    sys.path.insert(1, HERE)
    from chip_smoke import time_ms

    res = {"tree": tree}
    planes = inputs(torch)
    for name, (a, b) in planes.items():
        res[name] = time_ms(lambda: ops.mse_sum(a, b), 20)
    a, b = planes["uint8 (30,1080,1920)"]
    ops.mse_sum(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.mse_sum(a, b)
        torch.cuda.synchronize()
    res["device operations"] = [e.name for e in prof.events()
                                if e.device_type == DeviceType.CUDA]
    print(json.dumps(res), flush=True)


def build_variants(_build, src: str) -> dict:
    out_dir = os.path.join(HERE, "build", "mse_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, (name, (edits, _u)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"variant {name}: {old!r} not in mse.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libv{i}.so")
        procs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for name, lib, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in log.splitlines() if "Used" in ln})
        spills = sum(1 for ln in log.splitlines() if "spill" in ln and
                     "0 bytes spill stores, 0 bytes spill loads" not in ln)
        print(f"  {name}: nvcc rc {proc.returncode}, registers {regs},"
              f" lines with spills {spills}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].vss_mse_sum.argtypes = \
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an unpacked checkout to time beside")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        time_tree(args.tree)
        return 0
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_mse_variants: torch sees no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import exact_u8_sum, mse_bound, time_ms
    from repro_torch.kernels import _build, mse, ref

    card = card_line()
    print(f"card: {card}", flush=True)
    with open(os.path.join(_build.CSRC_DIR, "mse.cu")) as f:
        libs = build_variants(_build, f.read())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    planes = inputs(torch)
    want = {k: exact_u8_sum(a, b) if a.dtype == torch.uint8
            else ref.mse_sum(a, b) for k, (a, b) in planes.items()}

    def call(lib, a, b, unroll=None, cluster=None):
        n, h, w = a.shape
        p = mse.plan(n, h * w, a.element_size(), a.data_ptr(), b.data_ptr(),
                     n_sm)
        if unroll and p.vec == 16:
            p = p._replace(unroll=unroll)
        if cluster:
            p = p._replace(cluster=cluster,
                           chunk=-(-(h * w * a.element_size() // p.vec)
                                   // cluster))
        out = torch.empty((n,), dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def go():
            err = lib.vss_mse_sum(a.data_ptr(), b.data_ptr(),
                                  a.element_size(), out.data_ptr(), n, h * w,
                                  p.vec, p.unroll, p.cluster, p.chunk, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out
        return go, p

    def agrees(got, key):
        if planes[key][0].dtype == torch.uint8:
            return torch.equal(got, want[key])
        return bool(((got - want[key]).abs() / want[key]).max() <= 1e-5)

    bounds = {k: mse_bound(a)[0] for k, (a, _b) in planes.items()}
    print("bound ms: " + ", ".join(f"{k} {v:.4f}" for k, v in bounds.items()))
    names = list(VARIANTS)
    for name in names + names[::-1]:
        row = []
        for key, (a, b) in planes.items():
            go, p = call(libs[name], a, b, unroll=VARIANTS[name][1])
            ok = agrees(go().clone(), key)
            t = time_ms(go, 20)
            row.append(f"{key} {t:.4f} ms ({bounds[key] / t:.0%} of bound"
                       f"{'' if ok else ', NOT EXACT'})")
        print(f"  {name:18s} " + "; ".join(row), flush=True)
    for cluster in (1, 2, 4, 8):
        row = []
        for key, (a, b) in planes.items():
            go, p = call(libs["shipped"], a, b, cluster=cluster)
            ok = agrees(go().clone(), key)
            row.append(f"{key} {time_ms(go, 20):.4f} ms"
                       f"{'' if ok else ', NOT EXACT'}")
        print(f"  shipped, clusters of {cluster}: " + "; ".join(row),
              flush=True)
    shape = SHAPES["uint8 (30,1080,1920)"][0]
    n = shape[0] * shape[1] * shape[2]
    buf = torch.randint(0, 256, (2, n + 16), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1),
                        dtype=torch.uint8)
    for off_a, off_b in ((0, 0), (2, 2), (4, 0), (1, 0)):
        a = buf[0, off_a:off_a + n].view(shape)
        b = buf[1, off_b:off_b + n].view(shape)
        go, p = call(libs["shipped"], a, b)
        ok = torch.equal(go().clone(), exact_u8_sum(a, b))
        print(f"  shipped, uint8 {shape} at +{off_a}/+{off_b} bytes:"
              f" {time_ms(go, 20):.4f} ms, {p.vec}-byte loads"
              f"{'' if ok else ', NOT EXACT'}", flush=True)
    print(f"  empty kernel (torch.cuda._sleep(0)):"
          f" {time_ms(lambda: torch.cuda._sleep(0), 20):.4f} ms", flush=True)
    if args.parent:
        for tree in (args.parent, HERE, HERE, args.parent):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree], check=True, timeout=600)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
