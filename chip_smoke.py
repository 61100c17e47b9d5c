#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of VSS (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc
and PyTorch built for CUDA.  In order it:

1. prints the card (``nvidia-smi`` name and power limit) and fails when
   torch sees no CUDA device;
2. builds the kernels from ``src/repro_torch/csrc`` (one nvcc per source,
   all started together) and prints the build time;
3. checks, for each tier's q, that the kernels' division-free quotient
   rounds every finite f32 residual as the plain versions' r / q does;
   then holds each CUDA kernel against its plain PyTorch version on the
   card, at a 1080p 30-frame GOP and at a ragged shape, for every codec
   tier and transcode combination; integer outputs and the
   integer-valued float outputs must be equal exactly.  It times the
   kernel and the plain version with CUDA events (mean over many calls
   queued back to back);
4. drives the storage manager end to end: ``VSS.write`` of a 1080p,
   90-frame synthetic road clip as ``hevc``, ``codec.transcode_gop`` of a
   stored GOP, and five ``VSS.read``s (whole clip, a time window, half
   resolution, re-encoded to ``h264``, a bilinear 2/3 resize).  Every
   decoded frame and blob must equal what the same operations give with
   ``device="cpu"`` (the plain versions; the bilinear resize within 1).
   Each of those seven paths runs with the launch counts set to 0 just
   before it and read just after, and in the CUDA run each must have
   launched exactly the kernels its plan needs;
5. prints one JSON line of per-kernel numbers, the card line, and the
   result line ``{"ok": true, "device": {...}}`` last.

Any failed phase raises, and the script exits non-zero without the
result line.  It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

from repro_torch import codec  # noqa: E402
from repro_torch.core.config import VSSConfig  # noqa: E402
from repro_torch.core.deferred import is_wrapped, unwrap_bytes  # noqa: E402
from repro_torch.core.store import VSS  # noqa: E402
from repro_torch.data.video import synthesize_road  # noqa: E402
from repro_torch.kernels import _build, delta_codec, ops, ref  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate, and the f32 rate outside the
# tensor cores (the kernels do scalar f32 work).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

GOP_1080P = (30, 3, 1080, 1920)  # (T, C, H, W): one GOP of the main path
RAGGED = (7, 3, 17, 130)
# (q, lo, hi, residual dtype) of the four tiers: tvc-ll, -hi, -med, -lo
TIERS = ((1.0, -32768, 32767, torch.int16), (2.0, -128, 127, torch.int8),
         (8.0, -128, 127, torch.int8), (24.0, -128, 127, torch.int8))
TRANSCODE_Q = ((2.0, 8.0), (8.0, 2.0), (1.0, 24.0))
# 3 is odd; 12 is past the factors whose input recon states the kernel
# keeps in registers.  Each divides 1080 and 1920.
FACTORS = (1, 2, 3, 4, 12)

KERNELS = {
    "delta_encode": ("src/repro_torch/csrc/delta_codec.cu",
                     "src/repro/kernels/delta_codec.py:61"),
    "delta_decode": ("src/repro_torch/csrc/delta_codec.cu",
                     "src/repro/kernels/delta_codec.py:103"),
    "transcode": ("src/repro_torch/csrc/transcode.cu",
                  "src/repro/kernels/transcode.py:76"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def tier_of(q: float):
    return next(t for t in TIERS if t[0] == q)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of one call, from CUDA events around ``reps`` calls
    queued back to back, so the host's per-call work (checks, ctypes)
    hides behind the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def _exact(name: str, what: str, pairs) -> float:
    """Exact agreement of kernel and plain outputs; returns max |Δ|."""
    err = max(_err(k, p) for k, p in pairs)
    ok = all(torch.equal(k, p) for k, p in pairs)
    print(f"  {name:12s} {what:44s} max|d|={err:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {what}: kernel != plain (max|d|={err})")
    return err


# -- bounds: bytes each input read once and each output written once,
# and the f32 operations the arithmetic needs, over the card's peaks ------

def _bound(nbytes: float, ops_f32: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_f32 / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encode_bound(t, c, h, w, rbytes):
    n = c * h * w
    # sub, mul, rint, max, min, mul, add, max, min per pixel and frame
    return _bound(t * n * 4 + n * 4 + (t - 1) * n * rbytes, 9 * (t - 1) * n)


def decode_bound(t, c, h, w, rbytes):
    n = c * h * w
    # mul, add, max, min per pixel and frame
    return _bound(n * 4 + (t - 1) * n * rbytes + t * n * 4, 4 * (t - 1) * n)


def transcode_bound(t, c, h, w, f, rin, rout):
    n_in, n_out = c * h * w, c * (h // f) * (w // f)
    nbytes = n_in * 4 + (t - 1) * n_in * rin + n_out * 4 + (t - 1) * n_out * rout
    # per input pixel: mul, add, max, min, sum; per output pixel: the
    # pooling multiply and the nine encode operations
    return _bound(nbytes, (t - 1) * (5 * n_in + 10 * n_out))


def check_kernels(device: str, shapes, reps: int, seed: int = 0):
    """Hold every kernel against its plain version at each shape; time
    both at the main path's shapes.  Returns per-kernel numbers."""
    rng = np.random.default_rng(seed)
    res = {k: {"max_abs_err": 0.0} for k in KERNELS}
    for label, (t, c, h, w) in shapes:
        frames = torch.from_numpy(
            rng.integers(0, 256, (t, c, h, w), dtype=np.uint8)
        ).to(device).to(torch.float32)
        main = label == "1080p"
        for q, lo, hi, rdt in TIERS:
            kw = dict(q=q, lo=lo, hi=hi, vmin=0.0, vmax=255.0)
            ik, rk = ops.delta_encode(frames, resid_dtype=rdt, **kw)
            ip, rp = ref.delta_encode(frames, **kw)
            rp = rp.to(rdt)
            what = f"{label} {tuple(frames.shape)} q={q:g} {rdt}"
            res["delta_encode"]["max_abs_err"] = max(
                res["delta_encode"]["max_abs_err"],
                _exact("delta_encode", what, [(ik, ip), (rk, rp)]))
            dkw = dict(q=q, vmin=0.0, vmax=255.0)
            dk = ops.delta_decode(ip, rp, **dkw)
            dp = ref.delta_decode(ip, rp, **dkw)
            res["delta_decode"]["max_abs_err"] = max(
                res["delta_decode"]["max_abs_err"],
                _exact("delta_decode", what, [(dk, dp)]))
            if main and q == 2.0:
                rb = rk.element_size()
                res["delta_encode"].update(
                    ms=time_ms(lambda: ops.delta_encode(
                        frames, resid_dtype=rdt, **kw), reps),
                    plain_ms=time_ms(
                        lambda: ref.delta_encode(frames, **kw), reps),
                    shape=list(frames.shape), dtype=str(rdt))
                res["delta_encode"]["bound_ms"], \
                    res["delta_encode"]["bound_by"] = encode_bound(
                        t, c, h, w, rb)
                res["delta_decode"].update(
                    ms=time_ms(lambda: ops.delta_decode(ip, rp, **dkw), reps),
                    plain_ms=time_ms(
                        lambda: ref.delta_decode(ip, rp, **dkw), reps),
                    shape=list(dk.shape), dtype=str(rdt))
                res["delta_decode"]["bound_ms"], \
                    res["delta_decode"]["bound_by"] = decode_bound(
                        t, c, h, w, rb)
        del frames
        for f in FACTORS:
            # at the ragged shape the OUTPUT is ragged: the input is f
            # times larger, since f must divide it
            ih, iw = (h, w) if main else (h * f, w * f)
            src = torch.from_numpy(
                rng.integers(0, 256, (t, c, ih, iw), dtype=np.uint8)
            ).to(device).to(torch.float32)
            for q_in, q_out in TRANSCODE_Q:
                _, lo_in, hi_in, rdt_in = tier_of(q_in)
                _, lo, hi, rdt_out = tier_of(q_out)
                ifr, rin = ref.delta_encode(src, q=q_in, lo=lo_in, hi=hi_in,
                                            vmin=0.0, vmax=255.0)
                rin = rin.to(rdt_in)
                kw = dict(q_in=q_in, q_out=q_out, factor=f, lo=lo, hi=hi,
                          vmin=0.0, vmax=255.0)
                iok, rok = ops.transcode(ifr, rin, resid_dtype=rdt_out, **kw)
                iop, rop = ref.transcode(ifr, rin, **kw)
                what = (f"{label} {(t, c, ih, iw)} f={f} q={q_in:g}->"
                        f"{q_out:g}")
                res["transcode"]["max_abs_err"] = max(
                    res["transcode"]["max_abs_err"],
                    _exact("transcode", what,
                           [(iok, iop), (rok, rop.to(rdt_out))]))
                if main and f == 2 and (q_in, q_out) == (2.0, 8.0):
                    res["transcode"].update(
                        ms=time_ms(lambda: ops.transcode(
                            ifr, rin, resid_dtype=rdt_out, **kw), reps),
                        plain_ms=time_ms(
                            lambda: ref.transcode(ifr, rin, **kw), reps),
                        shape=[t, c, ih, iw], dtype=f"{rdt_in}->{rdt_out}")
                    res["transcode"]["bound_ms"], \
                        res["transcode"]["bound_by"] = transcode_bound(
                            t, c, ih, iw, f, rin.element_size(),
                            rok.element_size())
            del src
    return res


def reads_for(clip: np.ndarray):
    """The main path's reads, each with the codecs its plan must read from
    and the kernel launches it must make, given the GOPs written and the
    GOPs it returns encoded.  The first read decodes every stored GOP and
    the cache keeps an rgb view of the clip, which serves every later
    read without a decode: the h264 read re-encodes from that view, and
    its ``frames`` decode what it encoded.  The 2/3 resize is no integer
    factor and so runs the bilinear path on the device; it comes last,
    because its cached view differs by up to 1 between devices."""
    _t, h, w, _c = clip.shape
    third = (w * 2 // 3, h * 2 // 3)
    return (
        ("whole clip as rgb", {}, {"tvc-hi"},
         lambda n, n_out: {"delta_decode": n}),
        ("t=(0.5, 1.7)", {"t": (0.5, 1.7)}, {"rgb"}, lambda n, n_out: {}),
        (f"resolution={(w // 2, h // 2)}", {"resolution": (w // 2, h // 2)},
         {"rgb"}, lambda n, n_out: {}),
        ("codec=h264", {"codec": "h264"}, {"rgb"},
         lambda n, n_out: {"delta_encode": n_out, "delta_decode": n_out}),
        (f"bilinear resolution={third}", {"resolution": third}, {"rgb"},
         lambda n, n_out: {}),
    )


def drive_store(root: str, clip: np.ndarray, device: str):
    """The storage manager's main path on ``device``: one write, a
    transcode of the first stored GOP, and five reads.  Each path runs
    with the launch counts set to 0 just before it and read just after.
    Returns every output, the wall times, the counts per path and the
    codecs each read's plan read from."""
    vss = VSS(root, config=VSSConfig(device=device, backend="local"))
    out = {"reads": {}, "secs": {}, "launches": {}, "sources": {},
           "spans": {}}

    def path(name, fn):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        out["secs"][name] = time.perf_counter() - t0
        out["launches"][name] = ops.launch_counts()
        return result

    path("write", lambda: vss.write("road", clip, codec="hevc"))
    gops = vss.catalog.gops_for(vss.catalog.get_original_id("road"))
    out["n_gops"] = len(gops)
    data = vss.backend.get(gops[0].path)
    if is_wrapped(data):
        data = unwrap_bytes(data)
    enc = codec.deserialize_gop(data)
    out["transcode_gop"] = codec.serialize_gop(path(
        "transcode_gop", lambda: codec.transcode_gop(
            enc, "tvc-med", scale_factor=2, device=device)))
    for name, kw, _src, _want in reads_for(clip):
        def read():
            r = vss.read("road", **kw)
            return r, r.frames
        r, frames = path(name, read)
        blobs = ([codec.serialize_gop(e) for e in r.encoded]
                 if r.encoded is not None else None)
        out["reads"][name] = (frames, blobs)
        plan = r.plan
        out["sources"][name] = {
            plan.runs[plan.run_idx(i)].physical.codec
            for i in range(len(plan.segments))}
        # the store's own trace of this read: plan, fetch, decode, admit
        spans = vss.recent_traces(1)[0].get("children", [])
        out["spans"][name] = {sp["name"]: sp["dur_s"] for sp in spans}
    vss.close()
    return out


def check_launches(run, clip: np.ndarray) -> None:
    """Every path of the CUDA run launched exactly the kernels its plan
    needs, and each read was planned from the codecs it expects: a path
    that ran on the host instead, or a plan that changed, fails here."""
    n = run["n_gops"]
    want = {"write": {"delta_encode": n}, "transcode_gop": {"transcode": 1}}
    for name, _kw, src, counts in reads_for(clip):
        blobs = run["reads"][name][1]
        want[name] = counts(n, len(blobs) if blobs is not None else 0)
        if run["sources"][name] != src:
            raise AssertionError(
                f"read {name} was planned from {run['sources'][name]},"
                f" expected {src}")
    for name, counts in want.items():
        got = run["launches"][name]
        print(f"  launches in {name}: {got}"
              + (f" (planned from {sorted(run['sources'][name])})"
                 if name in run["sources"] else ""))
        if got != counts:
            raise AssertionError(
                f"{name} launched {got}, expected {counts}; every path:"
                f" {run['launches']}")
    for kernel in KERNELS:
        if not any(c.get(kernel) for c in run["launches"].values()):
            raise AssertionError(f"main path never launched {kernel}")


def compare_runs(gpu, cpu, clip: np.ndarray) -> None:
    t, h, w, c = clip.shape
    for name, _kw, _src, _want in reads_for(clip):
        fg, bg = gpu["reads"][name]
        fc, bc = cpu["reads"][name]
        if fg.shape != fc.shape:
            raise AssertionError(f"read {name}: {fg.shape} != {fc.shape}")
        if name.startswith("bilinear"):
            # the weighted sums run in another order on each device: a
            # value within rounding of .5 may land on either side
            d = int(np.abs(fg.astype(np.int16) - fc.astype(np.int16)).max())
            if d > 1:
                raise AssertionError(f"read {name}: max|d|={d} > 1")
            print(f"  read {name:24s} frames {fg.shape} within {d} of cpu")
            continue
        if not np.array_equal(fg, fc):
            raise AssertionError(f"read {name}: cuda frames != cpu frames")
        if bg != bc:
            raise AssertionError(f"read {name}: cuda blobs != cpu blobs")
        print(f"  read {name:24s} frames {fg.shape} equal on cuda and cpu"
              + (f", {len(bg)} blobs equal" if bg is not None else ""))
    whole = gpu["reads"]["whole clip as rgb"][0]
    if whole.shape != clip.shape:
        raise AssertionError(f"whole read shape {whole.shape} != {clip.shape}")
    err = int(np.abs(whole.astype(np.int16) - clip.astype(np.int16)).max())
    if err > 2:  # tvc-hi (q = 2) reconstructs within 2 of the source
        raise AssertionError(f"hevc round trip max|d|={err} > 2")
    print(f"  whole clip vs source: max|d|={err} (tvc-hi allows 2)")
    if gpu["reads"][f"resolution={(w // 2, h // 2)}"][0].shape != (
            t, h // 2, w // 2, c):
        raise AssertionError("half-resolution read has the wrong shape")
    if gpu["transcode_gop"] != cpu["transcode_gop"]:
        raise AssertionError("transcode_gop: cuda blob != cpu blob")
    hdr = codec.parse_gop_header(gpu["transcode_gop"])
    print(f"  transcode_gop -> {hdr[0]} {hdr[1]}: blob equal on cuda and cpu")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {kind}", flush=True)

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall; nvcc per source "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()), flush=True)
    for name in _build.SOURCES:
        log = _build.ptxas_log(name)
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, 0 bytes"
                      " spill loads")]
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines() if "Used" in ln]
        print(f"ptxas {name}: {len(regs)} kernels, registers"
              f" {sorted(set(regs))}, lines with spills: {len(spills)}")

    for q, _lo, _hi, _rdt in TIERS:
        bad = delta_codec.quotient_mismatches(q)
        print(f"  quotient by q={q:g}: {bad} of the finite f32 residuals"
              " round otherwise than r / q")
        if bad:
            raise AssertionError(f"kernel quotient by {q} is not r / q")
    print("kernels vs plain versions on the card (exact):", flush=True)
    knum = check_kernels("cuda", (("1080p", GOP_1080P), ("ragged", RAGGED)),
                         reps=20)
    for name, r in knum.items():
        print(f"  {name:12s} at {r['shape']} {r['dtype']}: kernel"
              f" {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound"
              f" {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")

    print("main path: VSS write/read of a 1080p 90-frame clip", flush=True)
    clip = synthesize_road(90, width=1920, height=1080, seed=0)
    with tempfile.TemporaryDirectory() as d_gpu:
        gpu = drive_store(os.path.join(d_gpu, "vss"), clip, "cuda")
    check_launches(gpu, clip)
    with tempfile.TemporaryDirectory() as d_cpu:
        cpu = drive_store(os.path.join(d_cpu, "vss"), clip, "cpu")
    compare_runs(gpu, cpu, clip)
    n = clip.shape[0]
    print(f"  write 90 frames as hevc: {gpu['secs']['write']:.3f} s,"
          f" {n / gpu['secs']['write']:.1f} frames/s [{card}]")
    for name, _kw, _src, _want in reads_for(clip):
        frames = gpu["reads"][name][0]
        s = gpu["secs"][name]
        print(f"  read {name}: {s:.3f} s, {frames.shape[0] / s:.1f}"
              f" frames/s [{card}]")
    print(f"  transcode_gop tvc-hi -> tvc-med x1/2:"
          f" {gpu['secs']['transcode_gop']:.3f} s [{card}]")
    for name, spans in gpu["spans"].items():
        print(f"  spans of read {name}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in spans.items()))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = knum[name]
        by_path = {p: c[name] for p, c in gpu["launches"].items() if name in c}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
