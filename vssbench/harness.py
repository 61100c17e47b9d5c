"""One run of one benchmark cell: set-up, a measured window, the check.

Everything that belongs to one cell lives in files found by name:

- ``BENCHMARK.json`` (repository root) names the cell's configuration and
  traffic, and lists the metrics;
- ``configs/<config>.json`` is the deployment (frame size, fps, GOP, tier,
  store constants, stored seconds);
- ``traffic/<traffic>.json`` is the request mix; its ``kind`` names the
  generator ``traffic/<kind>.py``, which sets the store up, drives the
  window and checks the answers against ``reference/``;
- ``workloads/<cell>.json`` holds the cell's own set-up sizes;
- ``metrics/<metric>.py`` reads one metric from the run (``read(run)``,
  None when there is nothing to read).

A later cell, mix or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SEED_MASK = (1 << 63) - 1


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclasses.dataclass
class Request:
    """One request of the window, as the client saw it."""

    kind: str
    t_start: float  # perf_counter seconds
    t_end: float = 0.0
    frames: int = 0
    ok: bool = False
    error: str = ""
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    answer: Any = None  # what the program returned, kept for the check

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class Check:
    """One number compared with its limit; ``le`` means value <= limit."""

    name: str
    value: float
    limit: float
    le: bool = True

    @property
    def passed(self) -> bool:
        if not math.isfinite(self.value):
            return False
        return self.value <= self.limit if self.le else \
            self.value >= self.limit


class Run:
    """State of one run, shared by the traffic module and the readers."""

    def __init__(self, cell: str, *, seed: int, seconds: float, trace: bool,
                 device: str, bench: Optional[dict] = None,
                 shrink: Optional[Dict[str, Any]] = None,
                 control: bool = False):
        self.bench = bench if bench is not None else load_json(
            ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if cell not in entries:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
        self.cell = cell
        self.entry = entries[cell]
        self.config = load_json(PKG / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(
            PKG / "traffic" / f"{self.entry['traffic']}.json")
        self.workload = load_json(PKG / "workloads" / f"{cell}.json")
        if shrink:
            # CPU rehearsals only: a smaller frame and clip, same code
            self.config = {**self.config, **shrink}
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.control = control
        self.requests: List[Request] = []
        self.window_s: float = 0.0
        self.counters: Dict[str, float] = {}
        self.values: Dict[str, float] = {}
        self.probes = None
        self.devtrace = None
        self.checks: List[Check] = []
        self.state: Dict[str, Any] = {}
        self.tmp = tempfile.mkdtemp(prefix="vssbench-")

    # -- seeds -------------------------------------------------------------
    def subseed(self, tag: str) -> int:
        """A 63-bit seed for one purpose, derived from the run's seed."""
        digest = hashlib.sha256(f"{self.seed}:{tag}".encode()).digest()
        return int.from_bytes(digest[:8], "little") & SEED_MASK

    def rng(self, tag: str) -> np.random.Generator:
        return np.random.default_rng(self.subseed(tag))

    # -- helpers for traffic modules ---------------------------------------
    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def cleanup(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import one file of the benchmark by path (metric files carry dots
    in their names, so they are not importable by module name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_module(run: Run):
    kind = run.traffic["kind"]
    return load_module(PKG / "traffic" / f"{kind}.py",
                       f"vssbench_traffic_{kind}")


def metric_reader(name: str) -> Callable[[Run], Optional[float]]:
    mod = load_module(PKG / "metrics" / f"{name}.py",
                      "vssbench_metric_" + name.replace(".", "_"))
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones
    without ``--trace``, the per-layer ones with it."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def check_device(chips: int, device: str) -> None:
    if device == "cpu":
        return
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch sees no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, torch sees"
                       f" {torch.cuda.device_count()}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


WITNESS_BYTES = 16 << 20


def host_witness() -> Dict[str, float]:
    """Readings of the host's own speed and load, the same work in every
    run: seconds to deflate a fixed buffer at the codec's zlib level, and
    the load average and CPU and I/O pressure where the kernel gives
    them.  They explain a run that is slow for reasons outside the cell."""
    buf = np.random.default_rng(2103_16604).integers(
        0, 24, WITNESS_BYTES, dtype=np.uint8).tobytes()
    t = time.perf_counter()
    zlib.compress(buf, 3)
    out = {"witness_zlib_s": time.perf_counter() - t}
    try:
        out["loadavg_1m"] = float(open("/proc/loadavg").read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    for kind in ("cpu", "io"):
        try:
            with open(f"/proc/pressure/{kind}") as f:
                some = f.readline().split()
            out[f"{kind}_pressure_avg60"] = float(some[2].split("=")[1])
        except (OSError, ValueError, IndexError):
            pass
    return out


def cpu_seconds() -> Dict[str, float]:
    """This process's CPU seconds and involuntary context switches."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime,
            "involuntary_switches": float(ru.ru_nivcsw)}


def execute(cell: str, *, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_process: Optional[float] = None,
            shrink: Optional[Dict[str, Any]] = None, control: bool = False,
            bench: Optional[dict] = None, log=sys.stderr,
            own_process: bool = True) -> dict:
    """Run one cell once and return its result object (the last line).

    ``own_process`` (the command line) refuses a run in whose process JAX
    or the JAX package got loaded; a test that shares its process with
    other tests turns that off."""
    t0 = t_process if t_process is not None else time.perf_counter()
    run = Run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
              bench=bench, shrink=shrink, control=control)
    try:
        return _execute(run, t0, log, own_process)
    finally:
        run.cleanup()


def _execute(run: Run, t0: float, log, own_process: bool) -> dict:
    check_device(int(run.entry.get("chips", 1)), run.device)
    import torch

    from vssbench import devtrace, probes

    traffic = traffic_module(run)
    if run.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    traffic.setup(run)
    run.sync()
    prof = None
    if run.trace:
        run.probes = probes.install(run.device)
        prof = devtrace.start(run.device)
    cpu0 = cpu_seconds()
    t_window = time.perf_counter()
    setup_s = t_window - t0
    traffic.window(run)
    run.sync()
    cpu1 = cpu_seconds()
    if run.trace:
        run.devtrace = devtrace.stop(prof, run.device)
        probes.uninstall(run.probes)
    memory_peak = (torch.cuda.max_memory_allocated()
                   if run.device != "cpu" else 0)
    run.values.update({f"window_{k}": cpu1[k] - cpu0[k] for k in cpu1})
    run.values.update(host_witness())
    traffic.release(run)
    t_check = time.perf_counter()
    traffic.check(run)
    check_s = time.perf_counter() - t_check
    run.values["setup_s"] = setup_s

    metrics: Dict[str, dict] = {}
    for m in cell_metrics(run.bench, run.cell, run.trace):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # last, once the reference and the readers have run too
    found = forbidden_modules() if own_process else []
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: {found}")
    failed = sum(1 for r in run.requests if not r.ok)
    correct = failed == 0 and all(c.passed for c in run.checks)
    if run.device != "cpu":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(run.entry.get("chips", 1)),
               "memory_peak_bytes": int(memory_peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result: Dict[str, Any] = {
        "correct": correct, "attempted": len(run.requests),
        "failed": failed, "metrics": metrics, "device": dev}
    if run.trace and run.devtrace is not None:
        dev["busy_s"] = run.devtrace.busy_s
        dev["window_s"] = run.devtrace.window_s
        result["breakdown"] = run.devtrace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                                 "rule": "<=" if c.le else ">="}
                        for c in run.checks}
    print(f"# cell {run.cell} seed {run.seed} window {run.window_s:.3f} s"
          f" setup {setup_s:.3f} s check {check_s:.3f} s"
          f" requests {len(run.requests)} failed {failed}"
          f" card {power_limit()}", file=log)
    print("# values " + json.dumps(run.values), file=log)
    print("# requests (kind, frames, ms) " + json.dumps(
        [[r.kind + "".join(f":{r.params[k]}" for k in ("codec", "scale")
                           if k in r.params), r.frames,
          round(1e3 * r.seconds, 1)] for r in run.requests]), file=log)
    for r in run.requests:
        if not r.ok:
            print(f"# failed {r.kind} {r.params}: {r.error}", file=log)
    for c in run.checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r}"
              f" ({'<=' if c.le else '>='}) {'ok' if c.passed else 'FAIL'}",
              file=log)
    return result
