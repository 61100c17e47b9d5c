"""The device's side of a traced window, from ``torch.profiler``.

The profiler records host ranges and the card's kernels, copies and
sets over the window.  From them:

- ``busy_s``: the union of the device's activity inside the window;
- ``window_s``: the length of the window's own host range;
- ``device_ops``: device seconds by operation name, the largest first;
- ``idle_gaps``: the seconds in which the device did nothing, by the
  innermost ``vss.*`` range open on the host at the middle of each gap;
- ``entry_s``: device seconds of the work each codec entry launched:
  every device operation whose launch (matched by correlation id) lies
  inside the entry's ``vss.kernel.<entry>`` host range on the launching
  thread, whatever the kernel is called.  A CUDA-event pair around the
  call would also time the launch's host gap and whatever another thread
  queued on the same stream.

Ranges that ``record_function`` mirrors onto the device's timeline are
annotations, not activity, and are left out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Tuple

import torch

WINDOW_LABEL = "vssbench.window"
ENTRY_PREFIX = "vss.kernel."
# CUDA API calls (cudaLaunchKernel, cuLaunchKernelEx, ...):
# the host side of a device operation, sharing its correlation id
LAUNCH = re.compile(r"^cu(da)?[A-Z]")
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    entry_s: Dict[str, float]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self) -> Dict[str, List]:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:TOP]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:TOP]]}


class _Session:
    def __init__(self, device: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # the writers' and the pipeline's threads too: a trace of the
        # main thread alone would miss most of the work
        try:
            cfg = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError) as exc:
            raise RuntimeError("this torch cannot profile every thread"
                               f" ({exc}); a traced run needs it") from exc
        self.prof = torch.profiler.profile(activities=acts,
                                           experimental_config=cfg)
        self.stack = contextlib.ExitStack()


def start(device: str) -> _Session:
    s = _Session(device)
    s.stack.enter_context(s.prof)
    s.stack.enter_context(torch.profiler.record_function(WINDOW_LABEL))
    return s


@dataclasses.dataclass
class _Event:
    name: str
    device: bool
    start: int  # ns
    end: int
    corr: int = 0  # correlation id: a launch and its device operation
    linked: int = 0  # a device operation's enclosing host op, by its id
    thread: int = 0  # the system thread of a host event


def _raw_events(prof) -> List[_Event]:
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and e.is_user_annotation():
            continue
        start = e.start_ns()
        # host ops and runtime calls both give their system thread here
        # (``start_thread_id`` numbers a host op's thread its own way)
        thread = (e.device_resource_id() if hasattr(e, "device_resource_id")
                  else e.start_thread_id())
        out.append(_Event(e.name(), dev, start, start + e.duration_ns(),
                          e.correlation_id(), e.linked_correlation_id(),
                          thread))
    return out


def _entry_seconds(events: List[_Event]) -> Dict[str, float]:
    """Device seconds of everything each ``vss.kernel.<entry>`` host range
    launched: a device operation counts for the entry when its launch
    call, or the host op it is linked to, lies inside that range on the
    same thread."""
    ranges: Dict[int, List[Tuple[int, int, str]]] = {}
    op_entry: Dict[int, str] = {}  # a range's own id -> its entry
    for e in events:
        if not e.device and e.name.startswith(ENTRY_PREFIX):
            entry = e.name[len(ENTRY_PREFIX):]
            ranges.setdefault(e.thread, []).append((e.start, e.end, entry))
            if e.corr:
                op_entry[e.corr] = entry
    launch_entry: Dict[int, str] = {}
    for e in events:
        if e.device or not e.corr or not LAUNCH.match(e.name):
            continue
        for a, b, entry in ranges.get(e.thread, ()):
            if a <= e.start and e.end <= b:
                launch_entry[e.corr] = entry
                break
    out: Dict[str, float] = {}
    for e in events:
        if not e.device:
            continue
        entry = launch_entry.get(e.corr) or op_entry.get(e.linked)
        if entry is not None:
            out[entry] = out.get(entry, 0.0) + (e.end - e.start) / 1e9
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def stop(s: _Session, device: str) -> DeviceTrace:
    if device != "cpu":
        torch.cuda.synchronize()
    s.stack.close()
    events = _raw_events(s.prof)
    wins = [(e.start, e.end) for e in events
            if e.name == WINDOW_LABEL and not e.device]
    w0, w1 = wins[0]
    dev_iv = []
    by_name: Dict[str, float] = {}
    for e in events:
        if not e.device or e.end <= w0 or e.start >= w1:
            continue
        a, b = max(e.start, w0), min(e.end, w1)
        dev_iv.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e9
    busy = _union(dev_iv)
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if w1 > prev:
        gaps.append((prev, w1))
    labels = sorted((e.start, e.end, e.name) for e in events
                    if not e.device and e.name.startswith("vss."))
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name = "host outside the program's entry points"
        best = -1
        for la, lb, ln in labels:
            if la > mid:
                break
            if lb >= mid and la > best:
                best, name = la, ln
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    return DeviceTrace(
        busy_s=busy_s, window_s=(w1 - w0) / 1e9,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1]),
        entry_s=_entry_seconds([e for e in events
                                if e.end > w0 and e.start < w1]))
