"""Spans: the program's own tracing, timed where the work happens.

`span` is the one primitive.  A span

- times itself: it opens and closes around the work it names;
- mirrors itself onto the profiler's clock: while a ``torch.profiler``
  session records (on any thread), it opens a
  ``torch.profiler.record_function`` range named ``vss.<layer>.<stage>``
  for its extent, so a device trace can name what the host was doing
  while the card idled.  With no profiler running it reads one flag and
  constructs no ``RecordFunction``;
- attaches to the span open in the current context (a
  ``contextvars.ContextVar``), or to an explicit ``parent=``.  With no
  parent it builds no tree node at all and only mirrors.

`read_batch` builds a ``read`` root per `ReadSpec` with ``plan`` →
``fetch`` → ``decode`` → ``admit`` children.  Batch execution is
*phase-ordered across requests* (all plans, then all fetches, ...), so
those children name their root through ``parent=``; the spans below
them (codec, resample, ranged fetches, admission's steps) find their
parent through the context.  Ingest and deferred-compression spans run
outside any read and only mirror.

Every duration is measured around its work, none apportioned: a plan
group's ``batch_get`` is one round trip, so its seconds go on the first
member's ``fetch`` span and the others carry ``shared: true``; ``decode``
is timed around the execution, its inline fetches included.  Below
``decode`` and ``admit`` each stage is a child of its own (``fetch``,
``inflate.<coder>``, ``h2d``, ``d2h``, ``deflate.<coder>``,
``rgb_unpack``, ``resample_box``, ``concat``, ``stitch``,
``reconstruct``, a joint GOP's rebuild, with its own ``fetch``, codec,
``rebuild_warp`` and ``rebuild_concat`` children; ``admit_step_mse``,
``admit_put``, ``admit_catalog``), where ``<coder>`` is ``zstd`` or
``zlib``, whichever ran.  Range names never
start with ``vss.kernel.`` and never take the names a benchmark wraps
around the program's entry points (``vss.read``, ``vss.append``,
``vss.close``, ``vss.encode_gop``, ``vss.decode_gop``).

Finished roots land in a fixed-size deque; `Tracer.recent()` returns
them oldest-first as plain dicts, and `export_jsonl` renders the JSON
lines form `VSS.recent_traces()` documents."""

from __future__ import annotations

import contextlib
import contextvars
import json
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import torch.autograd.profiler as _profiler

DEFAULT_TRACE_CAPACITY = 256

# the tree node the running span adds to, per thread and per context
_current: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_span", default=None)
_AMBIENT = object()  # span(parent=...) default: the context's open span
_NOTHING = contextlib.nullcontext()


class Span:
    __slots__ = ("name", "t_wall", "dur_s", "attrs", "children", "_t0")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        self.dur_s: float = 0.0
        self.attrs: Dict[str, object] = attrs
        self.children: List["Span"] = []

    def finish(self) -> "Span":
        self.dur_s = time.perf_counter() - self._t0
        return self

    def child(self, name: str, **attrs) -> "Span":
        sp = Span(name, **attrs)
        self.children.append(sp)
        return sp

    def to_dict(self) -> Dict:
        d: Dict[str, object] = {
            "name": self.name,
            "t_wall": self.t_wall,
            "dur_s": self.dur_s,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class _Open:
    """One span while it runs (see `span`).  ``seconds`` holds the
    region's measured duration once it has ended; a tree node gets the
    same figure as its ``dur_s``."""

    __slots__ = ("_range", "_name", "_parent", "_attrs", "_node", "_token",
                 "_rf", "_t0", "seconds")

    def __init__(self, range_name, name, parent, attrs):
        self._range = range_name
        self._name = name
        self._parent = parent
        self._attrs = attrs
        self._node: Optional[Span] = None
        self._rf = None
        self.seconds = 0.0

    def __enter__(self) -> Optional[Span]:
        if self._range is not None:
            self._rf = _profiler.record_function(self._range)
            self._rf.__enter__()
        if self._parent is not None:
            self._node = Span(self._name, **self._attrs)
            self._token = _current.set(self._node)
        self._t0 = time.perf_counter()
        return self._node

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        node = self._node
        if node is not None:
            node.dur_s = self.seconds
            _current.reset(self._token)
            self._parent.children.append(node)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(range_name: Optional[str], *, name: Optional[str] = None,
         parent=_AMBIENT, timed: bool = False, **attrs):
    """A timed region of the program, as a context manager.

    ``range_name`` is the profiler range (``vss.<layer>.<stage>``), or
    None for a tree node that no range mirrors.  The tree node is called
    ``name``, by default the range name after ``vss.<layer>.``, and is
    added to ``parent`` (by default the span open in this context) when
    the region ends; ``with`` binds it, or None when no node is built.
    With neither a parent nor a profiler running this costs a flag read
    and a context lookup, and builds nothing, unless ``timed``: then the
    returned object always measures, and its ``seconds`` is the
    region's duration once it has ended (the store's ``fetch_seconds``
    and ``plan_seconds`` are read from it)."""
    if parent is _AMBIENT:
        parent = _current.get()
    # set while any torch.profiler session records, whatever the thread
    # (torch.autograd._profiler_enabled() reads False inside a kineto
    # session)
    mirror = range_name if _profiler._is_profiler_enabled else None
    if parent is None:
        if mirror is None and not timed:
            return _NOTHING
        return _Open(mirror, None, None, {})
    if name is None:
        name = range_name.split(".", 2)[2]
    return _Open(mirror, name, parent, attrs)


class Tracer:
    """Bounded retention of finished root spans.

    ``enabled=False`` keeps `record` a no-op; span objects themselves
    are cheap enough that callers may build them unconditionally."""

    def __init__(self, capacity: int = DEFAULT_TRACE_CAPACITY,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))

    def record(self, root: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._ring.append(root)

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None,
             **attrs) -> Iterator[Span]:
        """Timed region; attaches to ``parent`` or records as a root.
        Spans opened inside it attach to it."""
        sp = Span(name, **attrs)
        token = _current.set(sp)
        try:
            yield sp
        finally:
            _current.reset(token)
            sp.finish()
            if parent is not None:
                parent.children.append(sp)
            else:
                self.record(sp)

    def recent(self, n: Optional[int] = None) -> List[Dict]:
        """Oldest-first dicts of the last ``n`` (default: all retained)
        root spans."""
        with self._lock:
            roots = list(self._ring)
        if n is not None:
            roots = roots[-int(n):]
        return [r.to_dict() for r in roots]

    def export_jsonl(self, n: Optional[int] = None) -> str:
        """One JSON document per retained root span, newline-separated."""
        return "\n".join(
            json.dumps(d, default=str) for d in self.recent(n)
        )

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
