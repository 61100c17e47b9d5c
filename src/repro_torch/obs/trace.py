"""Per-request trace spans with bounded ring-buffer retention.

A `Span` is one timed region with attributes and children; `read_batch`
builds a ``read`` root per `ReadSpec` with ``plan`` → ``fetch`` →
``decode`` → ``admit`` children.  Unlike classic context-manager
tracing, batch execution is *phase-ordered across requests* (all plans,
then all fetches, ...), so children attach to an explicit parent rather
than to an ambient "current span" — `Tracer.span` takes ``parent=``.

Finished roots land in a fixed-size deque; `Tracer.recent()` returns
them oldest-first as plain dicts, and `export_jsonl` renders the JSON
lines form `VSS.recent_traces()` documents."""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

DEFAULT_TRACE_CAPACITY = 256


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
        """Timed region; attaches to ``parent`` or records as a root."""
        sp = Span(name, **attrs)
        try:
            yield sp
        finally:
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
