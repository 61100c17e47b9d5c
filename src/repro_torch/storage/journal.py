"""Append-only write-back journal — crash durability for the dirty set.

A write-back `TieredBackend` acknowledges ``put`` after admitting the
bytes to a volatile memory tier; before this journal existed, a
process crash simply lost every acknowledged-but-unflushed object.
The journal closes that hole the way VStore's fast/durable format
split (and every write-ahead log) does: each dirty admission is
appended to a local append-only segment file and **fsync'd before the
put returns**, so the acknowledgement is backed by bytes on disk, and
startup replay rebuilds the dirty set from whatever the crash left.

On-disk format — segment files ``seg-<n>.vssj`` under the journal
directory, each starting with the magic ``b"VSSJ1\\n"`` followed by
records:

    header  struct "<BIIQI": type, key_len, data_len, seq, crc32
    body    key bytes (utf-8) + data bytes

``crc32`` covers ``type|seq|key|data``; a record that fails the
checksum (or runs past the end of the file) marks the **truncated
tail** a crash mid-append leaves behind — replay stops at the first
bad record of a segment and keeps everything before it.  Record types:

    PUT (1)     key acknowledged dirty with these bytes
    COMMIT (2)  key's PUT has landed on the cold tier (not fsync'd —
                losing one is safe because replay cross-checks the
                cold tier before re-queueing an upload)
    DELETE (3)  key deleted (fsync'd: replaying a lost delete would
                resurrect the object on the cold tier)

Reclamation is by **watermark over whole segments**: each segment
tracks how many of its PUTs are still uncommitted; when a sealed
segment's count reaches zero (every write it journals is durable on
the cold tier) the file is unlinked.  The active segment seals when it
passes ``segment_bytes``, so a steadily-flushing store keeps O(1)
journal files of bounded size.

Appends are serialized by an internal lock; ``append_puts`` journals a
whole admission group under **one fsync**, which is what keeps the
write-back throughput cost of durability to a single disk flush per
``batch_put`` instead of one per object.
"""
from __future__ import annotations

import io
import os
import re
import struct
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.registry import default_registry

MAGIC = b"VSSJ1\n"
_HEADER = struct.Struct("<BIIQI")  # type, key_len, data_len, seq, crc32

T_PUT = 1
T_COMMIT = 2
T_DELETE = 3

DEFAULT_SEGMENT_BYTES = 16 * 1024 * 1024

_SEG_RE = re.compile(r"^seg-(\d{16})\.vssj$")


def _crc(rtype: int, seq: int, key: bytes, data: bytes) -> int:
    c = zlib.crc32(bytes((rtype,)))
    c = zlib.crc32(seq.to_bytes(8, "little"), c)
    c = zlib.crc32(key, c)
    return zlib.crc32(data, c) & 0xFFFFFFFF


class WriteBackJournal:
    """Per-store journal of acknowledged-but-unflushed write-back
    objects.  `TieredBackend` drives it: ``append_put(s)`` on dirty
    admission (fsync'd before the put acknowledges), ``append_commit``
    when a flush lands, ``append_delete`` on delete, ``replay()`` at
    startup to rebuild the dirty set."""

    def __init__(self, dirname: str, *,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 fsync: bool = True, registry=None):
        self.dirname = dirname
        self.segment_bytes = max(4096, int(segment_bytes))
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh: Optional[io.BufferedWriter] = None
        self._seq = 0
        self._active: Optional[int] = None      # active segment index
        self._active_bytes = 0
        # key -> segment index of its latest (uncommitted) PUT
        self._live: Dict[str, int] = {}
        # segment index -> count of still-uncommitted PUTs in it
        self._pending: Dict[int, int] = {}
        os.makedirs(dirname, exist_ok=True)
        reg = registry or default_registry()
        self._c_appends = reg.counter(
            "vss_journal_appends_total", "journal records appended")
        self._c_bytes = reg.counter(
            "vss_journal_bytes_total", "journal bytes written")
        self._c_fsyncs = reg.counter(
            "vss_journal_fsyncs_total", "journal fsync barriers paid")
        self._c_replayed = reg.counter(
            "vss_journal_replayed_total",
            "unflushed records recovered by startup replay")
        self._c_reclaimed = reg.counter(
            "vss_journal_segments_reclaimed_total",
            "fully-flushed segments unlinked by the watermark")
        self._c_truncated = reg.counter(
            "vss_journal_truncated_tails_total",
            "segments whose torn tail record was discarded at replay")
        reg.gauge_fn("vss_journal_segments", self._segment_count,
                     "journal segment files on disk")
        reg.gauge_fn("vss_journal_pending_objects", self._pending_count,
                     "journaled objects not yet durable on the cold tier")

    # -- gauge samplers ----------------------------------------------------
    def _segment_count(self) -> float:
        with self._lock:
            n = len(self._pending)
            if self._active is not None and self._active not in self._pending:
                n += 1
            return n

    def _pending_count(self) -> float:
        with self._lock:
            return len(self._live)

    # -- segment bookkeeping ----------------------------------------------
    def _segments_on_disk(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.dirname)
        except FileNotFoundError:
            return out
        for name in names:
            m = _SEG_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _seg_path(self, idx: int) -> str:
        return os.path.join(self.dirname, f"seg-{idx:016d}.vssj")

    def _open_active_locked(self) -> io.BufferedWriter:
        if self._fh is None:
            on_disk = self._segments_on_disk()
            idx = (max(on_disk) + 1) if on_disk else 0
            # never append to a pre-existing segment: its tail may be
            # torn, and replay's stop-at-first-bad-record rule would
            # then discard everything we append after the tear
            self._active = idx
            self._active_bytes = len(MAGIC)
            fh = open(self._seg_path(idx), "ab")
            fh.write(MAGIC)
            self._fh = fh
        return self._fh

    def _rotate_if_needed_locked(self) -> None:
        if self._active_bytes < self.segment_bytes or self._active is None:
            return
        sealed = self._active
        self._fh.close()
        self._fh = None
        self._active = None
        # a sealed segment with nothing pending is already reclaimable
        if self._pending.get(sealed, 0) == 0:
            self._reclaim_locked(sealed)

    def _reclaim_locked(self, idx: int) -> None:
        self._pending.pop(idx, None)
        try:
            os.unlink(self._seg_path(idx))
            self._c_reclaimed.inc()
        except FileNotFoundError:
            pass

    def _fsync_locked(self) -> None:
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
            self._c_fsyncs.inc()

    def _append_locked(self, rtype: int, key: str, data: bytes) -> None:
        fh = self._open_active_locked()
        self._seq += 1
        kb = key.encode()
        rec = _HEADER.pack(rtype, len(kb), len(data), self._seq,
                           _crc(rtype, self._seq, kb, data)) + kb + data
        fh.write(rec)
        self._active_bytes += len(rec)
        self._c_appends.inc()
        self._c_bytes.inc(len(rec))

    def _note_put_locked(self, key: str) -> None:
        old = self._live.get(key)
        if old is not None and old != self._active:
            n = self._pending.get(old, 0) - 1
            self._pending[old] = n
            if n <= 0:
                self._reclaim_locked(old)
        elif old is not None:
            self._pending[old] -= 1
        self._live[key] = self._active
        self._pending[self._active] = self._pending.get(self._active, 0) + 1

    def _note_settled_locked(self, key: str) -> None:
        idx = self._live.pop(key, None)
        if idx is None:
            return
        n = self._pending.get(idx, 0) - 1
        self._pending[idx] = n
        if n <= 0 and idx != self._active:
            self._reclaim_locked(idx)

    # -- append API --------------------------------------------------------
    def append_put(self, key: str, data: bytes) -> None:
        """Journal one dirty admission; durable on return."""
        self.append_puts([(key, data)])

    def append_puts(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """Journal an admission group under ONE fsync — the batched
        barrier that keeps `batch_put` durability near one disk flush
        per window instead of one per object."""
        if not items:
            return
        with self._lock:
            for key, data in items:
                self._append_locked(T_PUT, key, bytes(data))
                self._note_put_locked(key)
            self._fsync_locked()
            self._rotate_if_needed_locked()

    def append_commit(self, keys: Iterable[str]) -> None:
        """Mark keys durable on the cold tier.  Deliberately NOT
        fsync'd: a lost COMMIT only means replay re-checks the cold
        tier (and finds the bytes already there) — never lost data."""
        keys = list(keys)
        if not keys:
            return
        with self._lock:
            for key in keys:
                self._append_locked(T_COMMIT, key, b"")
                self._note_settled_locked(key)
            self._fh.flush()
            self._rotate_if_needed_locked()

    def append_delete(self, key: str) -> None:
        """Journal a delete; fsync'd — replaying a lost DELETE would
        re-upload (resurrect) the object after its cold copy was
        removed."""
        with self._lock:
            self._append_locked(T_DELETE, key, b"")
            self._note_settled_locked(key)
            self._fsync_locked()
            self._rotate_if_needed_locked()

    # -- replay ------------------------------------------------------------
    def replay(self) -> Dict[str, bytes]:
        """Rebuild the unflushed dirty set from the segments a crash
        left behind.  Returns ``{key: bytes}`` of every acknowledged
        PUT with no later COMMIT/DELETE, in oldest-segment-first
        order; records after a torn/corrupt record within a segment
        are discarded (they were never acknowledged — the fsync
        barrier sits *after* the append).  Also primes the watermark
        bookkeeping so surviving segments reclaim once their keys
        finally flush."""
        dirty: Dict[str, bytes] = {}
        key_seg: Dict[str, int] = {}
        with self._lock:
            for idx in self._segments_on_disk():
                self._replay_segment_locked(idx, dirty, key_seg)
            self._live = dict(key_seg)
            self._pending = {}
            for idx in key_seg.values():
                self._pending[idx] = self._pending.get(idx, 0) + 1
            # segments with nothing pending are pure history: reclaim
            for idx in self._segments_on_disk():
                if self._pending.get(idx, 0) == 0:
                    self._reclaim_locked(idx)
            self._c_replayed.inc(len(dirty))
        return dirty

    def _replay_segment_locked(self, idx: int, dirty: Dict[str, bytes],
                               key_seg: Dict[str, int]) -> None:
        try:
            with open(self._seg_path(idx), "rb") as fh:
                if fh.read(len(MAGIC)) != MAGIC:
                    self._c_truncated.inc()
                    return
                while True:
                    hdr = fh.read(_HEADER.size)
                    if not hdr:
                        return  # clean end of segment
                    if len(hdr) < _HEADER.size:
                        self._c_truncated.inc()
                        return
                    rtype, klen, dlen, seq, crc = _HEADER.unpack(hdr)
                    body = fh.read(klen + dlen)
                    if len(body) < klen + dlen:
                        self._c_truncated.inc()
                        return
                    kb, data = body[:klen], body[klen:]
                    if crc != _crc(rtype, seq, kb, data):
                        self._c_truncated.inc()
                        return
                    self._seq = max(self._seq, seq)
                    key = kb.decode()
                    if rtype == T_PUT:
                        dirty[key] = data
                        key_seg[key] = idx
                    elif rtype in (T_COMMIT, T_DELETE):
                        dirty.pop(key, None)
                        key_seg.pop(key, None)
                    # unknown record types are skipped (forward compat)
        except FileNotFoundError:
            pass

    def pending_keys(self) -> List[str]:
        with self._lock:
            return list(self._live)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
            # an empty journal leaves no files behind
            if not self._live and self._active is not None:
                self._reclaim_locked(self._active)
            self._active = None
