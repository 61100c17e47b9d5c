"""VSS-backed token pipeline — the paper's storage manager as the
framework's input layer (a copy of the reference's over the port's
``VSS``; batches are numpy, and the trainer moves them to its device).

The corpus is written once into VSS as uint8 frames (4 bytes/token,
fixed frame geometry, one logical video). Every training step then
*reads through VSS* — deterministic, seekable by step index, resumable
after restart (the step number fully determines the batch), exercising
the same GOP/temporal-index machinery as video reads: frequently
re-read regions get cached views, cold regions get deferred-compressed.

Double-buffered prefetch + bounded-staleness straggler mitigation: a
worker thread stages batch s+1 while s trains; if a read misses its
deadline (a straggling storage node at scale) the loop *reuses the
freshest ready batch* instead of stalling — bounded staleness, counted
and surfaced in metrics.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core.store import VSS

FRAME_H, FRAME_W, FRAME_C = 64, 128, 3
FRAME_BYTES = FRAME_H * FRAME_W * FRAME_C
TOKENS_PER_FRAME = FRAME_BYTES // 4


def write_token_corpus(vss: VSS, name: str, tokens: np.ndarray) -> int:
    """Pack int32 tokens into frames and write the corpus video."""
    tokens = np.asarray(tokens, np.int32)
    pad = (-tokens.size) % TOKENS_PER_FRAME
    blob = np.concatenate([tokens, np.zeros(pad, np.int32)]).tobytes()
    frames = np.frombuffer(blob, np.uint8).reshape(
        -1, FRAME_H, FRAME_W, FRAME_C
    )
    vss.write(name, frames, fps=1.0, codec="rgb")
    return tokens.size


def read_tokens(vss: VSS, name: str, start: int, count: int,
                corpus_tokens: int) -> np.ndarray:
    """Read `count` tokens at offset `start` (wrapping) through VSS."""
    start = start % corpus_tokens
    end = min(start + count, corpus_tokens)
    f0 = start // TOKENS_PER_FRAME
    f1 = -(-end // TOKENS_PER_FRAME)
    res = vss.read(name, t=(float(f0), float(f1)), codec="rgb", cache=True)
    flat = np.frombuffer(res.frames.tobytes(), np.int32)
    got = flat[start - f0 * TOKENS_PER_FRAME:][: end - start]
    if end - start < count:  # wrap around
        rest = read_tokens(vss, name, 0, count - (end - start), corpus_tokens)
        got = np.concatenate([got, rest])
    return got


@dataclasses.dataclass
class PipelineStats:
    fetched: int = 0
    stale_reuses: int = 0
    prefetch_wait_s: float = 0.0


class TokenPipeline:
    """Deterministic, resumable, double-buffered batch source."""

    def __init__(
        self,
        vss: VSS,
        name: str,
        corpus_tokens: int,
        *,
        batch: int,
        seq: int,
        deadline_s: float = 5.0,
        delay_s: float = 0.0,  # test hook: simulated straggling read
    ):
        self.vss = vss
        self.name = name
        self.corpus_tokens = corpus_tokens
        self.batch = batch
        self.seq = seq
        self.deadline_s = deadline_s
        self.delay_s = delay_s
        self.stats = PipelineStats()
        self._ready: Dict[int, Dict[str, np.ndarray]] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._worker: Optional[threading.Thread] = None
        self._want: Optional[int] = None
        self._stop = False

    # -- deterministic batch address ----------------------------------------
    def _fetch(self, step: int) -> Dict[str, np.ndarray]:
        if self.delay_s:
            time.sleep(self.delay_s)
        need = self.batch * (self.seq + 1)
        start = step * need
        flat = read_tokens(self.vss, self.name, start, need,
                           self.corpus_tokens)
        arr = flat.reshape(self.batch, self.seq + 1)
        return {
            "tokens": arr[:, :-1].astype(np.int32),
            "labels": arr[:, 1:].astype(np.int32),
        }

    # -- prefetch machinery ---------------------------------------------------
    def _worker_loop(self):
        while True:
            with self._cv:
                while self._want is None and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                step = self._want
                self._want = None
            batch = self._fetch(step)
            with self._cv:
                self._ready[step] = batch
                if len(self._ready) > 2:  # double buffer
                    self._ready.pop(min(self._ready))
                self._cv.notify_all()

    def _ensure_worker(self):
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True
            )
            self._worker.start()

    def prefetch(self, step: int):
        self._ensure_worker()
        with self._cv:
            if step not in self._ready:
                self._want = step
                self._cv.notify_all()

    def get(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for `step`; under a missed deadline, reuse the freshest
        ready batch (bounded staleness) rather than stalling."""
        self._ensure_worker()
        t0 = time.perf_counter()
        with self._cv:
            if step not in self._ready:
                self._want = step
                self._cv.notify_all()
            deadline = time.time() + self.deadline_s
            while step not in self._ready:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            self.stats.prefetch_wait_s += time.perf_counter() - t0
            if step in self._ready:
                batch = self._ready[step]
                self.stats.fetched += 1
            elif self._ready:  # straggler: freshest available
                batch = self._ready[max(self._ready)]
                self.stats.stale_reuses += 1
            else:  # nothing staged at all: block hard (first step)
                while step not in self._ready:
                    self._cv.wait()
                batch = self._ready[step]
                self.stats.fetched += 1
        self.prefetch(step + 1)
        return batch

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5)
