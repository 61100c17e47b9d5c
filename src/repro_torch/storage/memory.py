"""In-memory backend — tests, benchmarks, and the tiered hot tier."""
from __future__ import annotations

import threading
from typing import Dict, List

from repro_torch.storage.base import ObjectNotFound, ObjectStat, StorageBackend


class MemoryBackend(StorageBackend):
    KIND = "memory"

    def __init__(self):
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)

    def get(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._objects[key]
            except KeyError:
                raise ObjectNotFound(key) from None

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)

    def stat(self, key: str) -> ObjectStat:
        with self._lock:
            try:
                return ObjectStat(key, len(self._objects[key]))
            except KeyError:
                raise ObjectNotFound(key) from None

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._objects if k.startswith(prefix)]

    def layout_fingerprint(self) -> str:
        return "memory"

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._objects.values())
