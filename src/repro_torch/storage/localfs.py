"""Local-filesystem backend with atomic, optionally-fsynced writes.

One object per key under ``root``; keys are ``/``-separated relative
paths (``<logical>/<physical_id>/<idx>.tvc``).  Writes land in a temp
file in the destination directory and are published with ``os.replace``
— a crash mid-write leaves only a ``.tmp-*`` turd, never a truncated
object under a live key.  The startup scavenger (`recover`) removes
those turds and reconciles the surviving objects against the catalog.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import List

from repro_torch.storage.base import (
    ObjectNotFound,
    ObjectStat,
    RangeNotSatisfiable,
    StorageBackend,
    validate_key,
)

TEMP_MARKER = ".tmp-"


class LocalFSBackend(StorageBackend):
    KIND = "localfs"

    def __init__(self, root: str, *, fsync: bool = False):
        self.root = root
        self.fsync = fsync
        os.makedirs(root, exist_ok=True)
        self._counter = itertools.count()
        self._lock = threading.Lock()

    # -- key ↔ path --------------------------------------------------------
    def _path(self, key: str) -> str:
        return os.path.join(self.root, *validate_key(key).split("/"))

    def _key(self, path: str) -> str:
        return os.path.relpath(path, self.root).replace(os.sep, "/")

    # -- contract ----------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._lock:
            tmp = f"{path}{TEMP_MARKER}{os.getpid()}-{next(self._counter)}"
        with open(tmp, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.fsync:
            dirfd = os.open(os.path.dirname(path), os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ObjectNotFound(key) from None

    def get_range(self, key: str, start: int, length: int) -> bytes:
        if start < 0 or length < 1:
            raise ValueError(f"bad range start={start} length={length}")
        try:
            with open(self._path(key), "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if start >= size:
                    raise RangeNotSatisfiable(key, start, size)
                f.seek(start)
                return f.read(length)
        except FileNotFoundError:
            raise ObjectNotFound(key) from None

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def stat(self, key: str) -> ObjectStat:
        try:
            return ObjectStat(key, os.stat(self._path(key)).st_size)
        except FileNotFoundError:
            raise ObjectNotFound(key) from None

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if TEMP_MARKER in name:
                    continue
                key = self._key(os.path.join(dirpath, name))
                if key.startswith(prefix):
                    out.append(key)
        return out

    def layout_fingerprint(self) -> str:
        return "local"

    # -- crash recovery ----------------------------------------------------
    def sweep_temps(self) -> int:
        removed = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if TEMP_MARKER in name:
                    try:
                        os.unlink(os.path.join(dirpath, name))
                        removed += 1
                    except FileNotFoundError:
                        pass
        return removed
