"""Consistent-hash sharding of GOP keys across N volumes.

Each volume is itself a `StorageBackend` (typically `LocalFSBackend`
over a distinct directory/disk).  Keys map to volumes through a hash
ring with virtual nodes, so adding a volume moves only ~1/N of the
keyspace — the property that makes future rebalancing/replication
incremental instead of a full reshuffle.

``batch_get`` fans out over a thread pool, one task per volume, so the
multi-fragment reads produced by the §3 read planner overlap I/O across
volumes instead of serializing — the point of sharding in the first
place.  (CPython releases the GIL during file reads, so this overlaps
genuinely even in-process.)
"""
from __future__ import annotations

import bisect
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

from repro_torch.storage.base import ObjectStat, StorageBackend
from repro_torch.storage.localfs import LocalFSBackend

VNODES_PER_VOLUME = 64


def _hash64(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes over N slots.

    ``owner(key)`` is the slot the key hashes to; ``preference(key, r)``
    walks clockwise from there collecting the first ``r`` DISTINCT
    slots — the replica preference order `ReplicatedBackend` places
    copies by.  Both are pure functions of the slot count, so two rings
    with equal ``n_slots`` resolve every key identically (what makes
    layout fingerprints meaningful) and adding a slot moves only ~1/N
    of the keyspace."""

    def __init__(self, n_slots: int, vnodes: int = VNODES_PER_VOLUME):
        if n_slots < 1:
            raise ValueError("HashRing needs at least one slot")
        self.n_slots = n_slots
        ring = []
        for vi in range(n_slots):
            for r in range(vnodes):
                ring.append((_hash64(f"vol{vi}#vnode{r}"), vi))
        ring.sort()
        self._keys = [h for h, _ in ring]
        self._slots = [v for _, v in ring]

    def owner(self, key: str) -> int:
        i = bisect.bisect_left(self._keys, _hash64(key))
        if i == len(self._keys):
            i = 0
        return self._slots[i]

    def preference(self, key: str, count: int) -> List[int]:
        """The first ``count`` distinct slots clockwise from the key's
        position — slot 0 of the result is ``owner(key)``."""
        count = min(count, self.n_slots)
        start = bisect.bisect_left(self._keys, _hash64(key))
        out: List[int] = []
        for j in range(len(self._slots)):
            slot = self._slots[(start + j) % len(self._slots)]
            if slot not in out:
                out.append(slot)
                if len(out) == count:
                    break
        return out


class ShardedBackend(StorageBackend):
    KIND = "sharded"

    def __init__(self, volumes: Sequence[StorageBackend]):
        if not volumes:
            raise ValueError("ShardedBackend needs at least one volume")
        self.volumes = list(volumes)
        self.ring = HashRing(len(self.volumes))
        # volume count sets layout/capacity; useful parallelism is capped
        # by cores (page-cache reads are memcpy-bound once warm) — more
        # workers than cores just adds scheduling overhead
        self._pool = ThreadPoolExecutor(
            max_workers=min(len(self.volumes), os.cpu_count() or 4, 16),
            thread_name_prefix="vss-shard",
        )

    @classmethod
    def local(cls, root: str, n_volumes: int, *,
              fsync: bool = False) -> "ShardedBackend":
        return cls([
            LocalFSBackend(os.path.join(root, f"vol{i}"), fsync=fsync)
            for i in range(n_volumes)
        ])

    # -- placement ---------------------------------------------------------
    def volume_for(self, key: str) -> int:
        return self.ring.owner(key)

    def _vol(self, key: str) -> StorageBackend:
        return self.volumes[self.volume_for(key)]

    # -- contract ----------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        self._vol(key).put(key, data)

    def get(self, key: str) -> bytes:
        return self._vol(key).get(key)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        return self._vol(key).get_range(key, start, length)

    def delete(self, key: str) -> None:
        self._vol(key).delete(key)

    def stat(self, key: str) -> ObjectStat:
        return self._vol(key).stat(key)

    def list(self, prefix: str = "") -> List[str]:
        out: List[str] = []
        for v in self.volumes:
            out.extend(v.list(prefix))
        return out

    def batch_get(self, keys: Sequence[str]) -> List[bytes]:
        by_vol: Dict[int, List[int]] = {}
        for i, k in enumerate(keys):
            by_vol.setdefault(self.volume_for(k), []).append(i)
        results: List[bytes] = [b""] * len(keys)

        def fetch(vol_idx: int, idxs: List[int]):
            vol = self.volumes[vol_idx]
            for i in idxs:
                results[i] = vol.get(keys[i])

        futures = [
            self._pool.submit(fetch, vol_idx, idxs)
            for vol_idx, idxs in by_vol.items()
        ]
        for f in futures:
            f.result()  # propagate ObjectNotFound etc.
        return results

    def batch_get_ranges(
        self, reqs: Sequence[Tuple[str, int, int]]
    ) -> List[bytes]:
        """Fan ranged reads out per owning volume, mirroring
        ``batch_get``."""
        by_vol: Dict[int, List[int]] = {}
        for i, (k, _s, _n) in enumerate(reqs):
            by_vol.setdefault(self.volume_for(k), []).append(i)
        results: List[bytes] = [b""] * len(reqs)

        def fetch(vol_idx: int, idxs: List[int]):
            vol = self.volumes[vol_idx]
            for i in idxs:
                k, s, n = reqs[i]
                results[i] = vol.get_range(k, s, n)

        futures = [
            self._pool.submit(fetch, vol_idx, idxs)
            for vol_idx, idxs in by_vol.items()
        ]
        for f in futures:
            f.result()  # propagate ObjectNotFound etc.
        return results

    def batch_put(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """Fan multi-GOP writes out over the volume pool, mirroring
        ``batch_get``: one task per volume, writes within a volume stay
        ordered (each `put` keeps its own atomicity)."""
        by_vol: Dict[int, List[Tuple[str, bytes]]] = {}
        for key, data in items:
            by_vol.setdefault(self.volume_for(key), []).append((key, data))

        def store(vol_idx: int, batch: List[Tuple[str, bytes]]):
            vol = self.volumes[vol_idx]
            for key, data in batch:
                vol.put(key, data)

        futures = [
            self._pool.submit(store, vol_idx, batch)
            for vol_idx, batch in by_vol.items()
        ]
        for f in futures:
            f.result()  # propagate I/O errors

    def sweep_temps(self) -> int:
        return sum(v.sweep_temps() for v in self.volumes)

    def configure_concurrency(self, n: int) -> None:
        for v in self.volumes:
            v.configure_concurrency(n)

    def layout_fingerprint(self) -> str:
        # the ring (hence placement) is a pure function of volume count
        return f"sharded:{len(self.volumes)}"

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        for v in self.volumes:
            v.close()
