"""Paged KV cache — VSS's GOP pages mapped onto serving state.

Port of ``repro.serving.pages``.  The KV cache of one request is a
*logical video*; its fixed-size pages are GOPs (§2).  The pool applies
the paper's machinery:

  * **prefix dedup is the joint-compression analogue** (§5.1): two
    requests sharing a token prefix store those pages once. The paper's
    duplicate case (‖H−I‖ ≤ ε → replace the GOP with a pointer) becomes
    a content-hash pointer; the fingerprint index (§5.1.3's histogram/
    BIRCH stage) becomes a rolling hash over (position, token) pairs —
    exact, since token pages at equal positions are bitwise-identical.
  * **eviction is LRU_VSS** (§4): retained (finished-request) page runs
    carry sequence numbers ``LRU + γ·p − ζ·r + b`` — position offset p
    protects run middles (re-extending a prefix needs its *contiguous*
    head, so nibble ends first), redundancy r = extra refcount holders
    (shared pages are cheap to unhook), and the baseline guard b = +∞
    pins pages of *running* requests.

The pool's K and V are device tensors (L, P, page, Hkv, hd), bf16 by
default, on the device the caller names (``"cuda"`` unless asked
otherwise); the writes index them in place on that device, with no
round trip through the host.  The bookkeeping (free list, refcounts,
prefix index, retained runs) is host state, as in the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PagePoolConfig:
    num_pages: int
    page_size: int  # tokens per page (the GOP length)
    num_layers: int
    num_kv_heads: int
    head_dim: int
    gamma: float = 2.0  # LRU_VSS position weight (§4 prototype values)
    zeta: float = 1.0
    dtype: torch.dtype = torch.bfloat16


def prefix_hash(tokens: Sequence[int]) -> str:
    return hashlib.sha1(np.asarray(tokens, np.int32).tobytes()).hexdigest()


@dataclasses.dataclass
class RetainedRun:
    """A finished request's page run kept for future prefix hits."""

    page_ids: List[int]
    hashes: List[str]  # cumulative prefix hash at each page boundary
    lru: int


class PagePool:
    def __init__(self, cfg: PagePoolConfig, *, device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the page pool lives on 'cuda' by"
                " default; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.device = dev
        shape = (
            cfg.num_layers, cfg.num_pages, cfg.page_size,
            cfg.num_kv_heads, cfg.head_dim,
        )
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.free: List[int] = list(range(cfg.num_pages))
        self.refcount = np.zeros(cfg.num_pages, np.int64)
        # prefix index: cumulative hash -> page id (the §5.1.3 analogue)
        self.prefix_index: Dict[str, int] = {}
        self.retained: List[RetainedRun] = []
        self._clock = 0

    # -- allocation ---------------------------------------------------------
    def tick(self) -> int:
        self._clock += 1
        return self._clock

    def alloc(self) -> int:
        while not self.free:
            if not self._evict_one():
                raise MemoryError("page pool exhausted (all pages pinned)")
        pid = self.free.pop()
        self.refcount[pid] = 1
        return pid

    def share(self, pid: int) -> int:
        self.refcount[pid] += 1
        return pid

    def release(self, pid: int):
        self.refcount[pid] -= 1
        if self.refcount[pid] <= 0:
            self.refcount[pid] = 0
            self.prefix_index = {
                h: p for h, p in self.prefix_index.items() if p != pid
            }
            self.free.append(pid)

    # -- prefix dedup (§5.1 duplicate-GOP pointer case) -----------------------
    def lookup_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest run of already-stored full pages for this prompt.
        Returns (shared page ids, tokens covered)."""
        ps = self.cfg.page_size
        shared: List[int] = []
        covered = 0
        for end in range(ps, len(tokens) + 1, ps):
            h = prefix_hash(tokens[:end])
            pid = self.prefix_index.get(h)
            if pid is None:
                break
            shared.append(self.share(pid))
            covered = end
        return shared, covered

    def register_prefix(self, tokens: Sequence[int], page_ids: List[int]):
        ps = self.cfg.page_size
        for i, pid in enumerate(page_ids):
            end = (i + 1) * ps
            if end > len(tokens):
                break  # partial tail page: content still mutable
            self.prefix_index.setdefault(prefix_hash(tokens[:end]), pid)

    # -- retention + LRU_VSS eviction (§4) ------------------------------------
    def retain(self, tokens: Sequence[int], page_ids: List[int]):
        """Keep a finished request's pages for future prefix hits."""
        ps = self.cfg.page_size
        full = len(tokens) // ps
        hashes = [prefix_hash(tokens[: (i + 1) * ps]) for i in range(full)]
        self.register_prefix(tokens, page_ids[:full])
        self.retained.append(
            RetainedRun(list(page_ids[:full]), hashes, self.tick())
        )
        for pid in page_ids[full:]:  # partial tail: no future value
            self.release(pid)

    def _sequence_numbers(self) -> List[Tuple[float, int, int]]:
        """(seq, run_idx, pos_in_run) per evictable retained page."""
        out = []
        for ri, run in enumerate(self.retained):
            n = len(run.page_ids)
            for i, pid in enumerate(run.page_ids):
                # baseline guard b (implicit): pages of *running* requests
                # never appear here — only finished, retained runs do.
                seq = float(run.lru)
                seq += self.cfg.gamma * min(i, n - 1 - i)  # position p
                seq -= self.cfg.zeta * max(self.refcount[pid] - 1, 0)  # r
                out.append((seq, ri, i))
        return out

    def _evict_one(self) -> bool:
        cands = self._sequence_numbers()
        if not cands:
            return False
        cands.sort()
        _, ri, i = cands[0]
        run = self.retained[ri]
        pid = run.page_ids.pop(i)
        h = run.hashes.pop(i)
        # dropping a middle page splits the run; the prefix chain past the
        # hole is dead for extension purposes but pages stay shareable
        if self.prefix_index.get(h) == pid:
            self.prefix_index.pop(h, None)
        self.release(pid)
        if not run.page_ids:
            self.retained.pop(ri)
        return True

    # -- device-side writes ----------------------------------------------------
    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def write_layer_token(self, layer: int, k_new: torch.Tensor,
                          v_new: torch.Tensor, page_ids: torch.Tensor,
                          offsets: torch.Tensor):
        """One layer's single-token write: k_new/v_new (B, Hkv, hd) at
        (page_ids[b], offsets[b]), device index tensors (B,)."""
        self.k[layer, page_ids, offsets] = k_new.to(self.cfg.dtype)
        self.v[layer, page_ids, offsets] = v_new.to(self.cfg.dtype)

    def write_run(self, layer_k: torch.Tensor, layer_v: torch.Tensor,
                  page_ids: List[int], length: int):
        """Bulk prefill write. layer_k/v: (L, S, Hkv, hd) on the pool's
        device; positions [0, length) land on their pages in one indexed
        write per tensor."""
        ps = self.cfg.page_size
        n = min(length, len(page_ids) * ps)
        if n <= 0:
            return
        pos = np.arange(n)
        pids = self._index(np.asarray(page_ids, np.int64)[pos // ps])
        offs = self._index(pos % ps)
        self.k[:, pids, offs] = layer_k[:, :n].to(self.cfg.dtype)
        self.v[:, pids, offs] = layer_v[:, :n].to(self.cfg.dtype)

    @property
    def pages_in_use(self) -> int:
        return self.cfg.num_pages - len(self.free)
