"""Continuous-batching serving engine over the paged KV pool.

Port of ``repro.serving.engine``.  Flow per scheduler round:
  1. admit queued requests while decode slots + pages allow,
  2. per admitted request: prefix-dedup lookup (§5.1 pointer case) —
     already-cached full pages are *shared*, and the request's pages
     are written from one dense parallel prefill of its KV tokens (as
     the reference does, the shared pages are written again with the
     same positions' values),
  3. one batched decode step for the whole active batch, whose attention
     is the paged decode-attention kernel (GOP-paged KV), once per layer,
  4. finished requests retire their pages into the LRU_VSS prefix cache.

Serves the dense-attention ("attn"-pattern) families; the others serve
through the dense-cache path, ``models.model.prefill`` and
``decode_step``, as in the reference.  Everything runs
eagerly on the model's device (``"cuda"`` unless the caller asks for the
CPU): the prefill's K/V go into the pool, and each round's new K/V into
their slot pages, by indexed writes on the device.  Only the block
table, lengths and slots of a round go up, and the chosen tokens come
down.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.pages import PagePool, PagePoolConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    first_token_s: float = 0.0
    done_s: float = 0.0
    dedup_pages: int = 0


@dataclasses.dataclass
class _Active:
    req: Request
    page_ids: List[int]
    length: int  # tokens currently in the KV pages
    last_token: int


class ServingEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        model: M.CausalLM,
        *,
        page_size: int = 16,
        num_pages: int = 256,
        max_batch: int = 8,
        eos_id: Optional[int] = None,
    ):
        if set(M.layer_types(M.layer_plan(cfg))) != {"attn"}:
            raise ValueError(
                f"the paged engine serves dense ('attn') archs, not"
                f" {cfg.name} ({'/'.join(cfg.pattern)}): serve it through"
                " models.model.prefill and decode_step (the dense-cache path)")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.pool = PagePool(PagePoolConfig(
            num_pages=num_pages,
            page_size=page_size,
            num_layers=cfg.num_layers,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.hd,
        ), device=self.device)
        self.queue: List[Request] = []
        self.active: List[_Active] = []
        self._next_rid = 0
        self.metrics = {"decode_steps": 0, "prefill_tokens": 0,
                        "dedup_tokens": 0}

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(
            Request(rid, list(prompt), max_new, submitted_s=time.perf_counter())
        )
        return rid

    def run(self) -> Dict[int, Request]:
        done: Dict[int, Request] = {}
        while self.queue or self.active:
            self._admit()
            self._decode_round(done)
        return done

    # -- prefill with prefix dedup ---------------------------------------------
    def _admit(self):
        while self.queue and len(self.active) < self.max_batch:
            req = self.queue.pop(0)
            ps = self.pool.cfg.page_size
            shared, covered = self.pool.lookup_prefix(req.prompt)
            req.dedup_pages = len(shared)
            self.metrics["dedup_tokens"] += covered
            prompt = req.prompt
            # the *last* prompt token is fed to decode (it produces the
            # first new token), so the KV run covers prompt[:-1]
            kv_tokens = prompt[:-1]
            needed = max(len(kv_tokens) - covered, 0)
            page_ids = list(shared)
            total_pages = -(-max(len(kv_tokens), 1) // ps)
            while len(page_ids) < total_pages:
                page_ids.append(self.pool.alloc())
            if needed > 0:
                tokens = torch.as_tensor(
                    np.asarray(kv_tokens, np.int64)[None, :],
                    device=self.device)
                ks, vs = self._prefill(tokens)
                self.pool.write_run(ks, vs, page_ids, len(kv_tokens))
                self.metrics["prefill_tokens"] += needed
            self.pool.register_prefix(kv_tokens, page_ids)
            self.active.append(
                _Active(req, page_ids, len(kv_tokens), prompt[-1])
            )

    def _prefill(self, tokens: torch.Tensor):
        """Dense parallel prefill returning per-layer K/V (L, S, Hkv, hd)."""
        cache = M.init_cache(self.model, 1, tokens.shape[1])
        M.prefill(self.model, tokens, cache)
        return (torch.stack([c["k"][0] for c in cache["layers"]]),
                torch.stack([c["v"][0] for c in cache["layers"]]))

    # -- batched paged decode ----------------------------------------------------
    @torch.no_grad()
    def _decode(self, tokens, block_table, seq_lens, slot_pages,
                slot_offsets) -> torch.Tensor:
        """One token for every active sequence; returns logits (B, V).

        tokens: (B,) — the token being fed; block_table: (B, maxp) int32;
        seq_lens: (B,) int32 = KV length BEFORE this token; slot_pages/
        offsets: (B,) where the new token's K/V lands.
        """
        cfg = self.cfg
        pool = self.pool
        x = M._embed_tokens(self.model, tokens[:, None])
        pos = seq_lens  # 0-based position of the fed token
        new_len = seq_lens + 1
        for li, p in enumerate(self.model.layers):
            h = L.apply_norm(p.ln1, x)
            q, k, v = M._step_attn_common(p.attn, h, cfg, pos)
            pool.write_layer_token(li, k[:, 0], v[:, 0], slot_pages,
                                   slot_offsets)
            o = ops.paged_decode_attention(
                q[:, 0], pool.k[li], pool.v[li], block_table, new_len)
            x = x + L.attn_out(p.attn, o[:, None].to(x.dtype))
            h = L.apply_norm(p.ln2, x)
            x = x + L.mlp_block(p.mlp, h, cfg.act)
        return M.unembed(self.model, x)[:, 0]

    def _decode_round(self, done: Dict[int, Request]):
        if not self.active:
            return
        ps = self.pool.cfg.page_size
        b = len(self.active)
        # ensure every sequence has a slot page for the incoming token
        for a in self.active:
            if a.length % ps == 0 and (
                len(a.page_ids) <= a.length // ps
            ):
                a.page_ids.append(self.pool.alloc())
        maxp = max(len(a.page_ids) for a in self.active)
        bt = np.full((b, maxp), -1, np.int32)
        for i, a in enumerate(self.active):
            bt[i, : len(a.page_ids)] = a.page_ids
        tokens = np.asarray([a.last_token for a in self.active], np.int64)
        seq_lens = np.asarray([a.length for a in self.active], np.int32)
        slot_pages = np.asarray(
            [a.page_ids[a.length // ps] for a in self.active], np.int64
        )
        slot_offsets = (seq_lens % ps).astype(np.int64)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        logits = self._decode(dev(tokens), dev(bt), dev(seq_lens),
                              dev(slot_pages), dev(slot_offsets))
        self.metrics["decode_steps"] += 1
        next_tokens = torch.argmax(logits, dim=-1).tolist()
        still: List[_Active] = []
        for i, a in enumerate(self.active):
            tok = int(next_tokens[i])
            if not a.req.out:
                a.req.first_token_s = time.perf_counter()
            a.req.out.append(tok)
            a.length += 1
            a.last_token = tok
            finished = len(a.req.out) >= a.req.max_new or (
                self.eos_id is not None and tok == self.eos_id
            )
            if finished:
                a.req.done_s = time.perf_counter()
                kv_tokens = a.req.prompt[:-1] + a.req.out[: a.length - (
                    len(a.req.prompt) - 1
                )]
                self.pool.retain(kv_tokens[: a.length], a.page_ids)
                done[a.req.rid] = a.req
            else:
                still.append(a)
        self.active = still
