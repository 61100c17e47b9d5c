"""Fault-tolerant training runner.

Port of ``repro.train.runner`` for one device:

  * deterministic, resumable stepping: the step counter addresses the
    data pipeline, so restart-from-checkpoint replays identically,
  * atomic async checkpoints via :class:`CheckpointManager` (VSS-backed,
    multi-representation, deferred-compressed cold masters),
  * crash/restart: any exception (or the injected `SimulatedFailure`)
    can be recovered from by constructing a new Trainer over the same
    root and calling ``resume()`` — it restores the newest intact
    checkpoint and continues; a mid-write crash is invisible because the
    manifest commits last,
  * straggler mitigation lives in the data pipeline (bounded staleness).

Elastic resharding (``resume(mesh=...)``) needs the meshes that are not
ported: a ``mesh`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.steps import (
    TrainHyper,
    init_train_state,
    make_train_step,
)
from repro_torch.models.model import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import tree_map


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclasses.dataclass
class TrainerConfig:
    checkpoint_every: int = 50
    async_checkpoints: bool = True
    fail_at_step: Optional[int] = None  # injected crash AFTER this step
    log_every: int = 10


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "meshes and shardings are not ported: the trainer runs on one"
            " device")


def _to_device(leaf, dev: torch.device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(dev)
    return torch.from_numpy(np.array(leaf)).to(dev)


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        hyper: TrainHyper,
        pipeline,  # TokenPipeline-like: .get(step) -> batch
        ckpt: CheckpointManager,
        *,
        mesh=None,
        tcfg: TrainerConfig = TrainerConfig(),
        seed: int = 0,
        device: str = "cuda",
    ):
        _no_mesh(mesh)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.hyper = hyper
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.tcfg = tcfg
        self.seed = seed
        self._step = make_train_step(cfg, hyper)
        self.state = None
        self.step = 0
        self.metrics_log: list = []

    # -- lifecycle -----------------------------------------------------------
    def init(self):
        self.state = init_train_state(self.seed, self.cfg, self.hyper,
                                      device=self.device)
        self.step = 0
        return self

    def resume(self, mesh=None) -> bool:
        """Restore the newest checkpoint; False if none exists."""
        _no_mesh(mesh)
        like = init_train_state(self.seed, self.cfg, self.hyper,
                                device="meta")
        try:
            host_state, step = self.ckpt.restore(like=like)
        except FileNotFoundError:
            return False
        self.state = tree_map(lambda x: _to_device(x, self.device),
                              host_state)
        self.step = step
        return True

    def init_or_resume(self):
        if not self.resume():
            self.init()
        return self

    # -- loop -----------------------------------------------------------------
    def train(self, num_steps: int) -> Dict[str, Any]:
        assert self.state is not None, "call init() or resume() first"
        t0 = time.perf_counter()
        while self.step < num_steps:
            batch = self.pipeline.get(self.step)
            self.state, metrics = self._step(self.state, batch)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == num_steps:
                self.metrics_log.append(
                    {"step": self.step,
                     "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"])}
                )
            if self.step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(
                    self.step, self.state,
                    blocking=not self.tcfg.async_checkpoints,
                )
            if self.tcfg.fail_at_step is not None and (
                self.step == self.tcfg.fail_at_step
            ):
                raise SimulatedFailure(f"injected failure at {self.step}")
        self.ckpt.wait()
        return {
            "steps": self.step,
            "wall_s": time.perf_counter() - t0,
            "final_loss": self.metrics_log[-1]["loss"]
            if self.metrics_log else None,
            "log": self.metrics_log,
        }
