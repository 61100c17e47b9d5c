"""Fault-tolerant training runner.

Port of ``repro.train.runner``:

  * deterministic, resumable stepping: the step counter addresses the
    data pipeline, so restart-from-checkpoint replays identically,
  * atomic async checkpoints via :class:`CheckpointManager` (VSS-backed,
    multi-representation, deferred-compressed cold masters),
  * crash/restart: any exception (or the injected `SimulatedFailure`)
    can be recovered from by constructing a new Trainer over the same
    root and calling ``resume()`` — it restores the newest intact
    checkpoint and continues; a mid-write crash is invisible because the
    manifest commits last,
  * straggler mitigation lives in the data pipeline (bounded staleness),
  * elastic resharding: ``Trainer(mesh=...)`` steps a state laid out on
    a ``DeviceMesh`` (``launch.specs.distribute_state``) with the sharded
    step, and ``resume(mesh=...)`` lays a restored checkpoint out on a
    mesh of any shape and steps on it from then on.  Checkpoints are
    written from the gathered state (``full_state``, by rank 0), so a
    sharded trainer's checkpoint has the bytes of an unsharded one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.specs import distribute_state, full_state
from repro_torch.launch.steps import (
    TrainHyper,
    init_train_state,
    make_train_step,
)
from repro_torch.models.model import resolve_device
from repro_torch.models.sharding import ShardCtx, is_dtensor
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


def _scalar(x) -> float:
    return float(x.full_tensor() if is_dtensor(x) else x)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


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
        self.cfg = cfg
        self.hyper = hyper
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.tcfg = tcfg
        self.seed = seed
        self.device = resolve_device(device)
        self._use_mesh(mesh)
        self.state = None
        self.step = 0
        self.metrics_log: list = []

    def _use_mesh(self, mesh) -> None:
        """Step on ``mesh`` (None: the single-device step).  The mesh
        must be on the trainer's device: a card trainer given a host
        mesh raises rather than train on the host."""
        ctx = None if mesh is None else ShardCtx(mesh)  # checks type
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"the mesh is on {mesh.device_type!r} and the trainer on"
                f" {self.device.type!r}: build the mesh on the trainer's"
                f" device or pass device={mesh.device_type!r}")
        self.ctx, self.mesh = ctx, mesh
        self._step = make_train_step(self.cfg, self.hyper, ctx)

    # -- lifecycle -----------------------------------------------------------
    def init(self):
        state = init_train_state(self.seed, self.cfg, self.hyper,
                                 device=self.device)
        self.state = state if self.mesh is None else distribute_state(
            state, self.mesh)
        self.step = 0
        return self

    def resume(self, mesh=None) -> bool:
        """Restore the newest checkpoint; False if none exists.

        With ``mesh``, lay the restored state out on that mesh (an
        elastic restart at another topology) and step on it from then
        on; without, on the trainer's own mesh (or device)."""
        if mesh is not None:
            self._use_mesh(mesh)
        like = init_train_state(self.seed, self.cfg, self.hyper,
                                device="meta")
        try:
            host_state, step = self.ckpt.restore(like=like)
        except FileNotFoundError:
            return False
        state = tree_map(lambda x: _to_device(x, self.device), host_state)
        self.state = state if self.mesh is None else distribute_state(
            state, self.mesh)
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
                     "loss": _scalar(metrics["loss"]),
                     "grad_norm": _scalar(metrics["grad_norm"])}
                )
            if self.step % self.tcfg.checkpoint_every == 0:
                host = (self.state if self.mesh is None
                        else full_state(self.state))
                if _rank() == 0:
                    self.ckpt.save(self.step, host,
                                   blocking=not self.tcfg.async_checkpoints)
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
