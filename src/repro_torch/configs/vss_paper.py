"""The paper's own workload configuration (Table 1 + §6 experiments),
CPU-scaled. Not an LM architecture — this parameterizes the storage
benchmarks (benchmarks/fig*.py) and the §6.4 end-to-end application.

A copy of ``repro.configs.vss_paper`` (plain dataclasses, no jax), equal
to it field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VideoDataset:
    name: str
    width: int
    height: int
    num_frames: int
    overlap: float  # horizontal overlap between the camera pair
    seed: int


# Table 1's structure at CPU-feasible scale: the paper's 1K/2K/4K become
# 160–384 px wide clips; overlap percentages are preserved exactly.
DATASETS: Tuple[VideoDataset, ...] = (
    VideoDataset("robotcar-like", 160, 96, 240, overlap=0.95, seed=100),
    VideoDataset("waymo-like", 192, 128, 60, overlap=0.15, seed=101),
    VideoDataset("vroad-1k-30", 160, 96, 240, overlap=0.30, seed=102),
    VideoDataset("vroad-1k-50", 160, 96, 240, overlap=0.50, seed=103),
    VideoDataset("vroad-1k-75", 160, 96, 240, overlap=0.75, seed=104),
    VideoDataset("vroad-2k-30", 256, 144, 240, overlap=0.30, seed=105),
    VideoDataset("vroad-4k-30", 384, 216, 240, overlap=0.30, seed=106),
)


@dataclasses.dataclass(frozen=True)
class StoreDefaults:
    """§3–§5 prototype constants, verbatim from the paper."""

    tau_db: float = 40.0  # lossless threshold
    default_eps_db: float = 40.0  # read quality cutoff
    joint_abort_db: float = 24.0  # §5.1.2 recovery abort
    duplicate_eps: float = 0.1  # ‖H−I‖ pointer cutoff
    budget_multiple: float = 10.0  # §4 administrator default
    deferred_activation: float = 0.25  # §5.2 cache fraction
    gamma: float = 2.0  # LRU_VSS position weight
    zeta: float = 1.0  # LRU_VSS redundancy weight
    eta: float = 1.45  # look-back dependent-frame premium
    min_matches: int = 20  # §5.1.3 m
    feature_dist: float = 400.0  # §5.1.3 d


CONFIG = StoreDefaults()
