"""Roofline terms of one traced step on the H100 SXM.

Port of ``repro.launch.roofline`` with the H100 SXM's peaks in place of
the TPU's (each from NVIDIA's H100 SXM data sheet):

  bf16 dense tensor-core rate   989 TFLOP/s per GPU
  f32 rate (no tensor cores)     67 TFLOP/s per GPU
  HBM3                           3.35 TB/s per GPU
  NVLink 4                       450 GB/s per direction per GPU, among
                                 the 8 GPUs of one node (NVSwitch)
  InfiniBand NDR                 50 GB/s per GPU (one 400 Gb/s port),
                                 between nodes

The counts come from ``launch.op_analysis`` and are per device, so the
three terms are per device:

  compute_term    = flops_per_chip / peak (bf16)
  memory_term     = hbm_bytes_per_chip / HBM rate
  collective_term = wire_bytes_per_chip / link rate

The link rate is NVLink's when every collective group fits in one node
(``group`` ≤ 8 devices) and InfiniBand's otherwise.  Devices are laid
out node-major, so each axis of 16 spans two nodes and pays InfiniBand.
The reference's ``parse_collectives`` (HLO text) has no torch meaning;
``op_analysis`` counts the collectives as they are dispatched.
"""
from __future__ import annotations

import dataclasses

BF16_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
F32_OPS_PER_S = 67e12  # f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
NVLINK_BYTES_PER_S = 450e9  # NVLink 4, per direction
IB_BYTES_PER_S = 50e9  # InfiniBand NDR, 400 Gb/s a GPU
NODE_SIZE = 8  # GPUs joined by NVLink
PEAK_FLOPS = BF16_FLOPS


def link_rate(group: int) -> float:
    """Bytes/s per device of a collective over ``group`` devices."""
    return NVLINK_BYTES_PER_S if group <= NODE_SIZE else IB_BYTES_PER_S


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    ici_bytes_per_chip: float  # wire bytes per device, ring factors in
    model_flops_total: float  # 6·N·D (train) / 2·N_active·tokens (serve)
    chips: int
    group: int = 16  # the largest collective group (sets the link)

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.ici_bytes_per_chip / link_rate(self.group)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much of the work is useful."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_total / max(total, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs time at peak / the bound step time (≈ MFU bound)."""
        ideal_s = self.model_flops_total / (self.chips * PEAK_FLOPS)
        return ideal_s / max(self.bound_s, 1e-30)

    def as_dict(self):
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "ici_bytes_per_chip": self.ici_bytes_per_chip,
            "model_flops_total": self.model_flops_total,
            "chips": self.chips,
            "link_bytes_per_s": link_rate(self.group),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE)
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _numel(leaf) -> int:
    n = 1
    for d in leaf.shape:
        n *= int(d)
    return n


def count_params(tree) -> int:
    return sum(_numel(leaf) for _p, leaf in _leaves(tree))


def active_params(cfg, params_tree) -> int:
    """Active parameter count: routed experts scaled by top_k/num_experts."""
    n = 0
    for keys, leaf in _leaves(params_tree):
        size = _numel(leaf)
        if cfg.moe is not None and any(k.startswith("we_") for k in keys):
            size = int(size * cfg.moe.top_k / cfg.moe.num_experts)
        n += size
    return n


def model_flops(cfg, params_tree, shape, kind: str) -> float:
    """Total useful FLOPs of one step."""
    n_active = active_params(cfg, params_tree)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
