"""Config registry: one module per assigned architecture.

``get_config(name)`` returns the full published config; ``smoke_config``
shrinks it to a CPU-runnable variant of the same family (same pattern,
same block types, tiny dims) for the per-arch smoke tests.  A copy of
``repro.configs`` (plain dataclasses); the VSS paper's own store
configuration is ``configs/vss_paper.py``.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    MoESpec,
    ShapeSpec,
    shapes_for,
)

ARCH_IDS = (
    "phi3_mini_3_8b",
    "minitron_4b",
    "command_r_plus_104b",
    "qwen3_32b",
    "whisper_large_v3",
    "recurrentgemma_2b",
    "deepseek_moe_16b",
    "llama4_scout_17b_a16e",
    "llama_3_2_vision_11b",
    "xlstm_1_3b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
# the brief's dotted/dashed ids
_ALIASES.update({
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "minitron-4b": "minitron_4b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-32b": "qwen3_32b",
    "whisper-large-v3": "whisper_large_v3",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "xlstm-1.3b": "xlstm_1_3b",
})


def canonical_arch(name: str) -> str:
    key = name.lower()
    if key in ARCH_IDS:
        return key
    if key in _ALIASES:
        return _ALIASES[key]
    raise KeyError(f"unknown architecture {name!r}; known: {list(ARCH_IDS)}")


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{canonical_arch(name)}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    """A reduced config of the same family for CPU smoke tests."""
    mod = importlib.import_module(
        f"repro_torch.configs.{canonical_arch(name)}")
    return mod.SMOKE


def _shrink(
    cfg: ArchConfig,
    *,
    num_layers: int,
    d_model: int,
    num_heads: int,
    num_kv_heads: int,
    d_ff: int,
    vocab_size: int = 512,
    head_dim=None,
    **over,
) -> ArchConfig:
    """Shared smoke-config shrinker (same family/pattern, tiny dims)."""
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        d_ff=d_ff,
        vocab_size=vocab_size,
        head_dim=head_dim,
    )
    if cfg.moe is not None and "moe" not in over:
        changes["moe"] = MoESpec(
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_expert=max(d_ff // 2, 8),
            num_shared=min(cfg.moe.num_shared, 1),
        )
    if cfg.local_window is not None:
        changes["local_window"] = 16
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
    if cfg.num_frontend_tokens:
        changes["num_frontend_tokens"] = 16
        changes["frontend_dim"] = 32
    if cfg.rnn_width is not None:
        changes["rnn_width"] = d_model
    changes.update(over)
    return dataclasses.replace(cfg, **changes)
