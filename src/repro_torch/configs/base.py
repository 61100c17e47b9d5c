"""Architecture config schema + the assigned input-shape suite."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # None → d_model // num_heads
    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e4
    use_rope: bool = True
    local_window: Optional[int] = None
    # norms / activations
    norm_type: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    # MoE
    moe: Optional[MoESpec] = None
    # repeating block pattern (cycled to num_layers)
    pattern: Tuple[str, ...] = ("attn",)
    # first layer dense even in an MoE stack (DeepSeek-MoE)
    first_dense_ff: Optional[int] = None
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    # modality frontend stub: input_specs() provides embeddings directly
    frontend: Optional[str] = None  # "audio" | "vision"
    num_frontend_tokens: int = 0
    frontend_dim: int = 128  # stub embedding width before projection
    # recurrent dims
    rnn_width: Optional[int] = None
    mlstm_heads: int = 4
    tie_embeddings: bool = False
    sub_quadratic: bool = False  # can run long_500k
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def layer_types(self) -> List[str]:
        out = []
        i = 0
        while len(out) < self.num_layers:
            out.append(self.pattern[i % len(self.pattern)])
            i += 1
        return out

    def group_structure(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(group_pattern, num_full_groups, tail_pattern)."""
        p = len(self.pattern)
        n_groups = self.num_layers // p
        tail_len = self.num_layers - n_groups * p
        return self.pattern, n_groups, tuple(self.pattern[:tail_len])


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> List[ShapeSpec]:
    """The assigned shape set, with principled skips (DESIGN.md §5):
    long_500k only for sub-quadratic archs."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out
