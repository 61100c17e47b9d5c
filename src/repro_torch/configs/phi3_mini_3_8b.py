"""phi3-mini-3.8b — dense, 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064, RoPE + SwiGLU. [arXiv:2404.14219]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    act="silu",
    gated_mlp=True,
    pattern=("attn",),
    notes="kv=32 heads: MHA-equivalent GQA; full attention → long_500k skipped",
)

SMOKE = _shrink(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128
)
