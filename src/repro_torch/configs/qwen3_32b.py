"""qwen3-32b — dense, 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm. [hf:Qwen/Qwen3-32B]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151_936,
    head_dim=128,  # Qwen3 fixes head_dim=128 independent of d_model
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    gated_mlp=True,
    pattern=("attn",),
    notes="qk-norm on per-head q/k; 1M rope theta",
)

SMOKE = _shrink(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    head_dim=16,
)
