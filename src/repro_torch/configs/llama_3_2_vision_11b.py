"""llama-3.2-vision-11b — VLM, 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attn image layers every 5th layer (indices 3, 8, ...,
38). Vision tower stubbed: input_specs() provides patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    act="silu",
    gated_mlp=True,
    pattern=("attn", "attn", "attn", "xattn", "attn"),  # xattn at 3,8,…,38
    frontend="vision",
    num_frontend_tokens=1601,  # 1 tile × (40×40 patches + cls), stubbed
    frontend_dim=7680,  # vision tower output width before projection
    notes="image KV is computed once per request and read-only at decode",
)

SMOKE = _shrink(
    CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    head_dim=16,
)
