"""llama4-scout-17b-a16e — MoE top-1, 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, 16 routed experts top-1 + 1 shared.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    rope_theta=500_000.0,
    act="silu",
    gated_mlp=True,
    moe=MoESpec(num_experts=16, top_k=1, d_expert=8192, num_shared=1),
    pattern=("moe",),
    notes="top-1 routing: dispatch is a pure permutation; early-fusion "
    "multimodality is out of assigned scope (text backbone only)",
)

SMOKE = _shrink(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=64,
    head_dim=16,
)
