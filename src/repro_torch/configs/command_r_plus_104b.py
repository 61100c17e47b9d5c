"""command-r-plus-104b — dense, 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no-bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256_000,
    head_dim=128,
    rope_theta=75_000.0,
    act="silu",
    gated_mlp=True,
    tie_embeddings=True,  # Cohere ties input/output embeddings
    pattern=("attn",),
    notes="largest assigned dense arch; FSDP-dominant, checkpoint shards per host",
)

SMOKE = _shrink(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    head_dim=16,
)
