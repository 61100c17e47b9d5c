"""minitron-4b — dense (pruned nemotron), 32L d_model=3072 24H (GQA kv=8)
d_ff=9216 vocab=256000. [arXiv:2407.14679]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=128,
    rope_theta=10_000.0,
    act="silu",
    gated_mlp=True,
    pattern=("attn",),
    notes="pruned nemotron; large 256K vocab stresses embedding sharding",
)

SMOKE = _shrink(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    head_dim=16,
)
