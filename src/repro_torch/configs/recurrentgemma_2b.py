"""recurrentgemma-2b — hybrid RG-LRU + local attention (1 local per 2
recurrent), 26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
[arXiv:2402.19427]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    local_window=2048,
    act="gelu",
    gated_mlp=True,
    pattern=("rglru", "rglru", "local"),  # Griffin 2:1 temporal mix
    rnn_width=2560,
    sub_quadratic=True,  # bounded window + recurrent state → long_500k runs
    notes="decode state = RG-LRU h + conv tail + 2048-window KV ring",
)

SMOKE = _shrink(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, d_ff=128,
    head_dim=16,
)
