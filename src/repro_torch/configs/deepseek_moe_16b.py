"""deepseek-moe-16b — fine-grained MoE, 28L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=102400, 2 shared + 64 routed top-6; first layer
dense (d_ff=10944). [arXiv:2401.06066]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,  # per-expert hidden width
    vocab_size=102_400,
    rope_theta=10_000.0,
    act="silu",
    gated_mlp=True,
    moe=MoESpec(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
    pattern=("moe",),
    first_dense_ff=10944,  # DeepSeek keeps layer 0 dense
    notes="fine-grained experts: EP shards 64 experts over the model axis",
)

SMOKE = _shrink(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=32,
    first_dense_ff=128,
)
