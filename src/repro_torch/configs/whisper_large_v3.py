"""whisper-large-v3 — audio enc-dec, 32L d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866; conv frontend stubbed (input_specs provides
log-mel frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,  # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    use_rope=False,  # learned absolute positions
    norm_type="layernorm",
    act="gelu",
    gated_mlp=False,
    pattern=("dec",),  # decoder layer = self-attn + cross-attn + mlp
    frontend="audio",
    num_frontend_tokens=1500,  # 30 s of audio after the conv stride-2 stub
    notes=(
        "enc-dec; encoder non-causal over 1500 audio frames; decode shapes "
        "decode against decoder self-attn KV + fixed encoder cross-attn KV"
    ),
)

SMOKE = _shrink(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128
)
