"""xlstm-1.3b — SSM-family, 48L d_model=2048, mLSTM:sLSTM = 7:1
(xLSTM[7:1]), vocab=50304, no separate MLP (blocks carry their own
up-projection). [arXiv:2405.04517]"""
from repro_torch.configs import _shrink
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,  # mLSTM heads
    num_kv_heads=4,
    d_ff=0,  # blocks are self-contained (proj_factor handles width)
    vocab_size=50_304,
    use_rope=False,
    act="gelu",
    gated_mlp=False,
    pattern=("mlstm",) * 7 + ("slstm",),  # xLSTM[7:1]
    mlstm_heads=4,
    sub_quadratic=True,  # pure recurrent state → long_500k runs
    notes="no KV cache at all; decode state = (conv, C, n, m) per block",
)

SMOKE = _shrink(
    CONFIG, num_layers=8, d_model=32, num_heads=2, num_kv_heads=2, d_ff=0
)
