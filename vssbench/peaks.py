"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity), copied here so that the yardstick stays fixed.
The same figures sit in ``src/repro_torch/launch/roofline.py``."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
HBM_BYTES = 80e9
POWER_LIMIT_W = 700.0  # the rates above assume the full power limit
