"""Hand-written Hopper kernels for VSS hot-spots.

Each kernel module (``delta_codec``, ``transcode``, ``warp``,
``histogram``, ``paged_attention``, ``mse``, ``box_mean``) wraps a CUDA
C++ source under ``repro_torch/csrc/``, built at first use by ``_build``;
`ops.py` holds the public entry points (layout, dispatch by device) and
`ref.py` the plain PyTorch versions that define semantics (the box
mean's, which mirrors no reference kernel, sits in its own module).
"""
from repro_torch.kernels import ops, ref  # noqa: F401
