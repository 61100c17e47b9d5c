"""repro_torch — VSS (Video Storage System, Haynes et al. 2021) on PyTorch
and CUDA, for an NVIDIA H100.

A port of the ``repro`` package (JAX on a TPU), which stays the
reference.  This package imports ``torch`` and never ``jax``, and none
of ``repro``.

Layers (bottom-up):
  repro_torch.kernels   hand-written CUDA kernels (+ plain PyTorch versions)
                        for the TVC codec's encode, decode and transcode
  repro_torch.codec     GOP-based tensor video codec (TVC) with quality tiers
  repro_torch.storage   local and in-memory object backends, crash recovery
  repro_torch.obs       metrics registry, read-path tracing
  repro_torch.core      the storage manager: catalog, cost/quality models,
                        fragment selection, LRU_VSS cache, deferred
                        compression, compaction, ingest pipeline
  repro_torch.data      synthetic video

Device work runs on ``"cuda"`` unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
