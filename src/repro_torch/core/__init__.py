"""The paper's primary contribution: the VSS storage manager."""
from repro_torch.core.config import (  # noqa: F401
    AdaptiveConfig,
    DeferredConfig,
    IngestConfig,
    TieringConfig,
    VSSConfig,
)
from repro_torch.core.ingest import (  # noqa: F401
    IngestPipeline,
    IngestStats,
    PublishWindow,
)
from repro_torch.core.profile import AccessProfiler, AdaptivePolicy  # noqa: F401
from repro_torch.core.spec import ReadSpec, ResolvedRead, WriteSpec  # noqa: F401
from repro_torch.core.store import VSS, ReadResult, VSSWriter, resample  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    DEFAULT_QUALITY_EPS_DB,
    Fragment,
    GopMeta,
    PhysicalMeta,
    PhysicalParams,
    SpatialParams,
    TemporalParams,
    chain_mse_bound,
    mse_to_psnr,
    psnr_to_mse,
)
