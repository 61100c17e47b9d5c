"""Serving: the paged KV pool and the continuous-batching engine, and
the video service tier (coalesced reads, QoS admission, signed URLs)."""
from repro_torch.serving.pages import PagePool, PagePoolConfig  # noqa: F401
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.coalesce import (  # noqa: F401
    BatchCoalescer,
    DeadlineExceeded,
)
from repro_torch.serving.qos import (  # noqa: F401
    AdmissionController,
    Denial,
    TokenBucket,
)
from repro_torch.serving.signing import UrlSigner  # noqa: F401
from repro_torch.serving.service import VSSService, spec_from_json  # noqa: F401
