"""`ServiceConfig`: the serving tier's construction surface, mirroring
`repro_torch.core.config.VSSConfig` for the store.

One JSON file boots a whole service (store + front end) through
:func:`boot_from_json` / ``python -m repro_torch.serving.service --config``:

    {
      "root": "/data/vss",
      "store":   {"backend": "tiered:remote",
                  "adaptive": {"enabled": true}},
      "service": {"host": "0.0.0.0", "port": 8090,
                  "window_s": 0.004, "max_batch": 64,
                  "admission": {"tenant_rate": 100.0}}
    }

The store runs its codec on ``"store": {"device": ...}``: ``"cuda"``
(the default) launches the hand-written kernels and raises without a
card; ``"cpu"`` runs their plain versions.

Parsing reuses the strict unknown-key validation contract of
``spec_from_json`` (`repro_torch.core.config.strict_keys`), so a typo in a
config file is a boot-time error, never a silently-ignored knob.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

from repro_torch.core.config import VSSConfig, _coerce_scalar, strict_keys
from repro_torch.serving.coalesce import DEFAULT_INTAKE_WINDOW_S, DEFAULT_MAX_BATCH
from repro_torch.serving.signing import DEFAULT_TTL_S


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Declarative `AdmissionController` knobs (qos.py)."""

    queue_limit: int = 64
    inflight_bytes_limit: int = 256 * 1024 * 1024
    tenant_rate: float = 200.0
    tenant_burst: float = 400.0

    def build(self, registry=None):
        from repro_torch.serving.qos import AdmissionController

        return AdmissionController(
            queue_limit=self.queue_limit,
            inflight_bytes_limit=self.inflight_bytes_limit,
            tenant_rate=self.tenant_rate,
            tenant_burst=self.tenant_burst,
            registry=registry,
        )


_SERVICE_FIELDS = (
    "host", "port", "window_s", "max_batch", "url_ttl_s", "admission",
)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Everything `VSSService(vss, config=...)` needs beyond the store
    handle.  Live objects (a pre-built `AdmissionController`, a
    `UrlSigner`, a registry) remain injection kwargs on `VSSService`."""

    host: str = "127.0.0.1"
    port: int = 0
    window_s: float = DEFAULT_INTAKE_WINDOW_S
    max_batch: int = DEFAULT_MAX_BATCH
    url_ttl_s: float = DEFAULT_TTL_S
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)

    def replace(self, **kw) -> "ServiceConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "ServiceConfig":
        data = strict_keys(obj, _SERVICE_FIELDS, "ServiceConfig")
        kw = {}
        for name, value in data.items():
            if name == "admission":
                adm = strict_keys(
                    value,
                    [f.name for f in dataclasses.fields(AdmissionConfig)],
                    "ServiceConfig.admission",
                )
                kw[name] = AdmissionConfig(**{
                    k: _coerce_scalar(
                        f"admission.{k}", v, getattr(AdmissionConfig(), k))
                    for k, v in adm.items()
                })
            else:
                kw[name] = _coerce_scalar(
                    name, value, getattr(cls(), name))
        return cls(**kw)


_BOOT_FIELDS = ("root", "store", "service")


def boot_from_json(doc: Mapping[str, Any]) -> Tuple[Any, Any]:
    """Build ``(VSS, VSSService)`` from one parsed JSON document — the
    single-file boot path behind ``python -m repro_torch.serving.service
    --config``.  ``store`` is a `VSSConfig.from_json` object and
    ``service`` a `ServiceConfig.from_json` object; both optional."""
    from repro_torch.core.store import VSS
    from repro_torch.serving.service import VSSService

    data = strict_keys(doc, _BOOT_FIELDS, "service boot config")
    root = data.get("root")
    if not isinstance(root, str) or not root:
        raise ValueError("service boot config: 'root' (string) is required")
    store_cfg: Optional[VSSConfig] = None
    if "store" in data:
        store_cfg = VSSConfig.from_json(data["store"])
    svc_cfg = ServiceConfig.from_json(data.get("service", {}))
    vss = VSS(root, config=store_cfg)
    try:
        service = VSSService(vss, config=svc_cfg)
    except BaseException:
        vss.close()
        raise
    return vss, service
