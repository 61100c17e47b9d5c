"""`VSSConfig` / `ServiceConfig`: the unified construction surface.

Covers the three entry points (Python, ``VSS_*`` environment
overrides, strict JSON), the deprecated-keyword shim on both `VSS` and
`VSSService`, and the single-file service boot.

The reference's `tests/test_config.py` on the port (CPU): a boot file
picks the CPU with ``"store": {"device": "cpu"}``.  Plus the same
configs, verdicts and messages as the reference's on the same documents.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.serving import config as jsconfig
from repro_torch.core import config as tconfig
from repro_torch.serving import config as tsconfig
from repro_torch.core.cache import CachePolicy
from repro_torch.core.config import (
    AdaptiveConfig,
    DeferredConfig,
    IngestConfig,
    LEGACY_KWARGS,
    VSSConfig,
    config_from_legacy,
    parse_bool,
    strict_keys,
)
from repro_torch.core.store import VSS as _PortVSS
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.config import ServiceConfig, boot_from_json
from repro_torch.serving.service import VSSService


# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
torch.set_num_threads(1)


def VSS(root, *, config=None, **kw):
    """The port's store on the CPU (its default device is CUDA)."""
    cfg = config if config is not None else VSSConfig()
    return _PortVSS(root, config=dataclasses.replace(cfg, device="cpu"),
                    **kw)


@pytest.fixture()
def vss(tmp_path):
    """The port's counterpart of conftest's reference store."""
    store = VSS(str(tmp_path / "vss"))
    yield store
    store.close()


# ---------------------------------------------------------------------------
# legacy keyword shim
# ---------------------------------------------------------------------------

def test_every_legacy_kwarg_maps_into_config():
    cost_model, registry = object(), object()
    values = {
        "backend": "memory",
        "budget_multiple": 3.5,
        "solver": "greedy",
        "cost_model": cost_model,
        "cache_policy": CachePolicy(gamma=9.0),
        "enable_deferred": False,
        "enable_compaction": False,
        "use_pallas": True,
        "pipelined_ingest": False,
        "ingest_workers": 7,
        "ingest_queue_gops": 9,
        "registry": registry,
        "trace_capacity": 77,
    }
    assert set(values) == set(LEGACY_KWARGS)
    cfg = config_from_legacy(None, values)
    for kwarg, path in LEGACY_KWARGS.items():
        node = cfg
        for part in path.split("."):
            node = getattr(node, part)
        assert node == values[kwarg], kwarg
    # the shim signature itself covers every documented legacy kwarg
    params = set(inspect.signature(_PortVSS.__init__).parameters)
    assert set(LEGACY_KWARGS) <= params


def test_legacy_none_means_default():
    cfg = config_from_legacy(None, {"cache_policy": None, "cost_model": None})
    assert cfg == VSSConfig()


def test_legacy_kwargs_warn_and_match_config_store(tmp_path, clip):
    with pytest.warns(DeprecationWarning, match="deprecated"):
        old = VSS(
            str(tmp_path / "old"), budget_multiple=5.0,
            enable_deferred=False, enable_compaction=False,
            ingest_workers=3, ingest_queue_gops=8, trace_capacity=64,
        )
    new = VSS(str(tmp_path / "new"), config=VSSConfig(
        budget_multiple=5.0,
        deferred=DeferredConfig(enabled=False),
        compaction=False,
        ingest=IngestConfig(workers=3, queue_gops=8),
        trace_capacity=64,
    ))
    try:
        assert old.config == new.config
        for s in (old, new):
            s.write("v", clip, fps=30.0, codec="tvc-hi")
        a = old.read("v", t=(0.0, 1.0), codec="rgb", cache=False).frames
        b = new.read("v", t=(0.0, 1.0), codec="rgb", cache=False).frames
        assert np.array_equal(a, b)
    finally:
        old.close()
        new.close()


def test_config_constructor_does_not_warn(tmp_path):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        s = VSS(str(tmp_path / "s"), config=VSSConfig())
    s.close()


# ---------------------------------------------------------------------------
# environment overrides
# ---------------------------------------------------------------------------

def test_with_env_overrides_nested_leaves():
    cfg = VSSConfig().with_env({
        "VSS_SOLVER": "greedy",
        "VSS_BUDGET_MULTIPLE": "4.5",
        "VSS_CACHE_GAMMA": "3.25",
        "VSS_DEFERRED_ENABLED": "off",
        "VSS_ADAPTIVE_ENABLED": "on",
        "VSS_ADAPTIVE_HALF_LIFE_S": "12.5",
        "VSS_INGEST_WORKERS": "7",
        "VSS_USE_PALLAS": "false",
    })
    assert cfg.solver == "greedy"
    assert cfg.budget_multiple == 4.5
    assert cfg.cache.gamma == 3.25
    assert cfg.deferred.enabled is False
    assert cfg.adaptive.enabled is True
    assert cfg.adaptive.half_life_s == 12.5
    assert cfg.ingest.workers == 7
    assert cfg.use_pallas is False


def test_explicit_python_wins_over_env():
    cfg = VSSConfig(
        solver="greedy", ingest=IngestConfig(workers=5),
    ).with_env({
        "VSS_SOLVER": "dp",
        "VSS_INGEST_WORKERS": "9",
        "VSS_INGEST_QUEUE_GOPS": "64",  # still at default: env wins
    })
    assert cfg.solver == "greedy"
    assert cfg.ingest.workers == 5
    assert cfg.ingest.queue_gops == 64


def test_env_invalid_values_raise():
    with pytest.raises(ValueError, match="VSS_ADAPTIVE_ENABLED"):
        VSSConfig().with_env({"VSS_ADAPTIVE_ENABLED": "maybe"})
    with pytest.raises(ValueError, match="VSS_INGEST_WORKERS"):
        VSSConfig().with_env({"VSS_INGEST_WORKERS": "three"})


def test_env_override_reaches_store(tmp_path, monkeypatch):
    monkeypatch.setenv("VSS_ADAPTIVE_ENABLED", "1")
    s = VSS(str(tmp_path / "s"), config=VSSConfig(registry=MetricsRegistry()))
    try:
        assert s.config.adaptive.enabled is True
        assert s.adaptive is not None
    finally:
        s.close()


def test_parse_bool():
    assert parse_bool("YES") is True
    assert parse_bool(" 0 ") is False
    with pytest.raises(ValueError):
        parse_bool("definitely")


# ---------------------------------------------------------------------------
# strict JSON
# ---------------------------------------------------------------------------

def test_from_json_nested_fields():
    cfg = VSSConfig.from_json({
        "backend": "memory",
        "budget_multiple": 4,  # int promotes to float
        "solver": "greedy",
        "use_pallas": False,
        "deferred": {"enabled": False},
        "ingest": {"workers": 3, "autosize": True},
        "adaptive": {"enabled": True, "interval_s": 2},
    })
    assert cfg.backend == "memory"
    assert cfg.budget_multiple == 4.0
    assert cfg.use_pallas is False
    assert cfg.deferred.enabled is False
    assert cfg.ingest == IngestConfig(workers=3, autosize=True)
    assert cfg.adaptive.enabled is True
    assert cfg.adaptive.interval_s == 2.0


@pytest.mark.parametrize("doc", [
    {"nope": 1},                       # unknown top-level field
    {"registry": {}},                  # live objects can't come from JSON
    {"cost_model": {}},
    {"adaptive": {"heat": 1}},         # unknown nested field
    {"ingest": {"workers": "three"}},  # wrong leaf type
    {"use_pallas": "yes"},             # strings are not booleans
    {"compaction": 1},                 # ints are not booleans either
    {"adaptive": 7},                   # nested field must be an object
])
def test_from_json_rejects(doc):
    with pytest.raises(ValueError):
        VSSConfig.from_json(doc)


def test_strict_keys_reports_unknown_and_allowed():
    with pytest.raises(ValueError, match="typo_field"):
        strict_keys({"typo_field": 1}, ("real_field",), "Thing")
    assert strict_keys({"real_field": 1}, ("real_field",), "Thing") == {
        "real_field": 1
    }


# ---------------------------------------------------------------------------
# serving tier: ServiceConfig + single-file boot
# ---------------------------------------------------------------------------

def test_service_config_from_json():
    sc = ServiceConfig.from_json({
        "host": "0.0.0.0", "port": 8123, "window_s": 0.01,
        "admission": {"tenant_rate": 10, "queue_limit": 4},
    })
    assert sc.host == "0.0.0.0"
    assert sc.port == 8123
    assert sc.window_s == 0.01
    assert sc.admission.tenant_rate == 10.0
    assert sc.admission.queue_limit == 4
    with pytest.raises(ValueError):
        ServiceConfig.from_json({"windows": 0.01})
    with pytest.raises(ValueError):
        ServiceConfig.from_json({"admission": {"rate": 1}})


def test_service_legacy_kwargs_warn(tmp_path):
    vss = VSS(str(tmp_path / "s"), config=VSSConfig(
        registry=MetricsRegistry()))
    with pytest.warns(DeprecationWarning, match="deprecated"):
        service = VSSService(vss, window_s=0.01, max_batch=8)
    try:
        assert service.config.window_s == 0.01
        assert service.config.max_batch == 8
    finally:
        service.close()
        vss.close()


def test_boot_from_json(tmp_path):
    vss, service = boot_from_json({
        "root": str(tmp_path / "s"),
        "store": {"adaptive": {"enabled": True}, "device": "cpu"},
        "service": {"port": 0, "window_s": 0.01},
    })
    try:
        assert vss.adaptive is not None
        assert vss.device == "cpu"
        assert service.config.window_s == 0.01
    finally:
        service.close()
        vss.close()


@pytest.mark.parametrize("doc", [
    {},                                      # root is required
    {"root": 7},                             # ... and must be a string
    {"root": "/tmp/x", "extra": {}},         # unknown top-level section
    {"root": "/tmp/x", "store": {"nope": 1}},
])
def test_boot_from_json_rejects(doc):
    with pytest.raises(ValueError):
        boot_from_json(doc)


def test_adaptive_config_defaults_are_observe_only():
    cfg = AdaptiveConfig()
    assert cfg.profile is True and cfg.enabled is False


# ---------------------------------------------------------------------------
# the port's device in a boot file, and the reference's verdicts
# ---------------------------------------------------------------------------

def test_boot_from_json_defaults_to_the_card(tmp_path):
    """A boot file that names no device asks for CUDA: without a card it
    raises before the store touches the disk."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        boot_from_json({"root": str(tmp_path / "s"), "store": {}})
    assert not (tmp_path / "s").exists()


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out.pop("device", None)  # the port's own field
    return out


STORE_DOCS = [
    {},
    {"backend": "memory", "budget_multiple": 4, "solver": "greedy",
     "use_pallas": False, "deferred": {"enabled": False},
     "ingest": {"workers": 3, "autosize": True},
     "adaptive": {"enabled": True, "interval_s": 2}},
    {"cache": {"gamma": 2.5}, "tiering": {"hot_bytes": 4096},
     "remote": {"sig_ttl_s": 30.0}, "trace_capacity": 5},
    {"nope": 1}, {"registry": {}}, {"cost_model": {}},
    {"adaptive": {"heat": 1}}, {"ingest": {"workers": "three"}},
    {"use_pallas": "yes"}, {"compaction": 1}, {"adaptive": 7},
]


def _store_verdict(C, doc):
    try:
        return ("ok", _fields(C.VSSConfig.from_json(doc)))
    except ValueError as exc:
        # the port's list of allowed fields adds its own, 'device'
        return ("ValueError", str(exc).replace("'device', ", ""))


@pytest.mark.parametrize("doc", STORE_DOCS,
                         ids=[f"doc{i}" for i in range(len(STORE_DOCS))])
def test_store_json_matches_reference(doc):
    assert _store_verdict(tconfig, doc) == _store_verdict(jconfig, doc)


SERVICE_DOCS = [
    {},
    {"host": "0.0.0.0", "port": 8123, "window_s": 0.01, "max_batch": 3,
     "url_ttl_s": 60, "admission": {"tenant_rate": 10, "queue_limit": 4,
                                    "inflight_bytes_limit": 1 << 30,
                                    "tenant_burst": 1}},
    {"windows": 0.01}, {"admission": {"rate": 1}}, {"port": "80"},
    {"max_batch": 2.5}, {"admission": 3}, {"window_s": True},
]


def _service_verdict(C, doc):
    try:
        return ("ok", dataclasses.asdict(C.ServiceConfig.from_json(doc)))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("doc", SERVICE_DOCS,
                         ids=[f"doc{i}" for i in range(len(SERVICE_DOCS))])
def test_service_json_matches_reference(doc):
    assert _service_verdict(tsconfig, doc) == _service_verdict(jsconfig, doc)


BOOT_DOCS = [
    {}, {"root": 7}, {"root": ""}, {"root": "/x", "extra": {}},
    {"root": "/x", "store": {"nope": 1}},
    {"root": "/x", "service": {"nope": 1}},
]


@pytest.mark.parametrize("doc", BOOT_DOCS,
                         ids=[f"doc{i}" for i in range(len(BOOT_DOCS))])
def test_boot_rejections_match_reference(doc):
    messages = []
    for boot in (jsconfig.boot_from_json, boot_from_json):
        with pytest.raises(ValueError) as ei:
            boot(doc)
        messages.append(str(ei.value))
    assert messages[1].replace("'device', ", "") == messages[0]


def test_env_overrides_match_reference():
    env = {"VSS_SOLVER": "greedy", "VSS_BUDGET_MULTIPLE": "4.5",
           "VSS_CACHE_GAMMA": "3.25", "VSS_DEFERRED_ENABLED": "off",
           "VSS_ADAPTIVE_ENABLED": "on", "VSS_ADAPTIVE_HALF_LIFE_S": "12.5",
           "VSS_INGEST_WORKERS": "7", "VSS_USE_PALLAS": "false",
           "VSS_TIERING_HOT_BYTES": "1024", "VSS_DEVICE": "cpu"}
    a = jconfig.VSSConfig().with_env(env)
    b = tconfig.VSSConfig().with_env(env)
    assert _fields(b) == _fields(a)
    assert b.device == "cuda"  # no environment variable picks the device
    for bad in ({"VSS_ADAPTIVE_ENABLED": "maybe"},
                {"VSS_INGEST_WORKERS": "three"}):
        messages = []
        for C in (jconfig, tconfig):
            with pytest.raises(ValueError) as ei:
                C.VSSConfig().with_env(bad)
            messages.append(str(ei.value))
        assert messages[1] == messages[0]
    assert tconfig.LEGACY_KWARGS == jconfig.LEGACY_KWARGS
