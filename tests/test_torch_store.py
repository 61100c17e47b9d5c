"""The port's storage manager against the reference's, on the CPU.

Both packages get the same clip, writes and reads; results must agree
exactly, except the non-integer bilinear resize (max |Δ| ≤ 1, see
`test_bilinear_resolution_within_one`).  Stores written by either
package open and read back bit-exactly in the other, and two stores
driven through the same operations hold the same catalog rows and the
same object bytes.

The cases of the reference's `tests/test_store.py` run on the port (CPU)
at the end of this file."""
import dataclasses
import json
import os
import socket
import sqlite3
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import codec as jcodec
from repro.core.config import VSSConfig as JConfig
from repro.core.cost import CostModel as JCostModel
from repro.core.cost import calibration_path
from repro.core.spec import ReadSpec as JReadSpec
from repro.core.store import VSS as JVSS
from repro.core.store import resample as jresample
from repro_torch import codec as tcodec
from repro_torch.core import store as tstore_mod
from repro_torch.core.resize import resample as tresample
from repro_torch.core.config import VSSConfig as TConfig
from repro_torch.core.quality import exact_psnr
from repro_torch.core.spec import ReadSpec as TReadSpec
from repro_torch.core.store import VSS as TVSS

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing cores
torch.set_num_threads(1)


def _jstore(root):
    return JVSS(str(root), config=JConfig(backend="local"))


def _tstore(root):
    return TVSS(str(root), config=TConfig(backend="local", device="cpu"))


@pytest.fixture()
def pair(tmp_path, clip):
    """A reference store and a port store, each holding ``clip`` as
    tvc-hi (``hevc``)."""
    j, t = _jstore(tmp_path / "j"), _tstore(tmp_path / "t")
    j.write("v", clip, fps=30.0, codec="hevc")
    t.write("v", clip, fps=30.0, codec="hevc")
    yield j, t
    j.close()
    t.close()


def _same(rj, rt):
    assert rt.codec == rj.codec
    assert np.array_equal(rt.frames, rj.frames)
    if rj.encoded is not None:
        assert [tcodec.serialize_gop(e) for e in rt.encoded] == [
            jcodec.serialize_gop(e) for e in rj.encoded]
    assert rt.plan.segments == rj.plan.segments
    assert rt.plan.selection.assignment == rj.plan.selection.assignment


READS = {
    "full": {},
    "t-window": {"t": (0.4, 1.3)},
    "roi": {"roi": (32, 16, 96, 80)},
    "resolution-64x48": {"resolution": (64, 48)},
    "fps-15": {"fps": 15.0},
    "codec-h264": {"codec": "h264"},
    "codec-lossless-window": {"codec": "lossless", "t": (0.5, 1.5)},
}


@pytest.mark.parametrize("kind", list(READS))
def test_reads_match_reference_exactly(pair, kind):
    j, t = pair
    _same(j.read("v", **READS[kind]), t.read("v", **READS[kind]))
    # a second read plans over the view the first one admitted
    _same(j.read("v", **READS[kind]), t.read("v", **READS[kind]))


def test_read_batch_matches_reference_exactly(pair):
    j, t = pair
    specs = [dict(name="v", t=(0.0, 1.0)), dict(name="v", t=(0.5, 1.8)),
             dict(name="v", codec="h264", t=(1.0, 2.0)),
             dict(name="v", resolution=(64, 48))]
    rj = j.read_batch([JReadSpec(**s) for s in specs])
    rt = t.read_batch([TReadSpec(**s) for s in specs])
    for a, b in zip(rj, rt):
        _same(a, b)


def test_bilinear_resolution_within_one(pair):
    """(100, 75) is no integer factor of 128×96, so both packages run
    the antialiased bilinear resize: jax.image.resize in the reference,
    its triangle-kernel weight matrices in torch in the port.  The
    weighted sums run in another order, so a value within float rounding
    of a .5 boundary can round the other way: at most 1 on uint8."""
    j, t = pair
    a = j.read("v", resolution=(100, 75), cache=False).frames
    b = t.read("v", resolution=(100, 75), cache=False).frames
    assert a.shape == b.shape == (60, 75, 100, 3)
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("size", [(100, 75), (200, 150), (37, 29)])
def test_resample_bilinear_within_one(clip, size):
    frames = clip[:4]
    a = jresample(frames, size)
    b = tresample(frames, size, device="cpu")
    assert a.shape == b.shape
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_resample_integer_box_exact(clip):
    frames = clip[:5]
    for size in ((64, 48), (32, 24), (128, 96)):
        assert np.array_equal(jresample(frames, size),
                              tresample(frames, size, device="cpu"))


def _catalog_rows(root):
    con = sqlite3.connect(os.path.join(root, "catalog.sqlite"))
    try:
        phys = con.execute(
            "SELECT id, logical, width, height, fps, codec, roi_x0, roi_y0,"
            " roi_x1, roi_y1, t_start, t_end, mse_bound, parent_is_original,"
            " is_original, tiles_r, tiles_c FROM physical ORDER BY id"
        ).fetchall()
        gops = con.execute("SELECT * FROM gop ORDER BY id").fetchall()
        meta = con.execute(
            "SELECT * FROM meta WHERE name = 'storage_layout'").fetchall()
        logical = con.execute(
            "SELECT name, budget_bytes, original_physical FROM logical"
        ).fetchall()
    finally:
        con.close()
    return phys, gops, meta, logical


def _objects(root):
    base = os.path.join(root, "objects")
    out = {}
    for d, _dirs, files in os.walk(base):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = fh.read()
    return out


def test_stores_identical_on_disk(tmp_path, clip):
    roots = []
    for make, name in ((_jstore, "j"), (_tstore, "t")):
        vss = make(tmp_path / name)
        vss.write("v", clip, fps=30.0, codec="hevc")
        vss.write("w", clip[:20], fps=30.0, codec="rgb")
        vss.read("v", codec="h264", t=(0.0, 1.0))
        vss.read("v", resolution=(64, 48))
        vss.read("w", codec="lossless")
        vss.close()
        roots.append(str(tmp_path / name))
    assert _catalog_rows(roots[0]) == _catalog_rows(roots[1])
    assert _catalog_rows(roots[0])[2] == [("storage_layout", "local")]
    assert _objects(roots[0]) == _objects(roots[1])


def test_reference_store_reads_back_in_port(tmp_path, clip):
    root = tmp_path / "s"
    j = _jstore(root)
    j.write("v", clip, fps=30.0, codec="hevc")
    j.write("w", clip[:30], fps=30.0, codec="tvc-ll")
    j.read("v", resolution=(64, 48))  # a cached view too
    want_v = j.read("v", cache=False).frames
    want_w = j.read("w", cache=False).frames
    j.close()
    cal = calibration_path(str(root))
    JCostModel.default().save(cal)
    t = _tstore(root)
    assert t.cost_model.table == JCostModel.load(cal).table
    assert t.cost_model.io_table == JCostModel.load(cal).io_table
    assert np.array_equal(t.read("v", cache=False).frames, want_v)
    assert np.array_equal(t.read("w", cache=False).frames, want_w)
    assert np.array_equal(t.read("w", cache=False).frames, clip[:30])
    t.close()


def test_port_store_reads_back_in_reference(tmp_path, clip):
    root = tmp_path / "s"
    t = _tstore(root)
    t.write("v", clip, fps=30.0, codec="tvc-med")
    t.read("v", codec="hevc", t=(0.0, 1.0))
    want = t.read("v", cache=False).frames
    want_hevc = t.read("v", codec="hevc", t=(0.0, 1.0), cache=False)
    t.close()
    j = _jstore(root)
    assert np.array_equal(j.read("v", cache=False).frames, want)
    got = j.read("v", codec="hevc", t=(0.0, 1.0), cache=False)
    assert np.array_equal(got.frames, want_hevc.frames)
    j.close()


def test_read_result_frames_decode_on_store_device(pair, monkeypatch):
    """A compressed result decodes lazily in ``ReadResult.frames``; that
    decode must run on the store's device, not the codec's default."""
    _j, t = pair
    seen = []
    real = tcodec.decode_gop

    def spy(enc, **kw):
        seen.append(kw.get("device"))
        return real(enc, **kw)

    r = t.read("v", codec="h264", cache=False)
    assert r._frames is None and r.device == t.device == "cpu"
    monkeypatch.setattr(tstore_mod._codec, "decode_gop", spy)
    frames = r.frames
    assert frames.shape == (60, 96, 128, 3)
    assert seen and set(seen) == {"cpu"}


def test_use_pallas_false_refused_on_cuda(tmp_path):
    with pytest.raises(ValueError, match="use_pallas"):
        TVSS(str(tmp_path / "s"), config=TConfig(use_pallas=False))
    # on the CPU the plain versions are the only path, so it is allowed
    TVSS(str(tmp_path / "c"),
         config=TConfig(use_pallas=False, device="cpu")).close()


def test_reference_config_document_boots_port(tmp_path):
    doc = {"backend": "memory", "use_pallas": True, "solver": "greedy",
           "cache": {"gamma": 4.0}, "ingest": {"workers": 1},
           "tiering": {"hot_bytes": 1 << 20}, "remote": {"sig_ttl_s": 60.0},
           "adaptive": {"enabled": False}, "trace_capacity": 16}
    jcfg = JConfig.from_json(doc)
    tcfg = TConfig.from_json(dict(doc, device="cpu"))
    for field in doc:
        a, b = getattr(jcfg, field), getattr(tcfg, field)
        if hasattr(a, "__dataclass_fields__"):
            a, b = vars(a), vars(b)
        assert a == b, field
    vss = TVSS(str(tmp_path / "s"), config=tcfg)
    assert vss.device == "cpu"
    vss.close()


def test_device_has_no_environment_override(monkeypatch):
    monkeypatch.setenv("VSS_DEVICE", "cpu")
    assert TConfig().with_env().device == "cuda"
    monkeypatch.setenv("VSS_SOLVER", "greedy")
    assert TConfig().with_env().solver == "greedy"


def _no_name_lookups(monkeypatch):
    """Resolve loopback only: a spec naming another host must fail here,
    in both packages alike, without asking a name server."""
    real = socket.getaddrinfo

    def loopback_only(host, *args, **kw):
        if host not in ("127.0.0.1", "localhost", "::1"):
            raise socket.gaierror(socket.EAI_NONAME,
                                  "Name or service not known")
        return real(host, *args, **kw)

    monkeypatch.setattr(socket, "getaddrinfo", loopback_only)


def _gop_objects(vss):
    return {g.path: vss.backend.get(g.path)
            for g in vss.catalog.all_gops()}


@pytest.mark.parametrize("spec", ["sharded:2", "tiered", "tiered:remote",
                                  "replicated:3:2:2", "remote",
                                  "remotes:https://h:1"])
def test_backend_specs_match_reference(tmp_path, clip, monkeypatch, spec):
    """Every spec of the grammar builds in the port: a store on it
    writes and reads the same frames and the same GOP objects as the
    reference's, and a spec that cannot open fails as it does there."""
    _no_name_lookups(monkeypatch)
    if spec.startswith("remotes:"):
        errors = []
        for make, config, name in ((JVSS, JConfig, "j"),
                                   (TVSS, TConfig, "t")):
            kw = {"device": "cpu"} if make is TVSS else {}
            with pytest.raises(Exception) as ei:
                make(str(tmp_path / name),
                     config=config(backend=spec, **kw))
            errors.append((type(ei.value).__name__, str(ei.value)))
        assert errors[1] == errors[0]
        assert errors[0][0] == "RemoteError"
        return
    stores = [JVSS(str(tmp_path / "j"), config=JConfig(backend=spec)),
              TVSS(str(tmp_path / "t"),
                   config=TConfig(backend=spec, device="cpu"))]
    try:
        for vss in stores:
            vss.write("v", clip, fps=30.0, codec="hevc")
        assert (stores[1].backend.layout_fingerprint().split(":")[0]
                == stores[0].backend.layout_fingerprint().split(":")[0])
        for kw in ({}, {"t": (0.4, 1.3)}, {"codec": "h264"}):
            _same(*(vss.read("v", cache=False, **kw) for vss in stores))
        assert _gop_objects(stores[1]) == _gop_objects(stores[0])
    finally:
        for vss in stores:
            vss.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_store_surfaces_match_reference(tmp_path, clip):
    """The metrics server serves ``/metrics`` and ``/healthz`` in the
    port as in the reference: the same statuses, health report and
    metric families (each store on a registry of its own, so no other
    store in the process shows), and no object plane.  Joint compression
    is ported (tests/test_torch_joint.py): over one video it finds no
    pair across videos and returns nothing, and a GOP whose joint record
    is missing fails on the record, not on a missing port."""
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry as TRegistry

    j = JVSS(str(tmp_path / "j"), config=JConfig(
        backend="local", registry=JRegistry()))
    t = TVSS(str(tmp_path / "t"), config=TConfig(
        backend="local", device="cpu", registry=TRegistry()))
    try:
        answers = []
        for vss in (j, t):
            vss.write("v", clip, fps=30.0, codec="hevc")
            vss.read("v", t=(0.0, 0.5), cache=False)
            srv = vss.start_metrics_server()
            assert vss.start_metrics_server() is srv  # idempotent
            status, body = _get(srv.url + "/metrics")
            families = sorted(line.split()[2] for line in body.decode()
                              .splitlines() if line.startswith("# TYPE "))
            hstatus, hbody = _get(srv.url + "/healthz")
            health = json.loads(hbody)
            answers.append((status, families, hstatus, sorted(health),
                            health["status"], _get(srv.url + "/o/k")[0]))
        assert answers[1] == answers[0]
        assert answers[0][0] == answers[0][2] == 200
        assert answers[0][5] == 503
        assert t.apply_joint_compression() == []
        g = t.catalog.gops_for(t.catalog.get_original_id("v"))[0]
        with t.catalog._lock:
            t.catalog._conn.execute(
                "UPDATE gop SET joint_ref = 1 WHERE id = ?", (g.gop_id,))
            t.catalog._conn.commit()
        with pytest.raises(KeyError, match="joint 1 not found"):
            t.read("v", t=(0.0, 0.5), cache=False)
    finally:
        j.close()
        t.close()


# ---------------------------------------------------------------------------
# the reference's tests/test_store.py on the port (paper §2–§3 behaviour)
# ---------------------------------------------------------------------------

def VSS(root, *, config=None, **kw):
    """The port's store on the CPU (its default device is CUDA)."""
    cfg = config if config is not None else TConfig()
    return TVSS(root, config=dataclasses.replace(cfg, device="cpu"), **kw)


@pytest.fixture()
def vss(tmp_path):
    """The port's counterpart of conftest's reference store."""
    store = VSS(str(tmp_path / "vss"))
    yield store
    store.close()


def test_write_read_roundtrip_lossless(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-ll")
    out = vss.read("v", codec="rgb", cache=False).frames
    assert out.shape == clip.shape
    assert np.array_equal(out, clip)  # tvc-ll is bit-exact


@pytest.mark.parametrize("codec,min_db", [
    ("tvc-hi", 48.0), ("tvc-med", 38.0), ("tvc-lo", 28.0),
])
def test_tier_quality(vss, clip, codec, min_db):
    vss.write("v", clip, fps=30.0, codec=codec)
    out = vss.read("v", codec="rgb", cache=False).frames
    assert exact_psnr(out, clip) >= min_db


def test_temporal_range_read(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    r = vss.read("v", t=(0.5, 1.5), codec="rgb", cache=False)
    assert r.frames.shape[0] == 30
    ref = vss.read("v", codec="rgb", cache=False).frames[15:45]
    assert np.array_equal(r.frames, ref)


def test_roi_and_resolution(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    r = vss.read("v", roi=(32, 16, 96, 80), codec="rgb", cache=False)
    assert r.frames.shape[1:3] == (64, 64)
    r2 = vss.read("v", resolution=(64, 48), codec="rgb", cache=False)
    assert r2.frames.shape[1:3] == (48, 64)


def test_fps_division(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    r = vss.read("v", fps=15.0, codec="rgb", cache=False)
    assert r.frames.shape[0] == 30
    with pytest.raises(RuntimeError):
        vss.read("v", fps=45.0, codec="rgb", cache=False)  # non-integer ratio


def test_read_outside_interval_rejected(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    with pytest.raises(ValueError):
        vss.read("v", t=(1.0, 3.0), codec="rgb")


def test_no_overwrite_policy(vss, clip):
    vss.write("v", clip, fps=30.0)
    with pytest.raises(ValueError):
        vss.write("v", clip, fps=30.0)


def test_streaming_prefix_read(vss, clip):
    w = vss.writer("v", fps=30.0, codec="tvc-hi", gop_frames=15)
    w.append(clip[:30])  # two GOPs land
    r = vss.read("v", t=(0.0, 1.0), codec="rgb", cache=False)
    assert r.frames.shape[0] == 30
    w.append(clip[30:])
    w.close()
    r = vss.read("v", codec="rgb", cache=False)
    assert r.frames.shape[0] == 60


def test_cached_views_speed_up_plans(vss, clip):
    """After a cached read, later overlapping reads select cached fragments."""
    vss.write("v", clip, fps=30.0, codec="tvc-hi")
    r1 = vss.read("v", t=(0.5, 1.5), codec="tvc-med")  # cached as a view
    assert vss.stats("v")["physical_videos"] >= 2
    r2 = vss.read("v", t=(0.5, 1.5), codec="tvc-med", cache=False)
    # the cached tvc-med view should be chosen (same-codec fragments are
    # cheaper than transcoding the tvc-hi original)
    chosen = {c.video_idx for c in r2.plan.selection.chosen(r2.plan.problem)}
    codecs = {r2.plan.runs[i].physical.codec for i in chosen}
    assert "tvc-med" in codecs


def test_format_flexibility_any_to_any(vss, clip):
    vss.write("v", clip, fps=30.0, codec="h264")  # alias → tvc-med
    for out_codec in ("rgb", "hevc", "tvc-lo", "h264"):
        r = vss.read("v", codec=out_codec, cache=False,
                     quality_eps_db=20.0)
        assert r.frames.shape == clip.shape


def test_quality_cutoff_rejects_lossy_cache(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-ll")
    vss.read("v", codec="tvc-lo")  # caches a low-quality view
    r = vss.read("v", codec="rgb", quality_eps_db=45.0, cache=False)
    chosen = {c.video_idx for c in r.plan.selection.chosen(r.plan.problem)}
    for i in chosen:  # strict cutoff must avoid the tvc-lo view
        assert r.plan.runs[i].physical.codec != "tvc-lo"


def test_budget_eviction_keeps_lossless_cover(vss, clip):
    vss.write("v", clip, fps=30.0, codec="tvc-hi",
              budget_bytes=6_000_000)
    for t0 in (0.0, 0.5, 1.0):
        vss.read("v", t=(t0, t0 + 1.0), codec="rgb")  # big raw views
    # budget enforced (at least nothing unbounded) and a lossless cover
    # still reproduces the original
    out = vss.read("v", codec="rgb", cache=False).frames
    assert out.shape == clip.shape
    assert exact_psnr(out, clip) >= 40.0


# ---------------------------------------------------------------------------
# sub-GOP ranged reads + tiled physical layout
# ---------------------------------------------------------------------------

class _CountingBackend:
    """Wraps a backend and counts every payload byte it serves."""

    def __init__(self, inner):
        self._inner = inner
        self.bytes_served = 0

    def get(self, key):
        data = self._inner.get(key)
        self.bytes_served += len(data)
        return data

    def get_range(self, key, start, length):
        data = self._inner.get_range(key, start, length)
        self.bytes_served += len(data)
        return data

    def batch_get(self, keys):
        out = self._inner.batch_get(keys)
        self.bytes_served += sum(len(d) for d in out)
        return out

    def batch_get_ranges(self, reqs):
        out = self._inner.batch_get_ranges(reqs)
        self.bytes_served += sum(len(d) for d in out)
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_edge_trim_moves_strictly_fewer_bytes(tmp_path, clip):
    """A 3-frame read of a 30-frame GOP must fetch a strict byte subset
    of the GOP object — the ranged-I/O tentpole's core guarantee — and
    still decode bit-exactly."""
    from repro_torch.storage import MemoryBackend

    backend = _CountingBackend(MemoryBackend())
    vss = VSS(str(tmp_path / "vss"), backend=backend)
    vss.write("v", clip, fps=30.0, codec="tvc-ll", gop_frames=30)

    backend.bytes_served = 0
    trimmed = vss.read("v", t=(0.0, 3 / 30), codec="rgb", cache=False).frames
    trim_bytes = backend.bytes_served

    backend.bytes_served = 0
    full = vss.read("v", t=(0.0, 1.0), codec="rgb", cache=False).frames
    full_bytes = backend.bytes_served

    assert np.array_equal(trimmed, full[:3])  # bit-exact prefix decode
    assert trim_bytes < full_bytes  # strictly fewer bytes moved
    # the acceptance gate: a 3/30 trim keeps well under 60% of the bytes
    assert trim_bytes <= 0.6 * full_bytes
    assert vss.registry.value("vss_read_ranged_bytes_saved_total") > 0
    vss.close()


def test_tiled_roi_fetches_only_covering_tiles(tmp_path, clip):
    """An ROI read of a tiled video fetches a strict subset of the tile
    objects and stitches them bit-exactly."""
    from repro_torch.core.spec import WriteSpec
    from repro_torch.storage import MemoryBackend

    backend = _CountingBackend(MemoryBackend())
    vss = VSS(str(tmp_path / "vss"), backend=backend)
    w = vss.writer_spec(WriteSpec(name="v", fps=30.0, codec="tvc-ll",
                                  gop_frames=15, tiles=(2, 2)))
    w.append(clip)
    w.close()

    backend.bytes_served = 0
    full = vss.read("v", codec="rgb", cache=False).frames
    full_bytes = backend.bytes_served
    assert np.array_equal(full, clip)  # lossless stitch of all tiles

    # a quadrant ROI needs 1 of 4 tiles per GOP
    h, w_, roi = clip.shape[1], clip.shape[2], (0, 0, 40, 30)
    backend.bytes_served = 0
    part = vss.read("v", roi=roi, codec="rgb", cache=False).frames
    assert np.array_equal(part, clip[:, :30, :40])
    assert backend.bytes_served < 0.5 * full_bytes
    assert vss.registry.value("vss_tile_fetches_total") > 0
    vss.close()


try:
    import hypothesis.strategies as st
    from hypothesis import given, settings

    def _subgop_cases(fn):
        return settings(max_examples=12, deadline=None)(given(
            seed=st.integers(0, 2**31 - 1),
            codec=st.sampled_from(["tvc-ll", "tvc-hi", "tvc-med"]),
            hi=st.integers(1, 9),
            tiles=st.sampled_from([None, (2, 2), (1, 3), (3, 2)]),
        )(fn))

except ImportError:
    def _subgop_cases(fn):
        return pytest.mark.parametrize("seed,codec,hi,tiles", [
            (0, "tvc-ll", 3, None),
            (1, "tvc-hi", 1, (2, 2)),
            (2, "tvc-med", 7, (1, 3)),
            (3, "tvc-ll", 9, (3, 2)),
            (4, "tvc-hi", 4, None),
        ])(fn)


@_subgop_cases
def test_subgop_and_tile_bitexact_property(tmp_path_factory, seed, codec,
                                           hi, tiles):
    """Property: for any codec tier, trim point and tile grid, a ranged
    sub-GOP read and a tiled ROI read reproduce exactly the frames the
    whole-object path produces."""
    from repro_torch.core.spec import WriteSpec

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (1, 48, 64, 3), np.int16)
    drift = rng.integers(-2, 3, (24, 48, 64, 3), np.int16).cumsum(0)
    frames = np.clip(base + drift, 0, 255).astype(np.uint8)

    root = tmp_path_factory.mktemp("subgop")
    vss = VSS(str(root / "vss"))
    w = vss.writer_spec(WriteSpec(name="v", fps=12.0, codec=codec,
                                  gop_frames=12, tiles=tiles))
    w.append(frames)
    w.close()

    whole = vss.read("v", codec="rgb", cache=False).frames
    part = vss.read("v", t=(0.0, hi / 12.0), codec="rgb",
                    cache=False).frames
    assert np.array_equal(part, whole[:hi])

    roi = (tuple(rng.integers(0, 16, 2)) +
           tuple(rng.integers(33, 48, 1)) + tuple(rng.integers(33, 48, 1)))
    roi = (int(roi[0]), int(roi[1]), int(roi[2]), int(roi[3]))
    r = vss.read("v", roi=roi, codec="rgb", cache=False).frames
    assert np.array_equal(
        r, whole[:, roi[1]:roi[3], roi[0]:roi[2]]
    )
    vss.close()
