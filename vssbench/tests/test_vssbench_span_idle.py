"""The metrics that read the program's spans off the device trace: each
owns its names and no other metric's, never the benchmark's own labels,
and reads nothing on the CPU."""
import sys
import types
from pathlib import Path

import pytest

from vssbench import harness, span_idle
from vssbench.devtrace import DeviceTrace

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_vssbench_contract import BENCH  # noqa: E402

OWNS = {
    "entropy_idle_share.long_reads": span_idle.ENTROPY,
    "box_mean_idle_share.long_reads": span_idle.BOX_MEAN,
    "admit_idle_share.long_reads": span_idle.ADMIT,
    "fetch_idle_share.long_reads": span_idle.FETCH,
    "entropy_idle_share.ingest": span_idle.ENTROPY,
    "backpressure_idle_share.ingest": span_idle.BACKPRESSURE,
}
BENCHMARK_LABELS = [
    "vss.read", "vss.append", "vss.close", "vss.encode_gop",
    "vss.decode_gop", "vss.kernel.delta_encode", "vss.kernel.delta_decode",
    "vss.kernel.transcode", "host outside the program's entry points",
]
# gap name -> the metric group that owns it (None: no group)
GAPS = {
    "vss.codec.deflate.zlib": span_idle.ENTROPY,
    "vss.codec.inflate.zstd": span_idle.ENTROPY,
    "vss.deferred.deflate.zstd": span_idle.ENTROPY,
    "vss.deferred.inflate.zlib": span_idle.ENTROPY,
    "vss.store.resample_box": span_idle.BOX_MEAN,
    "vss.store.admit_put": span_idle.ADMIT,
    "vss.store.admit_step_mse": span_idle.ADMIT,
    "vss.store.admit_catalog": span_idle.ADMIT,
    "vss.store.evict": span_idle.ADMIT,
    "vss.store.compact": span_idle.ADMIT,
    "vss.store.fetch": span_idle.FETCH,
    "vss.ingest.backpressure": span_idle.BACKPRESSURE,
    "vss.store.decode": None,
    "vss.store.read_batch": None,
    "vss.store.plan": None,
    "vss.writer.flush_gop": None,
    "vss.ingest.publish": None,
    "vss.codec.h2d": None,
    "vss.codec.d2h": None,
    "vss.store.concat": None,
    "vss.writer.concat": None,
    "vss.codec.rgb_pack": None,
    "vss.codec.rgb_unpack": None,
    **{label: None for label in BENCHMARK_LABELS},
}
WINDOW_S = 100.0
LAYER = {"entropy_idle_share": "codec host",
         "box_mean_idle_share": "read execution",
         "admit_idle_share": "cache",
         "fetch_idle_share": "storage and ranged fetch",
         "backpressure_idle_share": "ingest"}


def _run(gaps, device="cuda"):
    trace = DeviceTrace(busy_s=WINDOW_S - sum(s for _n, s in gaps),
                        window_s=WINDOW_S, device_ops=[], idle_gaps=gaps,
                        entry_s={})
    return types.SimpleNamespace(devtrace=trace, device=device)


def _gaps():
    # a distinct number of seconds per name, so a sum tells which counted
    return [(name, 0.5 + k) for k, name in enumerate(GAPS)]


@pytest.mark.parametrize("metric", sorted(OWNS))
def test_each_metric_is_listed_with_its_layer_cell_and_source(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    assert entry["unit"] == "%" and entry["better"] == "lower"
    assert entry["source"] == "program_span"
    reads = metric.endswith("long_reads")
    assert entry["workloads"] == [
        "vroad-2k-long-reads" if reads else "vroad-4k-ingest"]
    assert entry["moves"] == ("read_frames_per_s" if reads
                              else "write_frames_per_s")
    assert entry["layer"] == LAYER[metric.split(".")[0]]


@pytest.mark.parametrize("metric", sorted(OWNS))
def test_a_metric_sums_the_gaps_of_the_names_it_owns(metric):
    gaps = _gaps()
    want = sum(s for name, s in gaps if GAPS[name] is OWNS[metric])
    assert want > 0
    got = harness.metric_reader(metric)(_run(gaps))
    assert got == pytest.approx(100.0 * want / WINDOW_S)


def test_no_gap_is_counted_by_two_groups_and_shares_fit_the_idle_share():
    gaps = _gaps()
    groups = {id(p): p for p in OWNS.values()}.values()
    for name, _s in gaps:
        assert sum(span_idle.owned(name, p) for p in groups) <= 1, name
    run = _run(gaps)
    for cell in ("long_reads", "ingest"):
        total = sum(harness.metric_reader(m)(run) for m in OWNS
                    if m.endswith(cell))
        assert total <= 100.0 * run.devtrace.idle_share + 1e-9


@pytest.mark.parametrize("metric", sorted(OWNS))
def test_benchmark_labels_and_kernel_entries_are_never_counted(metric):
    gaps = [(label, 3.0) for label in BENCHMARK_LABELS]
    gaps += [("vss.kernel.deflate.zlib", 2.0), ("vss.kernel.fetch", 2.0),
             ("vss.kernel.store.fetch", 2.0)]
    assert harness.metric_reader(metric)(_run(gaps)) == 0.0


@pytest.mark.parametrize("metric", sorted(OWNS))
def test_nothing_on_the_cpu_or_without_a_trace_and_zero_when_absent(metric):
    read = harness.metric_reader(metric)
    assert read(_run(_gaps(), device="cpu")) is None
    assert read(types.SimpleNamespace(devtrace=None, device="cuda")) is None
    assert read(_run([])) == 0.0


@pytest.mark.parametrize("metric", sorted(OWNS))
def test_a_program_without_spans_gives_no_reading(metric, monkeypatch):
    from repro_torch import obs

    monkeypatch.delattr(obs, "span")
    assert harness.metric_reader(metric)(_run(_gaps())) is None
