"""BENCHMARK.json names files that exist, in the forms the contract
allows, and every cell reports what it has to."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "vssbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# cells built and rehearsed here but not in the benchmark yet (PERF.md
# says why); their entries are held to the same rules.  An entry that
# BENCHMARK.json lists by now is taken from there.
UNLISTED = json.loads((Path(__file__).parent / "unlisted_cells.json")
                      .read_text())
FULL = {k: (BENCH[k] + [u for u in UNLISTED[k]
                        if u["name"] not in {b["name"] for b in BENCH[k]}]
            if k in UNLISTED else BENCH[k])
        for k in BENCH}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in FULL["workloads"]]
METRICS = FULL["end_to_end"] + FULL["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vssbench"]
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


def test_every_name_and_unit_uses_the_allowed_characters():
    names = ([c["name"] for c in FULL["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in FULL["workloads"]]
             + [k for c in FULL["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for group in (FULL["configs"], FULL["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)


@pytest.mark.parametrize("cfg", FULL["configs"], ids=lambda c: c["name"])
def test_config_resolves_to_its_file(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and path.is_relative_to(PKG)
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert cfg["name"] in {w["config"] for w in FULL["workloads"]}
    # widths, frame size, fps, GOP and tier are never cut
    for key in cfg["reduced"]:
        assert key not in ("width", "height", "fps", "gop_frames", "tier")


@pytest.mark.parametrize("cell", FULL["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_to_its_files(cell):
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert (PKG / "configs" / f"{cell['config']}.json").is_file()
    traffic = json.loads(
        (PKG / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PKG / "traffic" / f"{traffic['kind']}.py").is_file()
    assert (PKG / "workloads" / f"{cell['name']}.json").is_file()


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_resolves_to_its_reader(metric):
    assert (PKG / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    from vssbench.harness import cell_metrics

    e2e = {m["name"] for m in cell_metrics(FULL, cell, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cell_metrics(FULL, cell, trace=True)
    assert layers
    for m in layers:
        assert m["moves"] in e2e


def test_per_layer_metrics_of_one_layer_name_it_alike():
    for m in FULL["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in {e["name"] for e in FULL["end_to_end"]}
        assert "bound" not in m


def test_every_listed_name_refers_to_a_listed_entry():
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_bounds_are_within_the_contract():
    for m in FULL["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
