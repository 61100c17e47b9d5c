"""Each cell rehearsed on the CPU at a tiny frame size: a sound run is
``correct``; the control (the stored original one tier lower) and each
fault that the cell can have, planted under the timed path, are not.

The runs skip the look for a card and the check of loaded modules (this
process is shared with other tests); everything else is a run's."""
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from vssbench import harness

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_vssbench_contract import FULL  # noqa: E402

SHRINK = {"width": 96, "height": 54, "seconds": 4}
SEED = 2 ** 33 + 77
CELLS = [w["name"] for w in FULL["workloads"]]
READ_CELLS = [c for c in CELLS if "reads" in c]
INGEST_CELLS = [c for c in CELLS if "ingest" in c]


def _run(cell, *, trace=False, control=False, seconds=0.4):
    return harness.execute(cell, seed=SEED, seconds=seconds, trace=trace,
                           device="cpu", shrink=SHRINK, control=control,
                           bench=FULL, own_process=False)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_reaches_its_last_line_correct(cell, trace):
    r = _run(cell, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(FULL, cell, trace)}
    got = set(r["metrics"])
    assert got <= want
    if not trace:
        assert got == want  # every end-to-end metric is there
    else:
        assert "busy_s" in r["device"] and "breakdown" in r
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    assert not _run(cell, control=True)["correct"]


@pytest.mark.parametrize("cell", READ_CELLS)
def test_an_answer_altered_where_it_is_decoded_is_caught(cell, monkeypatch):
    from repro_torch import codec

    real = codec.decode_gop

    def altered(enc, **kw):
        out = real(enc, **kw).copy()
        out[-1] = out[0]  # the last frame shows the first's moment
        return out

    monkeypatch.setattr(codec, "decode_gop", altered)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", READ_CELLS)
def test_half_the_frames_left_out_is_caught(cell, monkeypatch):
    from repro_torch.core import store

    real = store.VSS._execute

    def half(self, *a, **kw):
        frames = real(self, *a, **kw)
        return frames[: max(1, frames.shape[0] // 2)]

    monkeypatch.setattr(store.VSS, "_execute", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", INGEST_CELLS)
def test_a_writer_that_keeps_its_state_unchanged_is_caught(cell,
                                                           monkeypatch):
    from repro_torch.core import store

    real = store.VSSWriter.append

    def unchanged(self, frames):
        if not self.name.startswith("cam"):  # set-up's warm-up writer
            real(self, frames)

    monkeypatch.setattr(store.VSSWriter, "append", unchanged)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", INGEST_CELLS)
def test_a_gop_altered_where_it_is_encoded_is_caught(cell, monkeypatch):
    from repro_torch import codec

    real = codec.encode_gop

    def altered(frames, codec_name, **kw):
        frames = np.array(frames, copy=True)
        frames[-1, 0, 0] ^= 0x40
        return real(frames, codec_name, **kw)

    monkeypatch.setattr(codec, "encode_gop", altered)
    assert not _run(cell)["correct"]


def test_a_module_of_jax_loaded_by_the_check_refuses_the_result(monkeypatch):
    """The look for JAX and the JAX package comes after the reference and
    the metric readers: a stub ``repro`` loaded by the check stops the
    run before it has a result."""
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    real = harness.traffic_module

    def traffic_loading_repro(run):
        mod = real(run)
        check = mod.check

        def check_then_load(r):
            check(r)
            monkeypatch.setitem(sys.modules, "repro",
                                types.ModuleType("repro"))

        mod.check = check_then_load
        return mod

    monkeypatch.setattr(harness, "traffic_module", traffic_loading_repro)
    with pytest.raises(RuntimeError, match="repro"):
        harness.execute(CELLS[0], seed=SEED, seconds=0.4, trace=False,
                        device="cpu", shrink=SHRINK, bench=FULL)
