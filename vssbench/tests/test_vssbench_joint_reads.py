"""The joint-read cell's program against its reference, on the CPU.

At the joint cell's ``MIN_FRAME`` (320x180), on the benchmark's seeded
road scene: both sides of a pair the program stored jointly read back
as ``reference/joint.py`` rebuilds them from the reference's decodes
(``reference/tvc.py``) of the stored slices.  Then the cell itself,
shrunk (the generator draws at ``MIN_FRAME``): a sound run is correct,
and each fault planted under the timed path fails its own check.  The
runs skip the look for a card and the check of loaded modules, as the
rehearsals do."""
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from vssbench import harness
from vssbench.reference import joint as ref_joint
from vssbench.reference import tvc as ref_tvc

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_vssbench_contract import FULL, PKG  # noqa: E402
from test_vssbench_rehearsal import SEED, SHRINK  # noqa: E402

# one intra-op thread a worker process, as the joint cell's tests pin it
torch.set_num_threads(1)

CELL = "vroad-1k-75-joint-reads"
LIMITS = json.loads((PKG / "workloads" / f"{CELL}.json").read_text())[
    "limits"]
CONFIG = next(w["config"] for w in FULL["workloads"] if w["name"] == CELL)
TAU_DB = json.loads((PKG / "configs" / f"{CONFIG}.json").read_text())[
    "joint"]["tau_db"]
TIER = ref_tvc.tier("h264")
GOP = 30


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """One GOP a camera of the scene at MIN_FRAME, through the joint
    pass; the store's root with it."""
    from repro_torch.core.config import VSSConfig
    from repro_torch.core.store import VSS
    from vssbench.traffic import camera_joint
    from vssbench.traffic import frames as scene_frames

    width, height = camera_joint.MIN_FRAME
    scene = scene_frames.make_scene(height, width, cameras=2, overlap=0.75,
                                    seed=2103, device="cpu")
    root = tmp_path_factory.mktemp("vss")
    vss = VSS(str(root), config=VSSConfig(device="cpu"))
    for cam in range(2):
        clip = scene_frames.render(scene, 0, GOP, camera=cam,
                                   overlap=0.75).numpy()
        vss.write(f"cam{cam}", clip, fps=30.0, codec="h264", gop_frames=GOP)
    ids = vss.apply_joint_compression(["cam0", "cam1"], tau_db=TAU_DB)
    yield vss, root, ids
    vss.close()


def _decode_stored(root, key):
    codec, shape, offsets, payload = ref_tvc.parse(
        (root / "objects" / key).read_bytes())
    return ref_tvc.decode_payload(codec, shape, offsets, payload, "cpu")


def test_both_sides_read_back_as_the_reference_rebuilds_them(stored):
    vss, root, ids = stored
    (jid,) = ids
    rec = vss.catalog.get_joint(jid)
    assert not rec["duplicate"]
    want_a, want_b = [], []
    for seg in rec["segments"]:
        got = {p: _decode_stored(root, seg["paths"][p])
               for p in ref_joint.PARTS}
        composite = torch.cat([got["left"], got["overlap"]], dim=2)
        h = np.asarray(seg["h"]).reshape(3, 3).astype(np.float32)
        want_a.append(composite)
        want_b.append(ref_joint.side_b(composite, got["right"], h,
                                       seg["x_g"]))
    names = {}
    for key in ("gop_a", "gop_b"):
        g = vss.catalog.get_gop(rec[key])
        names[key] = vss.catalog.get_physical(g.physical_id).logical
    got_a = torch.from_numpy(vss.read(names["gop_a"], cache=False)
                             .frames.copy())
    got_b = torch.from_numpy(vss.read(names["gop_b"], cache=False)
                             .frames.copy())
    assert torch.equal(got_a, torch.cat(want_a))
    diff = got_b.to(torch.int16) - torch.cat(want_b).to(torch.int16)
    assert int(diff.abs().max()) <= LIMITS["side_b_pixel_diff_max"]


def _result(**kw):
    return harness.execute(CELL, seed=SEED, seconds=0.4, device="cpu",
                           shrink=SHRINK, bench=FULL, own_process=False,
                           **{"trace": False, **kw})


def _checks(**kw):
    r = _result(**kw)
    return r["correct"], {k: v["value"] for k, v in r["checks"].items()}


def test_a_sound_run_is_correct():
    correct, checks = _checks()
    assert correct, checks
    assert checks["joint_gops_read"] >= LIMITS["joint_gops_read"]
    assert checks["pixel_diff_max"] == 0
    assert checks["h_error_px"] <= LIMITS["h_error_px"]


def test_a_traced_run_reads_the_planner():
    """The window's reads are planned, and the run collects the
    planner's histogram (the idle shares need the card's trace)."""
    metrics = _result(trace=True)["metrics"]
    assert metrics["plan_ms.long_reads"]["value"] > 0


def test_the_control_fails_on_the_answers_themselves():
    """Originals stored one tier down: the reads answer what the program
    stored, and every answer is held to the reference's rebuild at the
    configuration's tier, so the pixel checks fail, not only the byte
    check of the stored slices."""
    correct, checks = _checks(control=True)
    assert not correct
    assert checks["pixel_diff_max"] > LIMITS["pixel_diff_max"]
    assert checks["side_b_pixel_diff_max"] > LIMITS["side_b_pixel_diff_max"]


def test_a_record_with_its_homography_off_is_caught(monkeypatch):
    """Every record's translation moved 2 px after the joint pass: the
    reads warp through it and the check holds it to the scene."""
    from repro_torch.core import catalog

    real = catalog.Catalog.get_joint

    def moved(self, jid):
        rec = real(self, jid)
        for seg in rec["segments"]:
            h = list(seg["h"])
            h[2] += 2.0
            seg["h"] = h
        return rec

    monkeypatch.setattr(catalog.Catalog, "get_joint", moved)
    correct, checks = _checks()
    assert not correct and checks["h_error_px"] > LIMITS["h_error_px"]


def _rebuilding(monkeypatch, alter):
    """Each rebuilt GOP passed through ``alter(frames, side_a)``."""
    from repro_torch.core import joint

    real = joint.reconstruct_gop

    def altered(store, gop, *a):
        frames = real(store, gop, *a)
        rec = store.catalog.get_joint(gop.joint_ref)
        return alter(frames.copy(), rec["gop_a"] == gop.gop_id)

    monkeypatch.setattr(joint, "reconstruct_gop", altered)


def test_a_side_b_pixel_off_by_2_is_caught(monkeypatch):
    def off(frames, side_a):
        if not side_a:
            v = int(frames[0, 0, 0, 0])
            frames[0, 0, 0, 0] = v + 2 if v < 254 else v - 2
        return frames

    _rebuilding(monkeypatch, off)
    correct, checks = _checks()
    assert not correct and checks["side_b_pixel_diff_max"] == 2


def test_a_side_a_answer_shifted_by_a_frame_is_caught(monkeypatch):
    def shifted(frames, side_a):
        return np.concatenate([frames[1:], frames[-1:]]) if side_a \
            else frames

    _rebuilding(monkeypatch, shifted)
    correct, checks = _checks()
    assert not correct and checks["pixel_diff_max"] > LIMITS["pixel_diff_max"]


def test_an_answer_from_the_decoded_original_is_caught(monkeypatch):
    from repro_torch.core import joint
    from repro_torch.core import store as store_mod

    originals = {}
    real_pass = store_mod.VSS.apply_joint_compression

    def remembering(self, names=None, **kw):
        for name in names:
            (p,) = [p for p in self.catalog.physicals_for(name)
                    if p.is_original]
            for g in self.catalog.gops_for(p.physical_id):
                originals[g.gop_id] = self.gop_frames(g)
        return real_pass(self, names, **kw)

    monkeypatch.setattr(store_mod.VSS, "apply_joint_compression", remembering)
    monkeypatch.setattr(joint, "reconstruct_gop",
                        lambda store, gop, *a: originals[gop.gop_id].copy())
    correct, checks = _checks()
    assert not correct
    assert checks["pixel_diff_max"] > LIMITS["pixel_diff_max"] or \
        checks["side_b_pixel_diff_max"] > LIMITS["side_b_pixel_diff_max"]


def test_a_store_the_joint_pass_left_apart_is_caught(monkeypatch):
    from repro_torch.core import store as store_mod

    monkeypatch.setattr(store_mod.VSS, "apply_joint_compression",
                        lambda self, *a, **kw: [])
    correct, checks = _checks()
    assert not correct and checks["joint_gops_read"] == 0


@pytest.mark.parametrize("metric", [
    "rebuild_warp_idle_share.joint_reads",
    "rebuild_concat_idle_share.joint_reads"])
def test_a_program_without_the_rebuild_counter_gives_no_reading(metric):
    """An older program (no vss_joint_rebuild_frames_total) leaves the
    metric out of the line, not a 0.0."""
    run = types.SimpleNamespace(
        counters={"vss_read_objects_fetched_total": 3.0},
        requests=[types.SimpleNamespace(ok=True, frames=30, kind="read")],
        devtrace=types.SimpleNamespace(window_s=1.0, idle_gaps=[]),
        device="cuda", window_s=1.0)
    assert harness.metric_reader(metric)(run) is None
    run.counters["vss_joint_rebuild_frames_total"] = 30.0
    assert harness.metric_reader(metric)(run) is not None
