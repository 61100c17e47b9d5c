"""Dry run: trace every (arch × shape × mesh) cell on one host.

Port of ``repro.launch.dryrun``.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --keep-going

Each cell: make torch's fake process group at the mesh's size (256 or
512 ranks; this process is rank 0 and its collectives move nothing),
build the production mesh on it, lay the meta-device state, batch and
cache out on the mesh (zero allocation, the reference's design), run one
train, prefill or decode step under ``op_analysis.OpCounter``, and
record the per-device flops, HBM bytes and collective wire bytes with
the H100 roofline (``launch.roofline``).  The train step's microbatches
are alike, so its first microbatch is traced and counted ``n`` times
(the reference weights its microbatch scan by the trip count), then the
optimizer half once.  ``trace_s`` takes the place of
the reference's ``compile_s``.  The reference's ``memory_analysis``
(XLA's buffer assignment) has no counterpart on the meta device and is
left out; ``resident_bytes_per_chip`` is ``sharded_bytes`` of the state
(train) or of the parameters and cache (serve).  Nothing here needs a
card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, canonical_arch, get_config
from repro_torch.configs.base import SHAPES, shapes_for
from repro_torch.launch import roofline as RF
from repro_torch.launch.mesh import (
    PRODUCTION_SHAPES,
    fake_group,
    make_production_mesh,
)
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.launch.specs import (
    batch_shardings,
    batch_specs,
    cache_shardings,
    cache_specs,
    distribute,
    sharded_bytes,
    state_shardings,
)
from repro_torch.launch.steps import (
    TrainHyper,
    abstract_train_state,
    apply_grads,
    make_decode_step,
    make_grad_step,
    make_prefill_step,
)
from repro_torch.models import model as M
from repro_torch.models.sharding import ShardCtx, param_shardings
from repro_torch.tree import tree_map


def default_microbatches(shape, dp_size: int) -> int:
    """One sequence per data shard per microbatch (memory-safest)."""
    return max(1, shape.global_batch // dp_size)


def mesh_size(multi_pod: bool) -> int:
    n = 1
    for s in PRODUCTION_SHAPES[multi_pod][0]:
        n *= s
    return n


def trace_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    num_microbatches: Optional[int] = None,
    compress_grads: bool = False,
    bf16_weights: bool = False,
    shard_grad_accum: bool = False,
    constrain_scanned_params: bool = False,
    bf16_params: bool = False,
    kv_int8: bool = False,
    sp_carry: bool = False,
    remat_policy: str = "none",
    extra_tag: str = "",
):
    """One cell's record (the reference's ``lower_cell`` keys where they
    have a meaning here).  Makes and destroys the fake default group."""
    with fake_group(mesh_size(multi_pod)):
        rec = trace(get_config(arch), SHAPES[shape_name],
                    make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu"),
                    num_microbatches=num_microbatches,
                    compress_grads=compress_grads,
                    bf16_weights=bf16_weights,
                    shard_grad_accum=shard_grad_accum,
                    constrain_scanned_params=constrain_scanned_params,
                    bf16_params=bf16_params, kv_int8=kv_int8,
                    sp_carry=sp_carry, remat_policy=remat_policy)
    return {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single", "tag": extra_tag,
            **rec}


def trace(cfg, shape, mesh, *, num_microbatches: Optional[int] = None,
          compress_grads: bool = False, bf16_weights: bool = False,
          shard_grad_accum: bool = False,
          constrain_scanned_params: bool = False, bf16_params: bool = False,
          kv_int8: bool = False, sp_carry: bool = False,
          remat_policy: str = "none"):
    """Trace the step of ``shape`` (a ``ShapeSpec``) for ``cfg`` on
    ``mesh`` (any mesh over the default group, its tensors on "meta")
    and return the record's numbers."""
    ctx = ShardCtx(mesh, bf16_weights=bf16_weights,
                   constrain_scanned_params=constrain_scanned_params,
                   sp_carry=sp_carry, remat_policy=remat_policy)
    chips = mesh.size()
    batch = batch_specs(cfg, shape)

    if shape.kind == "train":
        n_micro = num_microbatches or default_microbatches(shape,
                                                           ctx.dp_size)
        hyper = TrainHyper(num_microbatches=n_micro,
                           compress_grads=compress_grads,
                           shard_grad_accum=shard_grad_accum,
                           bf16_params=bf16_params)
        state = abstract_train_state(cfg, hyper)
        st_sh = state_shardings(state, mesh)
        resident = sharded_bytes(state, st_sh, mesh)
        dstate = distribute(state, st_sh, mesh)
        one = dataclasses.replace(hyper, num_microbatches=1)
        grad_step = make_grad_step(cfg, one, ctx)
        first = {k: v[: v.shape[0] // n_micro] for k, v in batch.items()}
        t0 = time.perf_counter()
        with OpCounter() as counter:
            counter.weight = n_micro
            loss, grads = grad_step(dstate["params"], first)
            counter.weight = 1
            apply_grads(dstate, loss, grads, hyper, ctx)
        params_tree = state["params"]
    else:
        params = M.init_model_abstract(cfg)
        if bf16_params:  # serving weights are bf16 in production
            params = tree_map(lambda p: p.to(torch.bfloat16)
                              if p.dtype == torch.float32 else p, params)
        p_sh = param_shardings(params, mesh)
        model = M.model_from_params(cfg, distribute(params, p_sh, mesh))
        dbatch = distribute(batch, batch_shardings(batch, mesh), mesh)
        cache = cache_specs(cfg, shape.global_batch, shape.seq_len,
                            kv_int8=kv_int8)
        c_sh = cache_shardings(cache, mesh)
        dcache = distribute(cache, c_sh, mesh)
        resident = (sharded_bytes(params, p_sh, mesh)
                    + sharded_bytes(cache, c_sh, mesh))
        t0 = time.perf_counter()
        with OpCounter() as counter:
            if shape.kind == "prefill":
                make_prefill_step(cfg, ctx)(model, dbatch, dcache)
            else:
                make_decode_step(cfg, ctx)(model, dcache, dbatch["tokens"])
        params_tree = params
        n_micro = 0
    trace_s = time.perf_counter() - t0

    stats = counter.stats()
    mflops = RF.model_flops(cfg, params_tree, shape, shape.kind)
    roof = RF.Roofline(
        flops_per_chip=stats.flops,
        hbm_bytes_per_chip=stats.hbm_bytes,
        ici_bytes_per_chip=stats.wire_bytes,
        model_flops_total=mflops,
        chips=chips,
        group=stats.largest_group,
    )
    return {
        "chips": chips,
        "num_microbatches": n_micro,
        "trace_s": round(trace_s, 2),
        "resident_bytes_per_chip": resident,  # sharded_bytes is per chip
        "ops_per_chip": stats.ops,
        "collectives": stats.collective_ops,
        "roofline": roof.as_dict(),
        "params_total": RF.count_params(params_tree),
        "params_active": RF.active_params(cfg, params_tree),
    }


def cells(archs=None, shapes=None, meshes=("single", "multi")):
    for arch in archs or ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            if shapes and shape.name not in shapes:
                continue
            for mesh in meshes:
                yield arch, shape.name, mesh == "multi"


def describe(rec) -> str:
    r = rec["roofline"]
    return (f"trace={rec['trace_s']}s "
            f"resident/chip={rec['resident_bytes_per_chip'] / 2**30:.2f}GiB "
            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"collective={r['collective_s']:.4f}s → {r['dominant']}"
            f" (roofline {r['roofline_fraction'] * 100:.1f}%)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--bf16-weights", action="store_true")
    ap.add_argument("--shard-grad-accum", action="store_true")
    ap.add_argument("--constrain-scanned-params", action="store_true")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--sp-carry", action="store_true")
    ap.add_argument("--remat-policy", default="none",
                    choices=["none", "save_tp"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args(argv)

    archs = [canonical_arch(args.arch)] if args.arch else None
    shapes = [args.shape] if args.shape else None
    meshes = (args.mesh,) if args.mesh else ("single", "multi")

    n_ok = n_fail = 0
    for arch, shape, multi in cells(archs, shapes, meshes):
        label = f"{arch} × {shape} × {'multi' if multi else 'single'}"
        try:
            rec = trace_cell(
                arch, shape, multi,
                num_microbatches=args.microbatches,
                compress_grads=args.compress_grads,
                bf16_weights=args.bf16_weights,
                shard_grad_accum=args.shard_grad_accum,
                constrain_scanned_params=args.constrain_scanned_params,
                bf16_params=args.bf16_params,
                kv_int8=args.kv_int8,
                sp_carry=args.sp_carry,
                remat_policy=args.remat_policy,
                extra_tag=args.tag,
            )
            print(f"OK   {label}: {describe(rec)}", flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            n_ok += 1
        except Exception as e:
            n_fail += 1
            print(f"FAIL {label}: {type(e).__name__}: {e}", flush=True)
            if not args.keep_going:
                traceback.print_exc()
                raise SystemExit(1)
    print(f"\n{n_ok} cells OK, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
