"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
process group, with no device at all.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \
        --shape train_4k [--multi-pod] [--all] [--out build/dryrun]

Per cell this builds the production mesh over a fake process group of
256 ranks (512 with ``--multi-pod``; ``torch.distributed``'s ``fake``
backend: collectives return at once and move nothing), places params,
optimizer state, batch and cache as DTensors over ``meta`` shards by the
reference's rules (:mod:`repro_torch.runtime.sharding`), runs the step
function of this rank under :func:`repro_torch.launch.hlo_cost.
analyze_traced`, and records the traced cost, a memory estimate and the
roofline report (:mod:`repro_torch.launch.roofline`, H100 constants).
The records are the reference's (``status``, ``lower_s``, ``memory``,
``cost``, ``roofline``), with these differences:

* nothing is compiled: ``compile_s`` is null, and ``lower_s`` is the
  seconds of the traced run;
* ``memory`` holds ``argument_size_in_bytes``, this rank's shard bytes
  of params, optimizer state, batch and cache, and
  ``temp_size_in_bytes``, an estimate of the temporaries: the peak of
  the bytes that the traced run's op results held alive at once (a
  view counts none; a run's outputs included; no buffer is reused or
  donated), as
  ``memory_estimate`` says;
* ``cost`` holds the traced totals, not a compiler's cost analysis;
* the fake group's mesh is typed ``cpu``, for which DTensor runs an
  all-to-all as an all-gather and a chunk, so any all-to-all of a cell
  counts as that all-gather (more bytes than NCCL's all-to-all moves).

The module sets no process-wide state when imported.
"""
import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_eligible
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as MODEL
from repro_torch.models import steps as STEPS
from repro_torch.optim import adamw
from repro_torch.params import tree_flatten, tree_map
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.sharding import ShardingRules

# decode cells whose bf16 KV cache exceeds per-chip HBM: serve with an
# int8-quantized cache (production KV-cache quantization).
INT8_KV_CELLS = {("qwen1.5-32b", "decode_32k")}

MEMORY_ESTIMATE = ("argument_size_in_bytes: this rank's shards of params, "
                   "optimizer state, batch and cache; temp_size_in_bytes: "
                   "the peak of live op-result bytes in the traced run "
                   "(views not counted, outputs included, nothing "
                   "donated or reused)")


def init_fake_group(world_size: int) -> None:
    """A fake default process group of ``world_size`` ranks (this
    process is rank 0) if none exists; collectives return at once."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(
                f"a process group of {dist.get_world_size()} ranks exists; "
                f"the dry run needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _placed(rules: ShardingRules, axes_tree, tree):
    return SH.place_tree(tree, SH.tree_shardings(rules, axes_tree, tree))


def _local_bytes(tree) -> int:
    n = 0
    for t in tree_flatten(tree):
        loc = t.to_local() if isinstance(t, SH.DTensor) else t
        n += loc.numel() * loc.element_size()
    return n


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, rules_overrides: Optional[Dict] = None,
             remat: bool = True, kv_dtype=None, grad_bf16: bool = False,
             pad_heads: bool = True,
             verbose: bool = True) -> Dict[str, Any]:
    """Trace one (arch, shape, mesh) cell; return the record dict.

    Without ``mesh`` the production mesh is built over the default
    process group, a fake one of 256 (512) ranks made here if none
    exists."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if mesh is not None:
        mesh_name = "x".join(map(str, mesh.shape))
    record: Dict[str, Any] = {"arch": arch_name, "shape": shape_name,
                              "mesh": mesh_name}
    ok, reason = shape_eligible(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=reason)
        return record

    t0 = time.perf_counter()
    if mesh is None:
        init_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    overrides = dict(rules_overrides or {})
    if shape.kind != "train" and "embed" not in overrides:
        # inference: no optimizer states to fit, so drop the FSDP (data-
        # axis) dimension of the 2D param sharding — weights stay TP-
        # sharded over model and replicated over data, killing the
        # per-layer weight gathers that dominate decode collectives
        overrides["embed"] = None
    rules = ShardingRules(mesh, overrides=overrides)
    rules.pad_attention_heads = pad_heads
    paxes = MODEL.param_axes(cfg)
    params = _placed(rules, paxes, STEPS.abstract_params(cfg))
    batch = SH.place_batch(rules, STEPS.input_specs(cfg, shape))

    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        opt = _placed(rules, STEPS.opt_state_axes(paxes),
                      STEPS.abstract_opt_state(STEPS.abstract_params(cfg)))
        gt = None
        if grad_bf16:
            # bf16 gradients on the wire (the DP all-reduce payload
            # halves); optimizer math stays fp32
            def gt(g):
                return tree_map(lambda x: x.to(torch.bfloat16), g)
        step = STEPS.make_train_step(cfg, opt_cfg, rules=rules,
                                     remat=remat, grad_transform=gt)
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = STEPS.make_prefill_step(cfg, rules=rules)
        args = (params, batch)
    else:  # decode
        kvd = kv_dtype
        if kvd is None:
            kvd = torch.int8 if (arch_name, shape_name) in INT8_KV_CELLS \
                else torch.bfloat16
        cache = _placed(rules, MODEL.cache_axes(cfg), STEPS.abstract_cache(
            cfg, shape.global_batch, shape.seq_len, kv_dtype=kvd))
        step = STEPS.make_decode_step(cfg, rules=rules)
        args = (params, cache, batch["tokens"], 0)
    arg_bytes = _local_bytes(args[:-1] if shape.kind == "decode" else args)
    totals = HC.analyze_traced(step, *args)
    t_lower = time.perf_counter() - t0

    mem = {"argument_size_in_bytes": float(arg_bytes),
           "temp_size_in_bytes": float(totals.peak_live_bytes)}
    cost = {"flops": totals.flops,
            "contraction_flops": totals.contraction_flops,
            "bytes accessed": totals.hbm_bytes}
    report = RL.RooflineReport(
        arch=arch_name, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_chip=totals.flops,
        bytes_per_chip=totals.hbm_bytes,
        coll_bytes_per_chip=totals.coll_bytes,
        coll_breakdown=dict(totals.coll),
        peak_memory_per_chip=(mem["argument_size_in_bytes"]
                              + mem["temp_size_in_bytes"]),
        model_flops=RL.model_flops_for(cfg, shape),
    )
    record.update(status="ok", chips=chips,
                  lower_s=round(t_lower, 1), compile_s=None,
                  compile_note="nothing compiles: lower_s is the traced "
                               "run's seconds",
                  memory=mem, memory_estimate=MEMORY_ESTIMATE, cost=cost,
                  roofline=report.to_dict())
    if verbose:
        print(f"[{mesh_name}] {arch_name} x {shape_name}: OK "
              f"({t_lower:.0f}s traced) "
              f"bottleneck={report.bottleneck} "
              f"t=({report.t_compute*1e3:.2f},{report.t_memory*1e3:.2f},"
              f"{report.t_collective*1e3:.2f})ms "
              f"roofline={report.roofline_fraction:.2%}")
        sizes = {k: f'{v/2**30:.2f}GiB' for k, v in mem.items()}
        print(f"  memory estimate: {sizes}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    cells = []
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch, shp, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        path = os.path.join(args.out,
                            f"{mesh_name}__{arch}__{shp}.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            if rec.get("status") in ("ok", "skipped"):
                print(f"[cached] {mesh_name} {arch} x {shp}: "
                      f"{rec['status']}")
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                continue
        try:
            if dist.is_initialized() and \
                    dist.get_world_size() != (512 if mp else 256):
                # --both-meshes: the group is remade for the other mesh
                dist.destroy_process_group()
            rec = run_cell(arch, shp, multi_pod=mp,
                           remat=not args.no_remat)
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skipped"
            if rec["status"] == "skipped":
                print(f"[{mesh_name}] {arch} x {shp}: SKIPPED "
                      f"({rec['reason']})")
        except Exception as e:
            n_fail += 1
            rec = {"arch": arch, "shape": shp, "mesh": mesh_name,
                   "status": "failed", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[{mesh_name}] {arch} x {shp}: FAILED {type(e).__name__}: "
                  f"{str(e)[:200]}")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
