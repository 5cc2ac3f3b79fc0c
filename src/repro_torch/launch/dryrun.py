"""Dry-run: plan, trace and count every (arch x shape x mesh) combination
(port of ``repro/launch/dryrun.py``).

Proves a plan is coherent without a card or a mesh: builds the plan
(``launch.specs``), takes the production mesh's axis sizes
(``launch.mesh``), gives its per-device state bytes exactly from the
state's specs, traces one step of one client or serving replica on the
``meta`` device (``launch.op_analysis``: FLOPs, HBM traffic and peak bytes
by running the port's own step, no memory), counts the plan's collectives
from its rules, and puts the counts on the H100's roofline
(``launch.roofline``). A device's FLOPs and traffic are the replica's over
the ``"model"`` axis (an even tensor-parallel split; under FSDP rules the
optimizer's passes over the data-sharded weights split further, which this
does not model, so there ``memory_s`` is an upper bound), and its
temporaries the replica's in the ratio of its inputs to the replica's.
Records go to ``experiments/dryrun_torch/<name>.json`` (listed in
``.gitignore``), keyed as the reference's where the meaning is the same; the
counts block is ``op_costs`` (the reference's ``hlo_costs``). Runs on the
host: ``meta`` is the point.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--agg eq6] [--tag base]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_arch, get_shape, shape_applicable
from repro_torch.core import rounds as R
from repro_torch.launch import op_analysis, roofline, specs
from repro_torch.launch.mesh import make_production_mesh, n_devices
from repro_torch.models import params as mp
from repro_torch.optim import adamw

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
CARD_BYTES = 80e9  # an H100's HBM


def state_bytes(plan: specs.LoweringPlan, axis_sizes: dict, dtype=torch.bfloat16) -> int:
    """Per-device bytes of a train plan's round state (params in ``dtype``,
    adamw's f32 moments) under its specs at ``axis_sizes``."""
    fed, opt = plan.fed, adamw()
    state = R.state_template(plan.arch, fed, opt, dtype)
    sspec = R.state_pspecs(plan.arch, fed, opt, plan.rules, plan.opt_rules, axis_sizes)
    return specs.per_device_bytes(state, sspec, axis_sizes)


def run_one(arch_name: str, shape_name: str, multi_pod: bool, aggregation: str = "eq6",
            local_steps: int = 1, tag: str = "", variant: str = "") -> dict:
    plan = specs.make_plan(arch_name, shape_name, multi_pod, aggregation, local_steps, variant)
    sizes = make_production_mesh(multi_pod=multi_pod)
    n_dev = n_devices(sizes)
    m = sizes["model"]
    args, pspecs_ = specs.input_specs(plan)
    args_dev = specs.per_device_bytes(args, pspecs_, sizes)
    head = 2 if plan.kind == "decode" else 1  # the round state, or the params (+ the cache)
    state_dev = specs.per_device_bytes(args[:head], pspecs_[:head], sizes)
    t0 = time.time()
    costs = op_analysis.trace_plan(plan, sizes)
    t_trace = time.time() - t0
    _, batch = op_analysis.replica(plan, sizes)
    S = plan.shape.seq_len
    tokens = batch * (1 if plan.kind == "decode" else S) * (local_steps if plan.fed else 1)
    n_params = mp.count_params(R.make_template(plan.arch))
    n_row = R.make_aggregator(plan.arch, plan.fed).ctx.spec.n_total if plan.fed else 0
    rows = op_analysis.collectives(plan, 2 * n_params, 2 * n_row, tokens, sizes)
    coll, coll_ops, cross = op_analysis.collective_totals(rows)
    flops_dev = {k: v / m for k, v in costs.flops.items()}
    traffic_dev = costs.traffic / m
    rl = roofline.terms(flops_dev, traffic_dev, coll, n_dev, plan.arch, plan.shape, local_steps,
                        cross, costs.other_ops / m)
    # the step's temporaries, taken to shard as its inputs do (m ways under
    # tensor parallelism, further over data under FSDP rules)
    temp_dev = (costs.peak_bytes - costs.input_bytes) * args_dev / costs.input_bytes
    return {
        "name": plan.name + (f"--{tag}" if tag else ""),
        "arch": arch_name,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "kind": plan.kind,
        "aggregation": plan.aggregation,
        "variant": variant,
        "local_steps": local_steps,
        "trace_s": round(t_trace, 2),
        "memory": {
            "state_per_device": state_dev,
            "argument_bytes": args_dev,
            "temp_bytes": temp_dev,
            "total_per_device": args_dev + temp_dev,
        },
        "op_costs": {
            "flops_per_device": sum(flops_dev.values()),
            "flops_by_kind_per_device": flops_dev,
            "traffic_bytes_per_device": traffic_dev,
            "collective_bytes": coll,
            "collective_ops": coll_ops,
            "cross_node_bytes": cross,
            "collectives": rows,
            "replica_batch": batch,
            "replica": costs.as_dict(),
        },
        "roofline": rl.as_dict(),
    }


def cards_for_state(arch_name: str, dtype=torch.float32, limit: float = CARD_BYTES) -> dict:
    """The fewest cards whose per-device ``train_4k`` round state (params in
    ``dtype``, adamw moments, the single-pod plan's rules) fits ``limit``:
    meshes of (n / 8 data x 8 model) from 8 cards up, (1 x n) below."""
    plan = specs.make_plan(arch_name, "train_4k", False)
    n = 1
    while n <= 4096:
        sizes = {"data": max(n // 8, 1), "model": min(n, 8)}
        got = state_bytes(plan, sizes, dtype)
        if got <= limit:
            return {"cards": n, "mesh": sizes, "state_per_device": got}
        n *= 2
    raise ValueError(f"{arch_name}: no mesh up to 4096 cards holds the state")


def matrix(mesh_sel: str):
    for arch in ASSIGNED:
        for shape in SHAPES.values():
            ok, why = shape_applicable(arch, shape)
            for multi in ([False, True] if mesh_sel == "both" else [mesh_sel == "multi"]):
                yield arch.name, shape.name, multi, ok, why


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--agg", default="eq6")
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--variant", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    combos = []
    if args.all:
        combos = list(matrix(args.mesh))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        for multi in [False, True] if args.mesh == "both" else [args.mesh == "multi"]:
            arch_v = specs.variant_arch(get_arch(args.arch), args.variant)
            ok, why = shape_applicable(arch_v, get_shape(args.shape))
            combos.append((args.arch, args.shape, multi, ok, why))

    failures = 0
    for arch, shape, multi, ok, why in combos:
        mesh_name = "multipod" if multi else "singlepod"
        stem = f"{arch}--{shape}--{mesh_name}" + (f"--{args.tag}" if args.tag else "")
        path = out_dir / f"{stem}.json"
        if path.exists() and not args.force:
            print(f"SKIP (cached) {stem}")
            continue
        if not ok:
            path.write_text(json.dumps({"name": stem, "arch": arch, "shape": shape,
                                        "mesh": mesh_name, "skipped": why}, indent=1))
            print(f"SKIP (n/a)    {stem}: {why}")
            continue
        print(f"RUN           {stem} ...", flush=True)
        try:
            rec = run_one(arch, shape, multi, args.agg, args.local_steps, args.tag, args.variant)
        except Exception as e:  # noqa: BLE001 — recorded, counted, reported at the end
            failures += 1
            path.write_text(json.dumps({"name": stem, "error": str(e),
                                        "traceback": traceback.format_exc()}, indent=1))
            print(f"FAIL          {stem}: {e}")
            continue
        path.write_text(json.dumps(rec, indent=1))
        r = rec["roofline"]
        print(
            f"OK            {stem}  trace={rec['trace_s']}s  "
            f"state/dev={rec['memory']['state_per_device'] / 2**30:.2f}GiB  "
            f"mem/dev={rec['memory']['total_per_device'] / 2**30:.2f}GiB  "
            f"terms(c/m/x/n)=({r['compute_s']:.2e},{r['memory_s']:.2e},{r['collective_s']:.2e},"
            f"{r['cross_node_s']:.2e})s  dom={r['dominant']}",
            flush=True,
        )
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
