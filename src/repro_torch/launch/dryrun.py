"""Multi-node dry-run: one rank's program of every (arch x shape x mesh) cell,
counted on the "meta" device (the counterpart of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 forced host devices and
parses the optimized HLO.  The port runs the rank's program once on the
"meta" device (no memory, no card) under the dry-run's counter
(``repro_torch.dist.op_costs``), on a stand-in mesh
(``repro_torch.launch.mesh``): its collectives move nothing and report
their bytes.  Per cell this script

  1. builds the production mesh (data 32 x model 8, 256 cards, or pod 2 x
     data 32 x model 8, 512 cards: the model axis is one NVLink node of 8
     where the reference's TPU pod ring is 16, ``launch/mesh.py``'s
     docstring says why; the card counts are the reference's),
  2. builds meta stand-ins for the parameters, the optimizer state and the
     inputs at the rank's local shapes from the reference's ``Rules``
     (``repro_torch.launch.inputs``),
  3. runs the rank's step once: train, ``make_train_step`` with
     ``default_optimizer_for``; prefill, ``LM.prefill`` on the rank's
     weights gathered over the batch axes; decode, the contiguous
     ``LM.decode_step`` over the cache's blocks at ``seq_len`` positions
     (which proves the placement coherent: every local shape fits, every
     collective has its group),
  4. records the memory analysis, the costs and the per-device collective
     bytes, by kind and mesh axis, in a JSON with the reference's fields.

The MoE archs run their expert-parallel path over "model" (the 2-D path,
its sums and gathers over the batch axes, in jamba's ``long_500k``, whose
cache is split along its sequence over those axes) and MLA its heads over
"model".  A cell that fails is an error record, and the sweep goes on, as
the reference's ``run_cell`` records any failure.  The module sets no
environment variable and needs no card.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k \\
      --mesh single --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --fm --smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config, get_smoke_config
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeSpec
from repro_torch.dist import op_analysis, op_costs
from repro_torch.dist.partitioning import Rules
from repro_torch.launch.inputs import (
    batch_sds,
    decode_sds,
    opt_state_sds,
    params_sds,
    rules_for_cell,
    text_seq_len,
)
from repro_torch.launch.mesh import make_production_mesh, make_scaled_mesh
from repro_torch.models.runtime import Runtime
from repro_torch.runtime.elastic import mesh_device
from repro_torch.training.optimizers import default_optimizer_for, get_optimizer
from repro_torch.training.trainer import (
    TrainConfig,
    load_blocks_into_lm,
    make_train_step,
    tp_pieces,
    train_lm,
)
from repro_torch.training.tree import tree_map

# NVIDIA H100 SXM, 700 W, data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth (kernels/tune/roofline.py's), and a link's bandwidth per mesh
# axis: NVLink 4 within a node ("model": 450e9 bytes/s a direction) and a
# 400 Gb/s InfiniBand NDR port a card across nodes ("data", "pod": 50e9).
PEAK_FLOPS = 989e12  # bf16 FLOP/s a card
HBM_BW = 3.35e12  # bytes/s a card
LINK_BW = {"model": 450e9, "data": 50e9, "pod": 50e9}  # bytes/s a card, by axis
DEFAULT_OUT = "results/dryrun_torch"


class Program(NamedTuple):
    """A cell's rank program: ``fn()`` runs it; ``arguments`` is the state
    it is given (its bytes are the memory analysis's arguments)."""

    fn: Callable[[], Any]
    arguments: Any


def _mesh_chips(mesh) -> int:
    return int(mesh.devices.size)


def _runtime_for(cfg, mesh, rules) -> Runtime:
    # paper-faithful baseline: no absorption; the trainer's full-config blocking
    return Runtime(mesh=mesh, rules=rules, remat="full", mla_absorb=False,
                   block_q=64, block_k=64)


def model_flops(cfg, shape: ShapeSpec) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode), N = active params."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * text_seq_len(cfg, shape)
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * text_seq_len(cfg, shape)
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


def _rank_lm(cfg, rt: Runtime, kind: str):
    """The rank's LM on the mesh's device ("meta" for the dry-run), checked
    by the serve plan for a serving cell (a head, an expert count or a
    width that would not divide the model axis)."""
    if kind != "train" and rt.model_world() > 1:
        from repro_torch.serve.sharding import ShardingPlan

        ShardingPlan(rt.mesh, Rules.for_serving(rt.mesh)).check(cfg)
    return train_lm(cfg, rt, mesh_device(rt.mesh))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               rules_overrides: dict | None = None,
               runtime_overrides: dict | None = None,
               serve_params_bf16: bool = False,
               mesh=None, smoke: bool = False):
    """Returns (the rank's program, context dict).

    ``mesh`` overrides the production mesh (the f(m) sweep passes scaled
    meshes, a check on real tensors a stand-in on another device);
    ``smoke`` swaps in the shrunk config; ``shape_name`` may be a
    ``ShapeSpec`` of its own."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES_BY_NAME[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    rules = Rules.default(mesh)
    if rules_overrides:
        rules = rules.override(**rules_overrides)
    rules = rules_for_cell(rules, shape, mesh)
    rt = _runtime_for(cfg, mesh, rules)
    if runtime_overrides:
        rt = dataclasses.replace(rt, **runtime_overrides)
    lm = _rank_lm(cfg, rt, shape.kind)
    params, p_axes = params_sds(lm, mesh, rules)
    p_vals = params.values
    if serve_params_bf16 and shape.kind != "train":
        # serving checkpoints ship in bf16 (half the weight-streaming bytes)
        p_vals = tree_map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
                          p_vals)
    extra = {}
    if shape.kind == "train":
        opt_name = default_optimizer_for(cfg.param_count())
        opt = get_optimizer(opt_name)
        o = opt_state_sds(opt, params, p_axes, mesh, rules, pieces=tp_pieces(cfg))
        b = batch_sds(cfg, shape, mesh, rules)
        step = make_train_step(lm.trainable(), opt, TrainConfig(), rt=rt, local_batch=True)
        program = Program(lambda: step(p_vals, o.values, b.values, 0),
                          (p_vals, o.values, b.values, list(lm.parameters())))
        extra = {"optimizer": opt_name}
    elif shape.kind == "prefill":
        b = batch_sds(cfg, shape, mesh, rules)

        @torch.no_grad()
        def prefill_fn():
            load_blocks_into_lm(lm, p_vals, params.shardings)
            return lm.prefill(b.values["tokens"], b.values.get("frontend_embeds"), rt=rt)

        program = Program(prefill_fn, (p_vals, b.values, list(lm.parameters())))
    else:  # decode
        tokens, lengths, cache = decode_sds(cfg, shape, mesh, rules, lm)

        @torch.no_grad()
        def decode_fn():
            load_blocks_into_lm(lm, p_vals, params.shardings)
            return lm.decode_step(tokens.values, lengths.values, cache.values, rt=rt)

        program = Program(decode_fn, (p_vals, tokens.values, lengths.values, cache.values,
                                      list(lm.parameters())))
    ctx = {"cfg": cfg, "shape": shape, "mesh": mesh, "rules": rules, **extra}
    return program, ctx


def _link_bw(axis: str) -> float:
    """A collective's link bandwidth: the slowest of its axes' (a group over
    "pod" and "data" crosses nodes)."""
    return min(LINK_BW.get(a, LINK_BW["data"]) for a in axis.split("+"))


def analyze(program: Program, ctx) -> dict:
    """Run the rank's program once under the counter; the reference's
    fields, the same names in the same places."""
    cfg, shape, mesh = ctx["cfg"], ctx["shape"], ctx["mesh"]
    chips = _mesh_chips(mesh)
    _, summary = op_costs.count(program.fn, arguments=program.arguments)
    flops_per_device = summary.flops
    bytes_per_device = summary.bytes_accessed
    coll_per_device = op_analysis.collective_bytes(summary)
    wire_per_device = op_analysis.collective_wire_bytes(summary)
    # spec formulas use global sums over chips
    hlo_flops = flops_per_device * chips
    hlo_bytes = bytes_per_device * chips
    t_compute = hlo_flops / (chips * PEAK_FLOPS)
    t_memory = hlo_bytes / (chips * HBM_BW)
    t_coll = sum(wire / _link_bw(axis) for axis, wire in summary.per_axis_wire.items())
    mf = model_flops(cfg, shape)
    dominant = max(
        (("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
        key=lambda kv: kv[1])[0]
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": list(mesh.devices.shape),
        "mesh_axes": list(mesh.axis_names),
        "chips": chips,
        "optimizer": ctx.get("optimizer"),
        "flops_per_device": flops_per_device,
        "bytes_per_device": bytes_per_device,
        # the port counts once, trip-count-exact: these are the same counts
        "xla_cost_analysis_flops": float(flops_per_device),
        "xla_cost_analysis_bytes": float(bytes_per_device),
        "n_while_loops": summary.n_whiles,
        "collective_bytes_per_device": int(coll_per_device),
        "collective_wire_bytes_per_device": int(wire_per_device),
        "collective_breakdown_per_device": op_analysis.collective_breakdown(summary),
        "collective_wire_breakdown_per_device": op_analysis.collective_wire_breakdown(summary),
        "collective_wire_by_axis_per_device": {k: int(v) for k, v in
                                               summary.per_axis_wire.items()},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": mf / hlo_flops if hlo_flops else None,
        "memory_analysis": dict(summary.memory),
        "kernels": summary.kernels,
        "n_params": cfg.param_count(),
        "n_params_active": cfg.param_count(active_only=True),
    }


def attach_tuned_kernels(result: dict, tune_cache_path: str) -> dict:
    """Additive: record autotuner-measured kernel timings next to the
    analytic roofline numbers, so the system model can be fitted on
    measured kernel costs instead of defaults.  Decode cells whose batch
    matches a measured paged-decode entry also get ``t_kernel_measured_s``
    (layers x measured kernel); entries at other batches are ignored
    rather than passed off as measurements of this cell."""
    from repro_torch.kernels.tune import ConfigCache, bench_rows

    cache = ConfigCache(tune_cache_path)
    result["tuned_kernel_rows"] = [
        {"name": n, "us_per_call": us, "derived": d}
        for n, us, d in bench_rows(cache)
    ]
    if result.get("kind") == "decode":
        batch = SHAPES_BY_NAME[result["shape"]].global_batch
        matched = [
            e["us_per_call"] * 1e-6
            for e in cache.entries.values()
            if e["family"] == "flash_decode_paged" and e["shape"]["b"] == batch
        ]
        if matched:
            cfg = get_config(result["arch"])
            result["t_kernel_measured_s"] = cfg.n_layers * min(matched)
    return result


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             force: bool = False, rules_overrides=None,
             runtime_overrides=None, tag: str = "",
             serve_params_bf16: bool = False,
             tune_cache: str | None = None) -> dict:
    multi = mesh_kind == "multi"
    suffix = f"-{tag}" if tag else ""
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    t0 = time.time()
    try:
        program, ctx = lower_cell(
            arch, shape_name, multi, rules_overrides, runtime_overrides,
            serve_params_bf16=serve_params_bf16)
        result = analyze(program, ctx)
        result["status"] = "ok"
        result["compile_seconds"] = time.time() - t0
        if tune_cache:
            result = attach_tuned_kernels(result, tune_cache)
    except Exception as e:  # noqa: BLE001 — recorded, sweep continues
        result = {"arch": arch, "shape": shape_name, "mesh_kind": mesh_kind,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:],
                  "compile_seconds": time.time() - t0}
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=2))
    return result


def fm_sweep(arch: str, shape_name: str, chips: list[int], out_dir: Path,
             smoke: bool = False, force: bool = False) -> dict:
    """Hemingway f(m) from the roofline: run the same (arch, shape) on
    meshes of increasing size, record the analytic step time per mesh, and
    fit ErnestModel on the (m, size, t_step) samples: the paper's system
    model built from counted programs instead of cluster runs."""
    from repro_torch.core.ernest import ErnestModel

    tag = "smoke" if smoke else "full"
    out_path = out_dir / f"fm__{arch}__{shape_name}__{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    samples = []
    for n in chips:
        t0 = time.time()
        mesh = make_scaled_mesh(n, model=min(8, n))
        m = int(mesh.devices.size)   # may be < n (data axis truncates)
        program, ctx = lower_cell(arch, shape_name, False, mesh=mesh, smoke=smoke)
        r = analyze(program, ctx)
        t_step = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
        tokens = ctx["shape"].global_batch * text_seq_len(ctx["cfg"], ctx["shape"])
        samples.append({"m": m, "size": tokens, "t_step_s": t_step,
                        "dominant": r["dominant"],
                        "t_compute_s": r["t_compute_s"],
                        "t_memory_s": r["t_memory_s"],
                        "t_collective_s": r["t_collective_s"],
                        "compile_seconds": time.time() - t0})
        print(f"[f(m)] m={m:4d} t_step={t_step:.3e}s "
              f"dom={r['dominant']} ({samples[-1]['compile_seconds']:.0f}s "
              "compile)", flush=True)
    model = ErnestModel().fit([s["m"] for s in samples],
                              [s["size"] for s in samples],
                              [s["t_step_s"] for s in samples])
    result = {"arch": arch, "shape": shape_name, "smoke": smoke,
              "samples": samples, "ernest_terms": list(model.term_names),
              "ernest_theta": model.coefficients(),
              "ernest_pct_err": list(model.percent_errors(
                  np.asarray([s["m"] for s in samples], float),
                  np.asarray([s["size"] for s in samples], float),
                  np.asarray([s["t_step_s"] for s in samples], float)))}
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=2))
    print(f"[f(m)] theta: {result['ernest_theta']}", flush=True)
    return result


def all_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            yield arch, shape.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fm", action="store_true",
                    help="f(m) sweep: step-time estimates across mesh sizes, "
                         "fitted with ErnestModel")
    ap.add_argument("--fm-chips", type=int, nargs="+",
                    default=[16, 32, 64, 128, 256])
    ap.add_argument("--smoke", action="store_true",
                    help="use the shrunk config (of the smoke configs only "
                         "falcon-mamba-7b's widths divide a model axis of 8)")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="attach measured kernel timings from this "
                         "autotuner config cache to each cell's JSON")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    if args.fm:
        if not args.arch or not args.shape:
            ap.error("--fm requires --arch and --shape")
        return fm_sweep(args.arch, args.shape, args.fm_chips, out_dir,
                        smoke=args.smoke, force=args.force)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    results = []
    for arch, shape in cells:
        for mk in meshes:
            r = run_cell(arch, shape, mk, out_dir, force=args.force,
                         tune_cache=args.tune_cache)
            results.append(r)
            status = r.get("status")
            if status == "ok":
                print(f"[ok]   {arch:24s} {shape:12s} {mk:6s} "
                      f"compute={r['t_compute_s']:.3e}s "
                      f"mem={r['t_memory_s']:.3e}s "
                      f"coll={r['t_collective_s']:.3e}s "
                      f"dom={r['dominant']:10s} "
                      f"({r['compile_seconds']:.0f}s)", flush=True)
            else:
                print(f"[FAIL] {arch:24s} {shape:12s} {mk:6s} "
                      f"{r.get('error', '?')}", flush=True)
    return results


if __name__ == "__main__":
    main()
