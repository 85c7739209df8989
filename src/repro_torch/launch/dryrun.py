"""Dry run: trace every (architecture × input-shape) cell's step as one
device of the production mesh sees it, and extract the roofline inputs,
for an H100 of 256 or 512.

The reference lowers and compiles each step for a 256- or 512-chip TPU
mesh and reads XLA's analyses of the SPMD program.  The port has no
compiler to ask: it places the step's parameters, optimizer state and
batch as DTensors on the production mesh over a fake process group of
512 ranks in this one process (`launch.mesh.fake_world`), with the
reference's layouts (`launch.sharding`'s three spec functions and a
`ShardCtx(mesh, dp, tp, ep)` through the models' constraints, the
serving EP² and the FSDP drop as the reference takes them), runs the
step once (`launch.hlo_analysis.analyze_step`), through the kernels' ops
and their sharding rules, and writes the reference's record for each
cell, per device:

  * memory: argument, output and temporary bytes and the peak of the
    live bytes (the card's allocator rounding) — whether it fits 80 GB —
    and what is live at the peak, by the op that allocated it (`at_peak`);
  * FLOPs and HBM traffic of the traced ops on the local shards (`hlo`;
    `cost_raw` holds the same counts), and the collectives' wire bytes
    and counts by kind;
  * MODEL_FLOPS (6·N_active·D) and the analytic executed-FLOPs breakdown.

The mesh's local tensors are meta tensors: DTensor's own bookkeeping
runs torch ops on real index tensors, which a FakeTensorMode would turn
fake.  Passed a one-device mesh (`mesh=`), a cell runs unplaced, as one
card runs it, on fake CUDA tensors (`trace_device`) or, on a PyTorch
built without CUDA, which cannot run an index or record an autograd
graph even on a fake CUDA tensor, fake meta tensors, which the kernels'
wrappers send down the same route (their ops' fake versions); the
record is then one card's, with the mesh's parallelism choice recorded
under `parallelism` and nothing placed.

Usage:
  python -m repro_torch.launch.dryrun --arch zamba2-7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] \
      [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import traceback
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      get_config, input_specs, list_configs)
from repro_torch.flops.accounting import (model_flops_6nd,
                                          param_count_analytic, step_flops)
from repro_torch.launch.hlo_analysis import analyze_step, fake_mode
from repro_torch.launch.mesh import (Mesh, axes_of, fake_world,
                                     make_production_mesh)
from repro_torch.launch.sharding import (batch_shardings, distribute_tree,
                                         opt_state_shardings,
                                         param_shardings)
from repro_torch.models import api as models
from repro_torch.models.common import ShardCtx, tree_map
from repro_torch.optim import adamw
from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                     make_train_step)


def trace_device() -> str:
    """The fake tensors' device: "cuda", or "meta" on a PyTorch built
    without CUDA (there an index of a fake CUDA tensor raises, and
    autograd aborts the process on its graph)."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------
def parallelism_for(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                    policy: str = "auto"):
    """(dp_axes, tp_axis) per arch/shape — the §Perf cell-A optimization.

    Small dense models (≤ ~8B params) are communication-bound under 16-way
    TP at 256 chips; pure DP+FSDP over BOTH mesh axes cuts that.  Big /
    MoE / head-heavy models keep the TP axis.  policy="baseline"
    reproduces the paper-faithful TP16 layout.
    """
    dp, tp = axes_of(mesh)
    if policy == "baseline":
        return dp, tp
    small = param_count_analytic(cfg) < 8e9
    # ssm/hybrid excluded: their (B,nc,nh,Q,Q) SSD intermediates need the
    # head-sharded TP layout
    pure_dp_ok = (small and shape.kind == "train"
                  and cfg.family in ("dense", "vlm", "encdec"))
    if pure_dp_ok:
        return dp + (tp,), None
    return dp, tp


@dataclass
class Cell:
    """One cell's step and its fake arguments (DTensors on a mesh of more
    than one device), and the mesh's layout for it."""

    fn: object
    args: tuple
    cfg: ModelConfig
    shape: ShapeSpec
    layout: dict


def _fake_like(tree, device: str):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device), tree)


def build_cell(arch, shape, mesh: Mesh, *, fsdp: bool = True,
               opt_cfg: Optional[adamw.OptConfig] = None,
               accum_steps: Optional[int] = None, policy: str = "auto",
               device: Optional[str] = None) -> Optional[Cell]:
    """The step of one cell and its arguments; None for a cell the arch
    skips.  On a mesh of more than one device (whose process group must
    be open: `fake_world`) the arguments are DTensors placed by the
    reference's layouts, holding meta tensors of their local shards, and
    the step carries the mesh's `ShardCtx`; on one device they are fake
    tensors on `device` (`trace_device()` when None), unplaced.

    `arch` is a name or a `ModelConfig`, `shape` a name of `SHAPES` or a
    `ShapeSpec`.  A train cell's optimizer is the reference's choice
    (bf16 first moment and factored second moment, and 4 microbatches,
    for the big models) unless `opt_cfg` / `accum_steps` are given."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if not cfg.supports_shape(shape):
        return None
    dp, tp = parallelism_for(cfg, shape, mesh, policy)

    # serving mode (§Perf cell B): EP² experts over the full mesh; drop
    # FSDP when the non-expert weights fit TP-sharded + replicated.
    # DECODE ONLY: at prefill token volume the EP² dispatch gathers dwarf
    # the weight gathers it saves.
    serving = policy != "baseline" and shape.kind == "decode"
    ep = None
    if serving:
        dense_bytes = (param_count_analytic(cfg, active_only=True) * 2
                       / (mesh.shape[tp] if tp else mesh.size))
        if cfg.num_experts and tp is not None \
                and cfg.num_experts % mesh.size == 0:
            ep = tuple(dp) + (tp,)
        # drop FSDP only when the weights actually fit without it: experts
        # must be EP²-shardable (else they'd replicate over data)
        experts_ok = not cfg.num_experts or ep is not None
        fsdp = fsdp and not (dense_bytes < 8e9 and experts_ok)
    layout = {"dp": list(dp), "tp": tp, "ep": list(ep) if ep else None,
              "fsdp": fsdp, "serving": serving}

    placed = mesh.size > 1
    ctx = ShardCtx(mesh=mesh, dp=dp, tp=tp, ep=ep) if placed else None
    device = "meta" if placed else (device or trace_device())
    mode = contextlib.nullcontext() if placed else fake_mode()
    with mode:
        params = _fake_like(models.abstract_params(cfg), device)
        batch = _fake_like(input_specs(cfg, shape), device)
        opt_state = None
        if shape.kind == "train":
            big = cfg.num_layers * cfg.d_model > 250_000
            if opt_cfg is None:
                opt_cfg = adamw.OptConfig(
                    moment_dtype="bfloat16" if big else "float32",
                    factored_v=big)
            # gradient accumulation for the giants: activations scale
            # with the microbatch
            accum = accum_steps or (4 if big else 1)
            layout.update(accum_steps=accum, opt=opt_cfg.moment_dtype
                          + ("/factored_v" if opt_cfg.factored_v else ""))
            opt_state = adamw.init(opt_cfg, params)
        if placed:
            if opt_state is not None:
                opt_state = distribute_tree(opt_state, opt_state_shardings(
                    opt_state, mesh, dp, tp, fsdp), mesh)
            params = distribute_tree(params, param_shardings(
                cfg, params, mesh, dp, tp, fsdp, serving=serving), mesh)
            batch = distribute_tree(batch, batch_shardings(
                cfg, shape, mesh, dp, tp), mesh)
        if shape.kind == "train":
            fn = make_train_step(cfg, opt_cfg, ctx, accum_steps=accum)
            args = (params, opt_state, batch)
        elif shape.kind == "prefill":
            fn, args = make_prefill_step(cfg, ctx), (params, batch)
        else:  # decode
            fn, args = make_serve_step(cfg, ctx), (params, batch)
    return Cell(fn, args, cfg, shape, layout)


def run_cell(arch, shape, *, multi_pod: bool = False, fsdp: bool = True,
             opt_cfg: Optional[adamw.OptConfig] = None,
             accum_steps: Optional[int] = None,
             device: Optional[str] = None, trackers=(),
             mesh: Optional[Mesh] = None) -> dict:
    """The dry run's record of one cell (the reference's schema), per
    device of `mesh`: the production mesh (`multi_pod` picks which) when
    None.  A one-device mesh gives one card's record, unplaced.
    `trackers` go to `analyze_step`.  The fake process group the mesh
    needs is open only for the call."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    name = arch if isinstance(arch, str) else arch.name
    shape_name = shape if isinstance(shape, str) else shape.name
    world = fake_world() if mesh.size > 1 else contextlib.nullcontext()
    with world:
        cell = build_cell(arch, shape, mesh, fsdp=fsdp, opt_cfg=opt_cfg,
                          accum_steps=accum_steps, device=device)
        if cell is None:
            return {"arch": name, "shape": shape_name, "skipped": True,
                    "reason": "full-attention arch skips long_500k "
                              "(DESIGN.md)"}
        st = analyze_step(cell.fn, *cell.args, trackers=trackers)
        del cell.args
    cfg, shape = cell.cfg, cell.shape
    analytic = step_flops(cfg, shape, executed=True,
                          remat=(cfg.remat != "none"))
    return {
        "arch": name, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.axis_sizes)) if mesh.size > 1
        else "1",
        "devices": mesh.size,
        "trace_device": "meta" if mesh.size > 1
        else (device or trace_device()),
        "parallelism": cell.layout,
        "lower_s": st.trace_s, "compile_s": 0.0,
        "memory": {"argument_bytes": st.argument_bytes,
                   "output_bytes": st.output_bytes,
                   "temp_bytes": st.temp_bytes,
                   "peak_bytes": st.peak_bytes,
                   "at_peak": st.at_peak},
        # no separate compiler estimate: the traced counts again
        "cost_raw": {"flops": st.flops, "bytes_accessed": st.traffic_bytes},
        "hlo": {"flops": st.flops,
                "traffic_bytes": st.traffic_bytes,
                "collective_bytes": st.collective_bytes,
                "collective_counts": st.collective_counts,
                "flops_by_op": st.flops_by_op},
        "model_flops_6nd": model_flops_6nd(cfg, shape),
        "analytic_mxu_flops": analytic.total_mxu,
        "analytic_vpu_flops": analytic.total_vpu,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in list_configs() for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("pass --arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip-cached] {tag}")
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               fsdp=not args.no_fsdp)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec.get("skipped"):
                    print(f"[skipped ] {tag}: {rec['reason']}")
                else:
                    print(f"[ok      ] {tag}: "
                          f"flops={rec['hlo']['flops']:.3e} "
                          f"peak_mem={rec['memory']['peak_bytes'] / 2**30:.2f}"
                          f"GiB trace={rec['lower_s']:.1f}s "
                          f"({rec['trace_device']})")
            except Exception as e:
                failures += 1
                print(f"[FAILED  ] {tag}: {type(e).__name__}: {e}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
