"""The benchmark's harness: finds a cell's files by name, runs the cell's
driver, and prints what it measured and compared.

Everything of one configuration, mix, driver or per-layer metric sits
in its own file under `bench/`, found by the name `BENCHMARK.json` or a
mix gives:

  configs/<config>.json     sizes: the source's keys, and "as_run"
  reference/families/<family>.py
                            the plain reference of the family "as_run"
                            names: its leaves, units and FLOPs a token
  traffic/<mix>.json        the mix: its "kind" names a driver
  drivers/<kind>.py         KEYS, the mix keys it reads, and
                            run(cell, cfg, seed, seconds, trace, dev, t0):
                            drives the program through the mix and
                            compares what it produced with the reference
  limits/<cell>.json        the limit of each number compared
  metrics/<metric>.py       a reader: read(run) -> number or None

The program is imported only inside the functions that drive it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

import devtrace
from reference import ops
from reference.models import layout

#: top-level module names that no run may have imported
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# finding a cell
# ---------------------------------------------------------------------------
@dataclass
class Cell:
    root: Path
    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def sizes(self) -> dict:
        return self.config["as_run"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    data = root / "bench"
    mix = json.loads((data / "traffic" / f"{wl['traffic']}.json")
                     .read_text())
    keys = driver(root, mix["kind"]).KEYS
    if set(mix) != keys:
        raise ValueError(f"mix {wl['traffic']!r}: the {mix['kind']} driver "
                         f"reads {sorted(keys)}; unread "
                         f"{sorted(set(mix) - keys)}, missing "
                         f"{sorted(keys - set(mix))}")
    return Cell(root, name, wl,
                json.loads((root / conf["file"]).read_text()), mix,
                json.loads((data / "limits" / f"{name}.json").read_text()),
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def _load(path: Path, prefix: str):
    name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    return _load(root / "bench" / "metrics" / f"{metric}.py", "bench_metric")


def driver(root: Path, kind: str):
    return _load(root / "bench" / "drivers" / f"{kind}.py", "bench_driver")


def model_config(cell: Cell):
    """The program's ModelConfig built from the file's sizes (a JSON
    list as a tuple); refused where the program's registry holds other
    sizes under the name."""
    from dataclasses import asdict

    from repro_torch.configs.base import ModelConfig, get_config
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cell.sizes.items()})
    reg = get_config(cfg.name)
    if asdict(reg) != asdict(cfg):
        diff = {k: (v, asdict(reg)[k]) for k, v in asdict(cfg).items()
                if asdict(reg)[k] != v}
        raise ValueError(f"{cfg.name}: the program's registry differs from "
                         f"{cell.workload['config']}'s file: {diff}")
    return cfg


def check_layout(cfg, c: dict) -> None:
    """The program's parameter tree has the reference layout's paths,
    shapes and dtypes, so the weights the harness draws fit it."""
    from repro_torch.models.api import abstract_params

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, path + (k,))
        else:
            yield path, tuple(tree.shape), str(tree.dtype).split(".")[-1]
    got = sorted(flat(abstract_params(cfg)))
    want = sorted((lf.path, tuple(lf.shape), lf.dtype) for lf in layout(c))
    if got != want:
        raise ValueError(f"{cfg.name}: the program's parameters differ from "
                         f"the layout: {set(got) ^ set(want)}")


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------
@dataclass
class Run:
    """What the metric readers read: the measured window's counts and
    spans, and the traced window's trace over its `units` steps or
    requests."""
    window: dict
    trace: object = None
    units: int = 0


def log(msg: str, t0: float) -> None:
    """A progress line on standard error, seconds since the process
    started."""
    print(f"[{time.perf_counter() - t0:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def needs_shapes(root: Path, cell: Cell) -> bool:
    return any(getattr(reader(root, m["name"]), "NEEDS_SHAPES", False)
               for m in cell.per_layer)


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def traced(cell: Cell, fn, dev):
    path = cell.root / "build" / "bench" / "trace.json"
    return devtrace.record(fn, path, record_shapes=needs_shapes(cell.root,
                                                               cell),
                          device=dev)


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------
def forbidden_modules(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def result(cell: Cell, out: dict, trace: bool, dev) -> dict:
    metrics = {}
    if trace:
        run = out["run"]
        for m in cell.per_layer:
            v = reader(cell.root, m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell.workload["chips"],
              "memory_peak_bytes": out["peak"]}
    line = {"correct": out["failed"] == 0 and all(
                v["ok"] for v in out["checks"].values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    t = out["run"].trace
    if trace and t is not None:
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        line["breakdown"] = t.breakdown()
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                      | ({"where": v["where"]} if v["where"] else {})
                      for k, v in out["checks"].items()}
    return line


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             dev, t0: float) -> dict:
    cell = load_cell(root, name)
    cfg = model_config(cell)
    check_layout(cfg, cell.sizes)
    if dev.type == "cuda":
        ops.strict_f32()
        torch.cuda.reset_peak_memory_stats(dev)
    out = driver(root, cell.mix["kind"]).run(cell, cfg, seed, seconds,
                                             trace, dev, t0)
    return result(cell, out, trace, dev)
