"""A benchmark root at smoke size for the CPU tests: the real metric
readers and limits layout, with the program's smoke configurations
registered under their own names."""
from __future__ import annotations

import json
import shutil
from dataclasses import asdict
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SIZE_KEYS = ("name", "family", "num_layers", "d_model", "num_heads",
             "num_kv_heads", "head_dim", "d_ff", "vocab_size", "ssm_state",
             "ssm_expand", "ssm_head_dim", "ssm_ngroups", "ssm_chunk",
             "conv_width", "attn_every", "activation", "tie_embeddings",
             "rope_theta", "norm_eps", "dtype", "remat")


def smoke_sizes(arch: str, dtype: str = "float32") -> dict:
    """The program's smoke reduction of `arch`, registered in its
    registry, as a configuration file's "as_run" group: the fields of
    SIZE_KEYS, and every other field that differs from its default."""
    from dataclasses import fields, replace

    from repro_torch.configs.base import ModelConfig, get_config, register
    cfg = replace(get_config(arch).smoke(), dtype=dtype)
    register(cfg)
    default = {f.name: f.default for f in fields(ModelConfig)}
    return {k: v for k, v in asdict(cfg).items()
            if k in SIZE_KEYS or v != default[k]}


TRAIN_MIX = {"kind": "train", "seq_len": 16, "batch": 2,
             "optimizer": {"peak_lr": 3e-4, "min_lr": 3e-5,
                           "warmup_steps": 1, "decay_steps": 10000,
                           "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                           "weight_decay": 0.1, "clip_norm": 1.0,
                           "moment_dtype": "float32", "factored_v": True},
             "setup_steps": 3, "ref_steps": 3, "trace_steps": 1}
PREFILL_MIX = {"kind": "prefill", "block": {"8": 1, "16": 2, "32": 1},
               "sample": 3, "trace_requests": 4, "max_rate_per_s": 20}
#: the serving cells' end-to-end metrics, which no cell of BENCHMARK.json
#: reports yet
PREFILL_E2E = [
    {"name": "prefill_tokens_per_s", "unit": "tokens/s", "better": "higher",
     "bound": 0.25, "source": "host_clock"},
    {"name": "prefill_p95_ms", "unit": "ms", "better": "lower",
     "bound": 0.01, "source": "host_clock"}]
MOVES = {"train": "train_tokens_per_s", "prefill": "prefill_tokens_per_s"}


def make_root(tmp: Path, cells: dict, *, limits: dict | None = None,
              extra_metrics: dict | None = None) -> Path:
    """A checkout-like root under tmp holding BENCHMARK.json and its
    files: cells maps a cell name to (arch, mix dict)."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp / "bench"
    for d in ("metrics", "drivers"):
        shutil.copytree(BENCH / d, bench / d)
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    spec = {k: real[k] for k in ("command", "paths", "run_seconds")}
    spec.update(configs=[], workloads=[], end_to_end=[], per_layer=[])
    kinds = {}
    for cell, (arch, mix) in cells.items():
        sizes = smoke_sizes(arch)
        conf = sizes["name"]
        (bench / "configs" / f"{conf}.json").write_text(
            json.dumps({"as_run": sizes}))
        if conf not in [c["name"] for c in spec["configs"]]:
            spec["configs"].append({"name": conf, "source": "smoke",
                                    "file": f"bench/configs/{conf}.json",
                                    "reduced": [], "why": "test"})
        traffic = f"{cell}-mix"
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
        lim = (limits or {}).get(cell) or (
            {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3}
            if mix["kind"] == "train" else {"logit_gap": 1e-3})
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(lim))
        spec["workloads"].append({"name": cell, "config": conf,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
        kinds.setdefault(mix["kind"], []).append(cell)
    # every end-to-end metric of a kind (the start of its name), and every
    # reader of a kind (the suffix of its name), in each cell of that kind
    for m in real["end_to_end"] + PREFILL_E2E:
        kind = m["name"].split("_")[0]
        if kind in MOVES:
            if not kinds.get(kind):
                continue
            m = dict(m, workloads=kinds[kind])
        spec["end_to_end"].append(m)
    listed = {m["name"]: m for m in real["per_layer"]}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        kind = path.stem.rsplit(".", 1)[-1]
        if kinds.get(kind):
            m = dict(listed.get(path.stem) or {
                "name": path.stem, "unit": "1", "better": "lower",
                "source": "device_trace", "layer": "test",
                "moves": MOVES[kind]})
            m["workloads"] = kinds[kind]
            spec["per_layer"].append(m)
    for name, (src, moves, wls) in (extra_metrics or {}).items():
        (bench / "metrics" / f"{name}.py").write_text(src)
        spec["per_layer"].append({"name": name, "unit": "ms",
                                  "better": "lower", "source": "program_span",
                                  "layer": "test", "moves": moves,
                                  "workloads": wls})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
