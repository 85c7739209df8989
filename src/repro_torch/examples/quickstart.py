"""Quickstart: train a small model end-to-end with OFU monitoring,
atomic checkpointing, and crash recovery — the full §VI loop.

  PYTHONPATH=src python -m repro_torch.examples.quickstart \\
      [--steps 40] [--arch qwen3-4b] [--device cpu]

The default runs the reduced same-family config of the chosen
architecture on the card (--device names another device); attention
runs the flash kernel and a Mamba2 or hybrid arch (e.g. zamba2-7b) the
SSD kernel.  `python -m repro_torch.launch.train` runs the full configs.

Fleet engine quickstart (`repro_torch.fleet`): simulate thousands of
devices x hours of 30 s scrapes on the card, then roll them up into
streaming per-job/per-precision/fleet OFU percentiles, the histogram
kernel reducing each grid on the device:

    from repro_torch.fleet import JobSpec, StreamingRollup, simulate_fleet

    specs = [JobSpec(f"job{i}", "granite-3-2b", chips=1000,
                     true_duty=0.35, duration_s=3600) for i in range(4)]
    roll = StreamingRollup(bucket_s=300)
    for tel in simulate_fleet(specs, max_devices=1000):
        roll.add_job(tel)
    print(roll.summary())                    # fleet-wide weighted OFU
    series = roll.job_ofu("job0")            # feed to detect_regressions
    p50 = roll.fleet_stats().percentiles[50]  # bucketed fleet median

`python -m repro_torch.benchmarks.run fleet_engine` measures the engine;
see `repro_torch.examples.fleet_monitoring` for the full §V/§VI
monitoring loop.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.flops.accounting import step_flops
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> dict:
    """Train; return `Trainer.run`'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_quickstart"))
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    shape = ShapeSpec("quickstart", args.seq, args.batch, "train")
    print(f"training {cfg.name} ({cfg.family}) seq={args.seq} "
          f"batch={args.batch} for {args.steps} steps")

    trainer = Trainer(
        cfg, shape,
        opt_cfg=adamw.OptConfig(peak_lr=1e-3, warmup_steps=5,
                                decay_steps=args.steps),
        train_cfg=TrainConfig(total_steps=args.steps, ckpt_every=10,
                              ckpt_dir=args.ckpt_dir, log_every=5,
                              device=args.device),
        flops_per_step=step_flops(cfg, shape, executed=True).total)
    out = trainer.run()

    if not trainer.history:          # no step ran in this call
        print(f"checkpoint at step {out['final_step']} already >= "
              f"--steps {args.steps}: nothing to do (delete "
              f"{args.ckpt_dir} or raise --steps to continue training).")
        return out
    print(json.dumps(out["metrics"][-3:], indent=1, default=float))
    loss = ("" if out["final_loss"] is None
            else f"last logged loss {out['final_loss']:.3f}; ")
    print(f"{loss}{len(trainer.history)} steps run, now at step "
          f"{out['final_step']}; OFU per step logged via the simulated "
          f"counter backend.")
    print("kill it mid-run and re-run: it resumes from the atomic "
          "checkpoint with an identical data stream.")
    return out


if __name__ == "__main__":
    main()
