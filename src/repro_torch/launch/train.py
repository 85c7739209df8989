"""Training entry point, on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --smoke --steps 50 --ckpt-dir ck --device cpu

--smoke runs the reduced same-family config at --seq x --batch; without
it, the full config runs at --shape, on the card unless --device names
another.  A global batch larger than one step's memory takes
--accum-steps microbatches.  Either way the loop exercises
checkpoint/restart, the deterministic data stream, and OFU monitoring.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs.base import SHAPES, ShapeSpec, get_config
from repro_torch.flops.accounting import step_flops
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="microbatches a step (make_train_step's "
                    "accum_steps)")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        shape = ShapeSpec("smoke", args.seq, args.batch, "train")
    else:
        shape = SHAPES[args.shape]

    if shape.global_batch % args.accum_steps:
        raise SystemExit(f"batch {shape.global_batch} does not split into "
                         f"{args.accum_steps} microbatches")
    print(f"{cfg.name}: a step of {shape.global_batch} sequences of "
          f"{shape.seq_len} tokens ({shape.name}), as {args.accum_steps} "
          f"microbatch(es) of {shape.global_batch // args.accum_steps}")
    fl = step_flops(cfg, shape, executed=True).total
    trainer = Trainer(
        cfg, shape,
        opt_cfg=adamw.OptConfig(warmup_steps=5, decay_steps=args.steps),
        train_cfg=TrainConfig(total_steps=args.steps,
                              ckpt_every=args.ckpt_every,
                              ckpt_dir=args.ckpt_dir, device=args.device),
        flops_per_step=fl, accum_steps=args.accum_steps)
    out = trainer.run()
    print(json.dumps(out, indent=1, default=float))
    return out


if __name__ == "__main__":
    main()
