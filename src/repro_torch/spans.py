"""The spans the port opens around the phases of a train step, by name.

A span is a record function of the profiler (`span`): it lands in the
same trace as the device's kernels, on one clock, so a kernel belongs to
the span its launch lies inside.  Spans are recorded exactly when a
`torch.profiler` records; otherwise one costs under a microsecond of
host time.  They do not pass through the dispatcher, so the dispatch
modes of the fake-tensor dry run (`launch/hlo_analysis.py`) never see
them.

  train.step        `make_train_step`'s step: the whole call
  train.forward     the model's forward and the loss, of each (micro)batch
  train.backward    `loss.backward` of each (micro)batch, on the caller's
                    thread (on the card autograd's own thread launches
                    the work)
  train.recompute   a layer body run again inside the backward under
                    remat, on autograd's thread
  train.accumulate  a microbatch's gradient added into the f32
                    accumulator (`accum_steps` > 1)
  train.optimizer   `adamw.update`
  data.synthetic_batch, data.to_device
                    the data pipeline's two functions
  model.shared_block
                    one invocation of a zamba2 shared block and its
                    linear (`models.ssm_models.shared_block`): in the
                    forward, and again in the recompute
"""
from __future__ import annotations

import torch

STEP = "train.step"
FORWARD = "train.forward"
BACKWARD = "train.backward"
RECOMPUTE = "train.recompute"
ACCUMULATE = "train.accumulate"
OPTIMIZER = "train.optimizer"
SYNTHETIC_BATCH = "data.synthetic_batch"
TO_DEVICE = "data.to_device"
SHARED_BLOCK = "model.shared_block"


def span(name: str):
    """A context manager that records `name` around its block while a
    profiler records."""
    return torch._C._profiler._RecordFunctionFast(name)
