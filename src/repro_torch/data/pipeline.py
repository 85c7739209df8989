"""Deterministic synthetic token pipeline, shardable across hosts.

Batches are a pure function of (seed, step, host) -- restart-safe (a resumed
job regenerates exactly the stream it would have seen) and host-shardable
(each host materializes only its slice of the global batch), which is the
property a 1000-node input pipeline actually needs.

The draws are the reference's, in NumPy, bitwise.  NumPy has no bfloat16,
so a float input of a bf16 model stays float32 here: the value the
reference rounds to bf16 last (its f64 -> bf16 cast goes through f32);
`to_device` makes that last rounding.
"""
from __future__ import annotations

import threading
from queue import Empty, Queue
from typing import Iterator

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig, ShapeSpec


def _float_dtype(cfg: ModelConfig):
    return np.float32 if cfg.dtype == "bfloat16" else np.dtype(cfg.dtype)


def synthetic_batch(cfg: ModelConfig, shape: ShapeSpec, step: int, *,
                    seed: int = 0, host_id: int = 0,
                    num_hosts: int = 1) -> dict:
    """Materialize this host's slice of the global batch for `step`."""
    with spans.span(spans.SYNTHETIC_BATCH):
        if shape.global_batch % num_hosts:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {num_hosts} hosts")
        B = shape.global_batch // num_hosts
        S = shape.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, host_id]))
        S_txt = S - cfg.num_image_tokens if cfg.family == "vlm" else S
        batch = {"tokens": rng.integers(
            0, cfg.vocab_size, (B, S_txt)).astype(np.int32)}
        if shape.kind == "train":
            batch["labels"] = rng.integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)
        fdt = _float_dtype(cfg)
        if cfg.family == "vlm":
            batch["patch_embeds"] = (rng.standard_normal(
                (B, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(fdt)
        if cfg.family == "encdec":
            batch["frame_embeds"] = (rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(fdt)
        return batch


def to_device(cfg: ModelConfig, batch: dict, device) -> dict:
    """A `synthetic_batch` as tensors on `device`, floats in the model
    dtype: one copy a key."""
    dt = getattr(torch, cfg.dtype)
    with spans.span(spans.TO_DEVICE):
        return {k: torch.from_numpy(v).to(
            device, dt if v.dtype.kind == "f" else None, non_blocking=True)
            for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of the deterministic stream."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, *,
                 start_step: int = 0, seed: int = 0, host_id: int = 0,
                 num_hosts: int = 1, depth: int = 2):
        self.cfg, self.shape = cfg, shape
        self.seed, self.host_id, self.num_hosts = seed, host_id, num_hosts
        self.step = start_step
        self.q: Queue = Queue(maxsize=depth)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            b = synthetic_batch(self.cfg, self.shape, s, seed=self.seed,
                                host_id=self.host_id,
                                num_hosts=self.num_hosts)
            self.q.put((s, b))
            s += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except Empty:
            pass
