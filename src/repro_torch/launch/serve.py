"""Serving entry point: batched greedy decode with KV/SSM caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --tokens 32 --batch 4 --ctx-len 4096        # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import cache_specs, get_config
from repro_torch.models import api as models
from repro_torch.train.steps import make_serve_step


def init_caches(cfg, B, S, device=None) -> dict:
    """Zero decode caches for B sequences of S positions on `device`."""
    device = resolve_device(device)
    specs = cache_specs(cfg, B, S, getattr(torch, cfg.dtype))
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}


def decode_batch(cfg, B, S, device) -> dict:
    """The first decode step's batch: token 0 at position 0 over zero
    caches (and zero encoder output for encdec), as the reference's
    `main` starts."""
    batch = {"tokens": torch.zeros((B, 1), dtype=torch.int32, device=device),
             "cache_index": torch.zeros((), dtype=torch.int32,
                                        device=device),
             **init_caches(cfg, B, S, device)}
    if cfg.family == "encdec":
        batch["encoder_out"] = torch.zeros(
            (B, cfg.encoder_seq, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=device)
    return batch


def generate(cfg, params, batch, n_tokens: int) -> torch.Tensor:
    """Greedy decode of n_tokens from `batch` (advanced in place); returns
    the tokens, (B, n_tokens) on the batch's device.  Nothing waits for
    the card inside the loop."""
    serve = make_serve_step(cfg)
    toks = []
    for _ in range(n_tokens):
        nxt, caches = serve(params, batch)
        toks.append(nxt[:, 0])
        batch.update(caches, tokens=nxt.to(torch.int32),
                     cache_index=batch["cache_index"] + 1)
    return torch.stack(toks, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--ctx-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    with torch.inference_mode():
        params = models.init_params(cfg, device=device)
        batch = decode_batch(cfg, args.batch, args.ctx_len, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        toks = generate(cfg, params, batch, args.tokens).cpu().numpy()
        dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s)")
    print("sample:", toks[0][:16])


if __name__ == "__main__":
    main()
