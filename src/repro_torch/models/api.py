"""Unified model API: init / forward / decode_step dispatched by family.

Parameters are a dict tree of tensors with the reference's keys and
stacked (L, ...) layout; every function here takes and returns such
trees.  `init_params` and the inputs of `configs.make_inputs` land on
the card unless `device="cpu"` is named.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, ssm_models, transformer
from repro_torch.models.common import ShardCtx, tree_leaves


def _mod(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "mla_moe", "vlm"):
        return transformer
    if cfg.family in ("ssm", "hybrid"):
        return ssm_models
    if cfg.family == "encdec":
        return encdec
    raise ValueError(cfg.family)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """Random parameters on `device` (the card when None), drawn from
    `generator` (one on that device seeded 0 when None) with the
    reference's shapes, dtypes and std."""
    device = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, parameters on {device}")
    with torch.device(device):
        return _mod(cfg).init_params(cfg, gen)


def abstract_params(cfg: ModelConfig):
    """Parameters as meta tensors: shapes and dtypes, no allocation."""
    with torch.device("meta"):
        return _mod(cfg).init_params(cfg, torch.Generator())


def forward(cfg: ModelConfig, params, batch,
            ctx: Optional[ShardCtx] = None, **kw):
    return _mod(cfg).forward(cfg, params, batch, ctx, **kw)


def decode_step(cfg: ModelConfig, params, batch,
                ctx: Optional[ShardCtx] = None):
    """One token: (logits (B, 1, V), caches), the batch's caches updated
    in place."""
    return _mod(cfg).decode_step(cfg, params, batch, ctx)


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
