"""Decoder-only transformer covering the dense / moe / mla_moe / vlm families.

Layers are stacked along a leading L axis, as in the reference, and
driven by a Python loop over it (the reference's `lax.scan`); a stacked
leaf may also be a sequence of per-layer tensors (the train step's
per-layer gradient leaves), which indexes alike.  Each layer body runs
under `common.remat` (the reference's `_remat`); `_sp` is the
reference's sequence-parallel constraint on the residual stream, the
identity without a `ShardCtx`.  Heterogeneous stacks (deepseek first-k
dense layers) are two stacks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ShardCtx, constrain, dense_init,
                                       embed, gather_sequence, is_dtensor,
                                       remat, rms_norm, sharded, stack_init,
                                       tree_map)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _block_init(gen, cfg: ModelConfig, dtype, moe: bool):
    d = cfg.d_model
    if cfg.family == "mla_moe":
        a = attn.mla_init(gen, cfg, dtype)
    else:
        a = attn.gqa_init(gen, cfg, dtype)
    if moe:
        m = moe_mod.moe_init(gen, cfg, dtype)
    else:
        m = moe_mod.mlp_init(gen, cfg, dtype)
    return {"attn": a, "mlp": m,
            "norm1": torch.ones((d,), dtype=dtype),
            "norm2": torch.ones((d,), dtype=dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator):
    dtype = getattr(torch, cfg.dtype)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    n_dense = cfg.first_dense_layers if cfg.num_experts else L
    n_moe = L - n_dense

    params = {
        "embed": (torch.randn((V, d), generator=gen)
                  * 0.02).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype),
    }
    if n_dense:
        params["dense_layers"] = stack_init(
            n_dense, lambda: _block_init(gen, cfg, dtype, moe=False))
    if n_moe:
        params["moe_layers"] = stack_init(
            n_moe, lambda: _block_init(gen, cfg, dtype, moe=True))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, V), dtype)
    if cfg.family == "vlm":
        params["mm_connector"] = dense_init(gen, (d, d), dtype)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": dense_init(gen, (2 * d, d), dtype),
            "norm": torch.ones((d,), dtype=dtype),
            "block": _block_init(gen, cfg, dtype, moe=bool(cfg.num_experts)),
        }
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _sp(x, ctx):
    """Megatron-style sequence-parallel residual-stream constraint."""
    if ctx is None:
        return x
    S = x.shape[1]
    if ctx.tp is not None and S % ctx.mesh.shape[ctx.tp] == 0:
        return constrain(x, ctx, "dp", "tp", None)
    return constrain(x, ctx, "dp", None, None)


def block_apply(cfg: ModelConfig, p, x, positions, ctx, *, moe: bool,
                causal: bool = True):
    # norm outputs pinned to SP: the attention/MLP full-sequence gather
    # then moves the activation's dtype, not the f32 rms statistics
    h = _sp(rms_norm(x, p["norm1"], cfg.norm_eps), ctx)
    if cfg.family == "mla_moe":
        a = attn.mla_apply(cfg, p["attn"], h, positions=positions,
                           causal=causal, ctx=ctx)
    else:
        a = attn.gqa_apply(cfg, p["attn"], h, positions=positions,
                           causal=causal, ctx=ctx)
    x = _sp(x + a, ctx)
    h = _sp(rms_norm(x, p["norm2"], cfg.norm_eps), ctx)
    if moe:
        m = moe_mod.moe_apply(cfg, p["mlp"], h, ctx)
    else:
        m = moe_mod.mlp_apply(cfg, p["mlp"], h, ctx)
    return _sp(x + m, ctx)


def layer(stacked, i: int):
    """Layer i of a stacked parameter tree (views, no copy)."""
    return tree_map(lambda a: a[i], stacked)


def n_layers(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return len(stacked)


def scan_stack(cfg: ModelConfig, stacked, x, positions, ctx, *, moe: bool):
    def body(x, p):
        return block_apply(cfg, p, x, positions, ctx, moe=moe)
    for i in range(n_layers(stacked)):
        x = remat(cfg, body, x, layer(stacked, i))
    return x


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def embed_inputs(cfg: ModelConfig, params, batch, ctx):
    tok = embed(params["embed"], batch["tokens"])  # gather
    if cfg.family == "vlm":
        img = batch["patch_embeds"] @ params["mm_connector"]
        x = torch.cat([img, tok], dim=1)
    else:
        x = tok
    return _sp(x.to(getattr(torch, cfg.dtype)), ctx)


def forward(cfg: ModelConfig, params, batch, ctx: Optional[ShardCtx] = None,
            return_hidden: bool = False):
    """Full-sequence forward -> logits (B, S, V)."""
    with sharded(ctx):
        x = embed_inputs(cfg, params, batch, ctx)
        positions = torch.arange(x.shape[1], device=x.device)
        if "dense_layers" in params:
            x = scan_stack(cfg, params["dense_layers"], x, positions, ctx,
                           moe=False)
        if "moe_layers" in params:
            x = scan_stack(cfg, params["moe_layers"], x, positions, ctx,
                           moe=True)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = lm_logits(cfg, params, h, ctx)
    if return_hidden:
        return logits, h
    return logits


def lm_logits(cfg: ModelConfig, params, h, ctx=None):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    h = gather_sequence(h, ctx)
    if ctx is not None and ctx.tp is not None and is_dtensor(w):
        # the vocabulary split over the model axis before the product, so
        # each device computes its own logits, evenly or not: XLA pads a
        # vocabulary the axis does not divide (mamba2-780m's 50,280)
        w = w.redistribute(w.device_mesh, ctx.spec(None, "tp"))
        return h @ w.to(h.dtype)
    return constrain(h @ w.to(h.dtype), ctx, "dp", None, "tp")


def mtp_logits(cfg: ModelConfig, params, h, batch,
               ctx: Optional[ShardCtx] = None):
    """DeepSeek-V3 multi-token prediction: one extra block predicting t+2.

    h: main-model hidden states (B, S, d).  Combines h[t] with emb(tok[t+1]).
    """
    p = params["mtp"]
    tok = embed(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        raise NotImplementedError
    with sharded(ctx):
        nxt = torch.roll(tok, -1, dims=1).to(h.dtype)
        z = torch.cat([rms_norm(h, p["norm"], cfg.norm_eps), nxt], -1)
        z = _sp(gather_sequence(z, ctx) @ p["proj"], ctx)
        z = block_apply(cfg, p["block"], z,
                        torch.arange(z.shape[1], device=z.device), ctx,
                        moe=bool(cfg.num_experts))
        return lm_logits(cfg, params, rms_norm(z, params["final_norm"],
                                               cfg.norm_eps), ctx)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_step(cfg: ModelConfig, params, batch,
                ctx: Optional[ShardCtx] = None):
    """One decode step.  batch: tokens (B,1), cache_index (), caches.

    Returns (logits (B, 1, V), caches): the batch's caches, updated in
    place at cache_index.
    """
    with sharded(ctx):
        return _decode_step(cfg, params, batch, ctx)


def _decode_step(cfg: ModelConfig, params, batch, ctx):
    idx = batch["cache_index"]
    x = embed(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype))
    x = constrain(x, ctx, "dp", None, None)
    mla = cfg.family == "mla_moe"
    caches = ({"kv_cache": batch["kv_cache"]} if mla else
              {"k_cache": batch["k_cache"], "v_cache": batch["v_cache"]})
    off = 0
    for name, moe in (("dense_layers", False), ("moe_layers", True)):
        if name not in params:
            continue
        for i in range(n_layers(params[name])):
            p, c = layer(params[name], i), off + i
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            if mla:
                a = attn.mla_decode(cfg, p["attn"], h,
                                    caches["kv_cache"][c], idx, ctx=ctx)
            else:
                a = attn.gqa_decode(cfg, p["attn"], h, caches["k_cache"][c],
                                    caches["v_cache"][c], idx, ctx=ctx)
            x = x + a
            h = rms_norm(x, p["norm2"], cfg.norm_eps)
            x = x + (moe_mod.moe_apply(cfg, p["mlp"], h, ctx) if moe
                     else moe_mod.mlp_apply(cfg, p["mlp"], h, ctx))
        off += n_layers(params[name])

    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, h, ctx), caches
