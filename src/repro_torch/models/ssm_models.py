"""Full models for the ssm (mamba2-780m) and hybrid (zamba2-7b) families.

zamba2 structure: a Mamba2 backbone with ONE shared attention+MLP block
(weights shared) applied before every `attn_every`-th layer.  Layers are
processed in groups: [shared-attn] -> mamba x attn_every, so decode
indexes the attention caches by group.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.common import (ShardCtx, constrain, dense_init,
                                       embed, remat, rms_norm, sharded,
                                       stack_init, tree_map)
from repro_torch.models.transformer import _sp, layer, lm_logits, n_layers


def _mamba_block_init(gen, cfg: ModelConfig, dtype):
    return {"norm": torch.ones((cfg.d_model,), dtype=dtype),
            "mixer": ssm.mamba_init(gen, cfg, dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator):
    dtype = getattr(torch, cfg.dtype)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    params = {
        "embed": (torch.randn((V, d), generator=gen)
                  * 0.02).to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype),
        "layers": stack_init(L, lambda: _mamba_block_init(gen, cfg, dtype)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, V), dtype)
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "attn": attn.gqa_init(gen, cfg, dtype),
            "mlp": moe_mod.mlp_init(gen, cfg, dtype),
            "norm1": torch.ones((d,), dtype=dtype),
            "norm2": torch.ones((d,), dtype=dtype),
        }
    return params


def _mamba_block(cfg, x, p, ctx=None):
    # the norm output pinned back to SP, so the full-sequence gather the
    # mixer needs moves the activation's dtype, not the f32 statistics
    h = _sp(rms_norm(x, p["norm"], cfg.norm_eps), ctx)
    return _sp(x + ssm.mamba_apply(cfg, p["mixer"], h, ctx), ctx)


def _mamba_stack(cfg, stacked, x, ctx=None):
    for i in range(n_layers(stacked)):
        x = remat(cfg, _mamba_block, cfg, x, layer(stacked, i), ctx)
    return x


def _shared_attn_apply(cfg, p, x, positions, ctx=None):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    a = attn.gqa_apply(cfg, p["attn"], h, positions=positions, causal=True,
                       ctx=ctx)
    x = _sp(x + a, ctx)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return _sp(x + moe_mod.mlp_apply(cfg, p["mlp"], h, ctx), ctx)


def _groups(cfg: ModelConfig):
    """[(start, end), ...] mamba-layer groups, one shared-attn before each."""
    k = cfg.attn_every
    return [(s, min(s + k, cfg.num_layers)) for s in range(0, cfg.num_layers, k)]


def _slice(stacked, s: int, e: int):
    return tree_map(lambda a: a[s:e], stacked)


def forward(cfg: ModelConfig, params, batch, ctx: Optional[ShardCtx] = None):
    with sharded(ctx):
        x = embed(params["embed"], batch["tokens"]).to(
            getattr(torch, cfg.dtype))
        x = _sp(x, ctx)
        if cfg.family == "ssm":
            x = _mamba_stack(cfg, params["layers"], x, ctx)
        else:
            positions = torch.arange(x.shape[1], device=x.device)
            for (s, e) in _groups(cfg):
                # outside the layer stacks, so it carries its own remat,
                # as in the reference
                x = remat(cfg, _shared_attn_apply, cfg,
                          params["shared_attn"], x, positions, ctx)
                x = _mamba_stack(cfg, _slice(params["layers"], s, e), x,
                                 ctx)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return lm_logits(cfg, params, h, ctx)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _mamba_stack_decode(cfg, stacked, x, ssm_states, conv_states,
                        ctx=None):
    """Layers of `stacked` in turn; writes each layer's new states into
    ssm_states[i] / conv_states[i] in place.  Under a ctx the residual
    stays in the decode's layout (`_decode_residual`)."""
    for i in range(ssm_states.shape[0]):
        p = layer(stacked, i)
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        out, s_new, c_new = ssm.mamba_decode(cfg, p["mixer"], h,
                                             ssm_states[i], conv_states[i])
        ssm_states[i].copy_(s_new)
        conv_states[i].copy_(c_new)
        x = _decode_residual(x + out, ctx)
    return x


def _decode_residual(x, ctx):
    """The decode's residual (B, 1, d) in the layout its first constraint
    gives it, split over the batch only, as the reference's scan carries
    it: each layer's row-parallel output is a partial sum, which DTensor
    would otherwise reduce wherever its version's rules choose (before
    the add, or inside the next norm)."""
    return constrain(x, ctx, "dp", None, None)


def decode_step(cfg: ModelConfig, params, batch,
                ctx: Optional[ShardCtx] = None):
    """One decode step; returns (logits (B, 1, V), caches): the batch's
    caches, updated in place."""
    with sharded(ctx):
        return _decode_step(cfg, params, batch, ctx)


def _decode_step(cfg: ModelConfig, params, batch, ctx):
    idx = batch["cache_index"]
    x = embed(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype))
    x = constrain(x, ctx, "dp", None, None)
    ss, cs = batch["ssm_state"], batch["conv_state"]
    caches = {"ssm_state": ss, "conv_state": cs}

    if cfg.family == "ssm":
        x = _mamba_stack_decode(cfg, params["layers"], x, ss, cs, ctx)
    else:
        kc, vc = batch["k_cache"], batch["v_cache"]
        caches = {"k_cache": kc, "v_cache": vc, **caches}
        sp = params["shared_attn"]
        for j, (s, e) in enumerate(_groups(cfg)):
            h = rms_norm(x, sp["norm1"], cfg.norm_eps)
            a = attn.gqa_decode(cfg, sp["attn"], h, kc[j], vc[j], idx,
                                ctx=ctx)
            x = _decode_residual(x + a, ctx)
            h = rms_norm(x, sp["norm2"], cfg.norm_eps)
            x = _decode_residual(x + moe_mod.mlp_apply(cfg, sp["mlp"], h, ctx),
                                 ctx)
            x = _mamba_stack_decode(cfg, _slice(params["layers"], s, e), x,
                                    ss[s:e], cs[s:e], ctx)

    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, h, ctx), caches
