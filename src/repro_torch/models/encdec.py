"""Encoder-decoder model (whisper-small).

The conv/mel frontend is a STUB: `input_specs()` provides precomputed
frame embeddings (B, encoder_seq, d_model).  Rope is used in place of
whisper's learned positions, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ShardCtx, constrain, dense_init,
                                       embed, flash_attention,
                                       gather_sequence, head_shardable,
                                       remat, rms_norm, sharded, stack_init)
from repro_torch.models.transformer import _sp, layer, lm_logits, n_layers


# ---------------------------------------------------------------------------
# cross attention (no rope; kv from encoder output)
# ---------------------------------------------------------------------------
def cross_init(gen, cfg: ModelConfig, dtype):
    H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {"wq": dense_init(gen, (d, H * hd), dtype),
            "wk": dense_init(gen, (d, KV * hd), dtype),
            "wv": dense_init(gen, (d, KV * hd), dtype),
            "wo": dense_init(gen, (H * hd, d), dtype)}


def cross_apply(cfg: ModelConfig, p, x, enc_out, ctx=None):
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x, enc_out = gather_sequence(x, ctx), gather_sequence(enc_out, ctx)
    q = attn.split_heads(x @ p["wq"], H, ctx)
    k = attn.split_heads(enc_out @ p["wk"], KV, ctx)
    v = attn.split_heads(enc_out @ p["wv"], KV, ctx)
    if head_shardable(H, ctx):
        q = constrain(q, ctx, "dp", None, "tp", None)
    o = flash_attention(q, k, v, causal=False, ctx=ctx)
    out = o.reshape(B, S, H * hd) @ p["wo"]
    return constrain(out, ctx, "dp", None, None)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _enc_block_init(gen, cfg, dtype):
    d = cfg.d_model
    return {"attn": attn.gqa_init(gen, cfg, dtype),
            "mlp": moe_mod.mlp_init(gen, cfg, dtype),
            "norm1": torch.ones((d,), dtype=dtype),
            "norm2": torch.ones((d,), dtype=dtype)}


def _dec_block_init(gen, cfg, dtype):
    p = _enc_block_init(gen, cfg, dtype)
    p["cross"] = cross_init(gen, cfg, dtype)
    p["norm3"] = torch.ones((cfg.d_model,), dtype=dtype)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator):
    dtype = getattr(torch, cfg.dtype)
    d, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": (torch.randn((V, d), generator=gen)
                  * 0.02).to(dtype),
        "enc_layers": stack_init(cfg.encoder_layers,
                                 lambda: _enc_block_init(gen, cfg, dtype)),
        "dec_layers": stack_init(cfg.num_layers,
                                 lambda: _dec_block_init(gen, cfg, dtype)),
        "enc_norm": torch.ones((d,), dtype=dtype),
        "final_norm": torch.ones((d,), dtype=dtype),
        "lm_head": dense_init(gen, (d, V), dtype),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def encode(cfg: ModelConfig, params, frame_embeds, ctx=None):
    x = _sp(frame_embeds.to(getattr(torch, cfg.dtype)), ctx)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, p):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = _sp(x + attn.gqa_apply(cfg, p["attn"], h, positions=positions,
                                   causal=False, ctx=ctx), ctx)
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        return _sp(x + moe_mod.mlp_apply(cfg, p["mlp"], h, ctx), ctx)
    for i in range(n_layers(params["enc_layers"])):
        x = remat(cfg, body, x, layer(params["enc_layers"], i))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(cfg, p, x, enc_out, positions, ctx):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = _sp(x + attn.gqa_apply(cfg, p["attn"], h, positions=positions,
                               causal=True, ctx=ctx), ctx)
    h = rms_norm(x, p["norm3"], cfg.norm_eps)
    x = _sp(x + cross_apply(cfg, p["cross"], h, enc_out, ctx), ctx)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return _sp(x + moe_mod.mlp_apply(cfg, p["mlp"], h, ctx), ctx)


def forward(cfg: ModelConfig, params, batch, ctx: Optional[ShardCtx] = None):
    with sharded(ctx):
        enc_out = encode(cfg, params, batch["frame_embeds"], ctx)
        x = _sp(embed(params["embed"], batch["tokens"]).to(
            getattr(torch, cfg.dtype)), ctx)
        positions = torch.arange(x.shape[1], device=x.device)
        for i in range(n_layers(params["dec_layers"])):
            x = remat(cfg, _dec_block, cfg, layer(params["dec_layers"], i),
                      x, enc_out, positions, ctx)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return lm_logits(cfg, params, h, ctx)


def decode_step(cfg: ModelConfig, params, batch,
                ctx: Optional[ShardCtx] = None):
    """Decoder step with self-attn KV cache (updated in place);
    cross-attn reads encoder_out."""
    with sharded(ctx):
        return _decode_step(cfg, params, batch, ctx)


def _decode_step(cfg: ModelConfig, params, batch, ctx):
    idx = batch["cache_index"]
    enc_out = batch["encoder_out"].to(getattr(torch, cfg.dtype))
    x = embed(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype))
    x = constrain(x, ctx, "dp", None, None)
    kc, vc = batch["k_cache"], batch["v_cache"]
    for i in range(n_layers(params["dec_layers"])):
        p = layer(params["dec_layers"], i)
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        a = attn.gqa_decode(cfg, p["attn"], h, kc[i], vc[i], idx, ctx=ctx)
        x = x + a
        h = rms_norm(x, p["norm3"], cfg.norm_eps)
        x = x + cross_apply(cfg, p["cross"], h, enc_out, ctx)
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + moe_mod.mlp_apply(cfg, p["mlp"], h, ctx)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, h, ctx), {"k_cache": kc, "v_cache": vc}
