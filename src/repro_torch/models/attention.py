"""Attention layers: GQA (dense/moe/vlm/encdec/hybrid) and MLA (deepseek-v3).

Each layer exposes:
  init(gen, cfg, dtype)                  -> params (unstacked; callers stack)
  apply(cfg, p, x, ...)                  -> full-sequence forward
  decode(cfg, p, x, caches, idx, ...)    -> single-token forward + cache update

Decode writes the new position into the caches in place (`index_copy_`
at a 0-d device `cache_index`, so no host sync a token) and returns them,
where the reference returns updated copies.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ShardCtx, apply_rope, constrain,
                                       decode_attention, dense_init,
                                       flash_attention, gather_sequence,
                                       head_shardable, is_dtensor, rms_norm)


def _positions(cache_index: torch.Tensor) -> torch.Tensor:
    """The one decode position, (1,), on cache_index's device."""
    return cache_index.reshape(1).to(torch.int32)


def _write(cache: torch.Tensor, cache_index: torch.Tensor,
           new: torch.Tensor) -> torch.Tensor:
    """cache[:, cache_index] = new[:, 0], in place.  An index past the
    cache's end writes its last row, as the reference's
    `dynamic_update_slice` clamps its start (on the device: no sync)."""
    if is_dtensor(cache):
        return _write_sharded(cache, cache_index, new)
    idx = cache_index.reshape(1).long().clamp(0, cache.shape[1] - 1)
    return cache.index_copy_(1, idx, new.to(cache.dtype))


def _write_sharded(cache, cache_index, new):
    """`_write` on a DTensor cache, whose sequence may be split over the
    mesh: each device writes the row into its own shard, where the row
    falls in it (rewriting the row it holds there otherwise), with `new`
    placed as the cache but whole over the sequence.  DTensor has no
    rule for an index write into a split dimension (XLA's
    dynamic-update-slice is partitioned this way)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    mesh, place = cache.device_mesh, cache.placements
    with _disable_current_modes():
        shape, offset = compute_local_shape_and_global_offset(
            tuple(cache.shape), mesh, place)
    row = [Replicate() if p == Shard(1) else p for p in place]
    new = new.to(cache.dtype).redistribute(mesh, row).to_local()
    local = cache.to_local()
    idx = cache_index.full_tensor().reshape(1).long() \
        .clamp(0, cache.shape[1] - 1) - offset[1]
    inside = (idx >= 0) & (idx < shape[1])
    idx = idx.clamp(0, shape[1] - 1)
    keep = local.index_select(1, idx)
    local.index_copy_(1, idx, torch.where(inside, new, keep))
    return cache


# ===========================================================================
# GQA
# ===========================================================================
def gqa_init(gen, cfg: ModelConfig, dtype):
    H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": dense_init(gen, (d, H * hd), dtype),
        "wk": dense_init(gen, (d, KV * hd), dtype),
        "wv": dense_init(gen, (d, KV * hd), dtype),
        "wo": dense_init(gen, (H * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype)
        p["k_norm"] = torch.ones((hd,), dtype=dtype)
    return p


def split_heads(t, n: int, ctx):
    """(B, S, n·hd) -> (B, S, n, hd).  Under a ctx whose model axis does
    not divide n, the projection is first gathered over that axis: a
    DTensor splits a sharded dimension only where its leading part
    divides the mesh (XLA reshards there on its own)."""
    B, S, nhd = t.shape
    if not head_shardable(n, ctx):
        t = constrain(t, ctx, "dp", None, None)
    return t.reshape(B, S, n, nhd // n)


def _qkv(cfg: ModelConfig, p, x, positions, ctx):
    H, KV = cfg.num_heads, cfg.num_kv_heads
    x = gather_sequence(x, ctx)
    q = split_heads(x @ p["wq"], H, ctx)
    k = split_heads(x @ p["wk"], KV, ctx)
    v = split_heads(x @ p["wv"], KV, ctx)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if head_shardable(H, ctx):
        q = constrain(q, ctx, "dp", None, "tp", None)
    if head_shardable(KV, ctx):
        k = constrain(k, ctx, "dp", None, "tp", None)
        v = constrain(v, ctx, "dp", None, "tp", None)
    return q, k, v


def gqa_apply(cfg: ModelConfig, p, x, *, positions, causal: bool,
              ctx: Optional[ShardCtx] = None):
    """Full-sequence self-attention."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions, ctx)
    o = flash_attention(q, k, v, causal=causal, ctx=ctx)
    out = o.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return constrain(out, ctx, "dp", "tp", None)


def gqa_decode(cfg: ModelConfig, p, x, k_cache, v_cache, cache_index, *,
               ctx: Optional[ShardCtx] = None):
    """x: (B, 1, d); caches: (B, S, KV, hd), updated in place.  Returns
    the output (B, 1, d)."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x, _positions(cache_index), ctx)
    _write(k_cache, cache_index, k_new)
    _write(v_cache, cache_index, v_new)
    o = decode_attention(q, k_cache, v_cache, cache_index)
    out = o.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return constrain(out, ctx, "dp", None, None)


# ===========================================================================
# MLA (multi-head latent attention, deepseek-v3)
#
# q: d -> q_lora -> H*(nope+rope); kv: d -> (kv_lora + rope_shared);
# decode cache stores only the compressed latent + shared rope key.
# ===========================================================================
def mla_init(gen, cfg: ModelConfig, dtype):
    d, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, (d, qr), dtype),
        "q_norm": torch.ones((qr,), dtype=dtype),
        "wq_b": dense_init(gen, (qr, H * (dn + dr)), dtype),
        "wkv_a": dense_init(gen, (d, kvr + dr), dtype),
        "kv_norm": torch.ones((kvr,), dtype=dtype),
        "wkv_b": dense_init(gen, (kvr, H * (dn + dv)), dtype),
        "wo": dense_init(gen, (H * dv, d), dtype),
    }


def _mla_q(cfg, p, x, positions, ctx):
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    q = q.reshape(B, S, H, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    q = torch.cat([q[..., :dn], q_rope], -1)
    if head_shardable(H, ctx):
        q = constrain(q, ctx, "dp", None, "tp", None)
    return q


def _mla_kv_from_latent(cfg, p, latent, ctx):
    """latent: (B, S, kv_lora + rope) -> per-head k (nope+rope), v."""
    B, S, _ = latent.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    c_kv, k_rope = latent[..., :cfg.kv_lora_rank], latent[..., cfg.kv_lora_rank:]
    kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps) @ p["wkv_b"]
    kv = kv.reshape(B, S, H, dn + dv)
    k = torch.cat([kv[..., :dn],
                   k_rope[:, :, None, :].expand(B, S, H, dr)], -1)
    v = kv[..., dn:]
    if head_shardable(H, ctx):
        k = constrain(k, ctx, "dp", None, "tp", None)
        v = constrain(v, ctx, "dp", None, "tp", None)
    return k, v


def mla_apply(cfg: ModelConfig, p, x, *, positions, causal: bool,
              ctx: Optional[ShardCtx] = None):
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _mla_q(cfg, p, x, positions, ctx)
    latent = x @ p["wkv_a"]  # (B, S, kv_lora + rope)
    k_rope = apply_rope(latent[..., cfg.kv_lora_rank:][:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0, :]
    latent = torch.cat([latent[..., :cfg.kv_lora_rank], k_rope], -1)
    k, v = _mla_kv_from_latent(cfg, p, latent, ctx)
    o = flash_attention(q, k, v, causal=causal, scale=(dn + dr) ** -0.5,
                        ctx=ctx)
    out = o.reshape(B, S, cfg.num_heads * cfg.v_head_dim) @ p["wo"]
    return constrain(out, ctx, "dp", "tp", None)


def mla_decode(cfg: ModelConfig, p, x, kv_cache, cache_index, *,
               ctx: Optional[ShardCtx] = None):
    """Absorbed MLA decode against the compressed latent cache.

    kv_cache: (B, S, kv_lora + rope) holding the *normalized* latent plus the
    shared roped key, updated in place; returns the output (B, 1, d).
    Per-head K/V are never expanded
    over S: wkv_b is absorbed into the query (scores) and the output
    (values), so attention runs directly in latent space.
    """
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr, dv, kvr = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                       cfg.kv_lora_rank)
    f32 = torch.float32
    positions = _positions(cache_index)
    q = _mla_q(cfg, p, x, positions, ctx)  # (B, 1, H, dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    latent = x @ p["wkv_a"]
    c_kv = rms_norm(latent[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(latent[..., kvr:][:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0, :]
    _write(kv_cache, cache_index, torch.cat([c_kv, k_rope], -1))
    cached_c = kv_cache[..., :kvr].to(f32)      # (B, S, kvr)
    cached_r = kv_cache[..., kvr:].to(f32)      # (B, S, dr)

    w_kv = p["wkv_b"].reshape(kvr, H, dn + dv)
    w_k, w_v = w_kv[..., :dn], w_kv[..., dn:]
    # absorb w_k into the query: (B, H, kvr)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32), w_k.to(f32))
    s = (torch.einsum("bhr,bsr->bhs", q_lat, cached_c)
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(f32), cached_r)
         ) * (dn + dr) ** -0.5
    S = kv_cache.shape[1]
    valid = torch.arange(S, device=x.device) <= cache_index
    s = s.masked_fill(~valid[None, None], -math.inf)
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", prob, cached_c)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_v.to(f32))
    out = o.reshape(B, 1, H * dv).to(x.dtype) @ p["wo"]
    return constrain(out, ctx, "dp", None, None)
