"""MLP layers: dense (gated / plain) and mixture-of-experts.

MoE uses the GShard-style dense one-hot dispatch into per-expert capacity
slots, as the reference does.  Top-k routing is `torch.topk`, which may
break exact ties otherwise than `jax.lax.top_k`; on continuous router
probabilities ties do not occur.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (activation_fn, dense_init, gated,
                                       stack_init)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------
def mlp_init(gen, cfg: ModelConfig, dtype, d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, (d, ff), dtype),
         "wo": dense_init(gen, (ff, d), dtype)}
    if gated(cfg.activation):
        p["wg"] = dense_init(gen, (d, ff), dtype)
    return p


def mlp_apply(cfg: ModelConfig, p, x):
    act = activation_fn(cfg.activation)
    h = x @ p["wi"]
    if "wg" in p:
        h = act(x @ p["wg"]) * h
    else:
        h = act(h)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_init(gen, cfg: ModelConfig, dtype):
    d, E, ffe = cfg.d_model, cfg.num_experts, cfg.d_ff_expert

    def one_expert():
        p = {"wi": dense_init(gen, (d, ffe), dtype),
             "wo": dense_init(gen, (ffe, d), dtype)}
        if gated(cfg.activation):
            p["wg"] = dense_init(gen, (d, ffe), dtype)
        return p

    p = {"router": dense_init(gen, (d, E), torch.float32),
         "experts": stack_init(E, one_expert)}
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, cfg, dtype,
                               d_ff=cfg.d_ff_expert * cfg.num_shared_experts)
    return p


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k / cfg.num_experts
            * cfg.capacity_factor)
    # round to a multiple of 8, keep >= top_k
    c = max(c, cfg.top_k)
    return -(-c // 8) * 8


def moe_apply(cfg: ModelConfig, p, x, router_stats: bool = False):
    """x: (B, S, d).  Routing groups = batch rows (GShard grouping)."""
    B, S, d = x.shape
    if S == 1 and B > 1:
        # decode: route the whole batch as ONE group -- per-row groups pad
        # every expert's capacity to top_k PER TOKEN
        y = moe_apply(cfg, p, x.reshape(1, B, d), router_stats)
        if router_stats:
            return y[0].reshape(B, S, d), y[1]
        return y.reshape(B, S, d)
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)
    act = activation_fn(cfg.activation)

    logits = x.float() @ p["router"]                       # (B, S, E)
    probs = torch.softmax(logits, -1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)     # (B, S, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, k) assignment within its expert's capacity
    khot = F.one_hot(gate_idx, E).to(torch.int32)          # (B, S, K, E)
    flat = khot.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)
    in_cap = (pos < C) & (khot > 0)

    # dispatch: (B, S, E, C) one-hot over capacity slots
    pos_in_e = (pos * khot).sum(-1)                        # (B, S, K)
    # a slot past C is no slot (jax.nn.one_hot gives zeros there)
    slot_hot = F.one_hot(pos_in_e.clamp_max(C).long(), C + 1)[..., :C] \
        .to(x.dtype)                                       # (B, S, K, C)
    keep = in_cap.any(-1).to(x.dtype)                      # (B, S, K)

    dispatch = torch.zeros((B, S, E, C), dtype=x.dtype, device=x.device)
    combine = torch.zeros_like(dispatch)
    for k in range(K):
        ek = F.one_hot(gate_idx[:, :, k], E).to(x.dtype)
        contrib = (ek[..., None] * slot_hot[:, :, k, None, :]
                   * keep[:, :, k, None, None])            # (B, S, E, C)
        dispatch = dispatch + contrib
        combine = combine + contrib * gate_vals[:, :, k, None, None] \
            .to(x.dtype)

    xe = torch.einsum("bsd,bsec->becd", x, dispatch)       # (B, E, C, d)
    h = torch.einsum("becd,edf->becf", xe, p["experts"]["wi"])
    if "wg" in p["experts"]:
        h = act(torch.einsum("becd,edf->becf", xe, p["experts"]["wg"])) * h
    else:
        h = act(h)
    ye = torch.einsum("becf,efd->becd", h, p["experts"]["wo"])
    y = torch.einsum("becd,bsec->bsd", ye, combine)

    if cfg.num_shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x)

    if router_stats:
        # load-balance aux loss (Switch-style)
        frac_tokens = F.one_hot(gate_idx[..., 0], E).float().mean((0, 1))
        frac_probs = probs.mean((0, 1))
        aux = E * torch.sum(frac_tokens * frac_probs)
        return y, aux
    return y
