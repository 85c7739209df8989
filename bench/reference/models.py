"""The plain reference of the benchmark's two families, from the sizes in
a configuration file's "as_run" group.

A model is its parameter layout (`layout`: the path, shape, dtype and
initial law of each tensor, which the harness draws from the seed and
hands to both sides) and a sequence of units (`units`): embedding, then
blocks that each map the residual stream (B, S, d) to itself, then the
head.  `forward` runs them in f32; `train.py` differentiates them one
unit at a time.  Families:

  dense   a GQA transformer: norm, attention, norm, gated MLP, a layer
  hybrid  Mamba2 layers, one attention + MLP block (its weights shared)
          applied before every `attn_every`-th layer
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from reference import ops


@dataclass(frozen=True)
class Leaf:
    path: tuple          # keys into the parameter tree
    shape: tuple
    dtype: str           # "bfloat16" or "float32"
    init: str            # normal | ones | zeros | a_log | dt_bias
    std: float = 0.0


def _mat(path, shape, dt, scale=1.0):
    return Leaf(path, shape, dt, "normal", scale / math.sqrt(shape[-2]))


def _attn_block(prefix, c, dt, L=None):
    d, H, KV, hd, ff = (c["d_model"], c["num_heads"], c["num_kv_heads"],
                        c["head_dim"], c["d_ff"])
    lead = () if L is None else (L,)
    return [
        _mat(prefix + ("attn", "wq"), lead + (d, H * hd), dt),
        _mat(prefix + ("attn", "wk"), lead + (d, KV * hd), dt),
        _mat(prefix + ("attn", "wv"), lead + (d, KV * hd), dt),
        _mat(prefix + ("attn", "wo"), lead + (H * hd, d), dt),
        _mat(prefix + ("mlp", "wi"), lead + (d, ff), dt),
        _mat(prefix + ("mlp", "wo"), lead + (ff, d), dt),
        _mat(prefix + ("mlp", "wg"), lead + (d, ff), dt),
        Leaf(prefix + ("norm1",), lead + (d,), dt, "ones"),
        Leaf(prefix + ("norm2",), lead + (d,), dt, "ones"),
    ]


def layout(c) -> list:
    """Every parameter tensor of the model, in a fixed order."""
    dt, d, V, L = c["dtype"], c["d_model"], c["vocab_size"], c["num_layers"]
    out = [Leaf(("embed",), (V, d), dt, "normal", 0.02),
           Leaf(("final_norm",), (d,), dt, "ones")]
    if c["family"] == "dense":
        out += _attn_block(("dense_layers",), c, dt, L)
    elif c["family"] == "hybrid":
        di = c["ssm_expand"] * d
        g, ds = c["ssm_ngroups"], c["ssm_state"]
        nh, W = di // c["ssm_head_dim"], c["conv_width"]
        conv = di + 2 * g * ds
        m = ("layers", "mixer")
        out += [Leaf(("layers", "norm"), (L, d), dt, "ones"),
                _mat(m + ("in_proj",), (L, d, 2 * di + 2 * g * ds + nh), dt),
                _mat(m + ("conv_w",), (L, W, conv), dt, 0.5),
                Leaf(m + ("conv_b",), (L, conv), dt, "zeros"),
                Leaf(m + ("A_log",), (L, nh), "float32", "a_log"),
                Leaf(m + ("D",), (L, nh), "float32", "ones"),
                Leaf(m + ("dt_bias",), (L, nh), "float32", "dt_bias"),
                Leaf(m + ("out_norm",), (L, di), dt, "ones"),
                _mat(m + ("out_proj",), (L, di, d), dt)]
        out += _attn_block(("shared_attn",), c, dt)
    else:
        raise ValueError(f"no reference for family {c['family']!r}")
    if not c.get("tie_embeddings", False):
        out.append(_mat(("lm_head",), (d, V), dt))
    return out


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def sub(tree, i=None):
    """The f32 view of a parameter subtree, layer i of a stacked one."""
    if isinstance(tree, dict):
        return {k: sub(v, i) for k, v in tree.items()}
    return (tree if i is None else tree[i]).float()


@dataclass
class Unit:
    """One residual block: `fn(c, p, x, prec)` with p = `sub(params at
    path, layer)`; `path`/`layer` name where its parameters live."""
    fn: object
    path: tuple
    layer: int | None


def _dense_block(c, p, x, prec):
    x = x + ops.gqa(c, p["attn"], ops.rms_norm(x, p["norm1"], c["norm_eps"]),
                    prec)
    return x + ops.gated_mlp(p["mlp"], ops.rms_norm(x, p["norm2"],
                                                    c["norm_eps"]), prec)


def _mamba_block(c, p, x, prec):
    return x + ops.mamba(c, p["mixer"], ops.rms_norm(x, p["norm"],
                                                    c["norm_eps"]), prec)


def units(c) -> list:
    L = c["num_layers"]
    if c["family"] == "dense":
        return [Unit(_dense_block, ("dense_layers",), i) for i in range(L)]
    out = []
    for s in range(0, L, c["attn_every"]):
        out.append(Unit(_dense_block, ("shared_attn",), None))
        out += [Unit(_mamba_block, ("layers",), i)
                for i in range(s, min(s + c["attn_every"], L))]
    return out


def head_weight(c, params):
    return params["embed"].T if c.get("tie_embeddings") else params["lm_head"]


@torch.no_grad()
def last_logits(c, params, tokens, prec):
    """f32 logits (B, V) at the last position of tokens (B, S)."""
    x = params["embed"][tokens.long()].float()
    for u in units(c):
        x = u.fn(c, sub(get(params, u.path), u.layer), x, prec)
    h = ops.rms_norm(x[:, -1], params["final_norm"].float(), c["norm_eps"])
    return prec.mm(h, head_weight(c, params).float())


@torch.no_grad()
def all_logits(c, params, tokens, prec, rows: int = 1024):
    """f32 logits (B, S, V) at every position, the head in row blocks."""
    x = params["embed"][tokens.long()].float()
    for u in units(c):
        x = u.fn(c, sub(get(params, u.path), u.layer), x, prec)
    h = ops.rms_norm(x, params["final_norm"].float(), c["norm_eps"])
    w = head_weight(c, params).float()
    B, S, d = h.shape
    h = h.reshape(B * S, d)
    return torch.cat([prec.mm(h[i:i + rows], w)
                      for i in range(0, B * S, rows)]).reshape(B, S, -1)
