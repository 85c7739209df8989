"""zamba2: Zamba2-7B-Instruct's layers, from the equations of
`transformers` 4.57.6, `models/zamba2/modeling_zamba2.py`.

Mamba2 layers are stacked under "layers"; `num_shared_blocks` shared
transformer blocks under "shared_blocks" (their leading dim the block);
each invocation's LoRA adapter on the MLP's gate_up under "adapters" and
its own linear under "linears" (their leading dim the invocation).
Invocation i runs before Mamba layer l = shared_block_layers[i] and uses
block i mod num_shared_blocks; with x the stream and e the embedding's
output:

  h = RMSNorm_2d(concat(x, e))                    block's input_layernorm
  a = o(attention(rope(q(h)), rope(k(h)), v(h)))  32 heads of 224 from 2d,
                                                  scale (hd / 2)^-1/2
  g = gate_up(RMSNorm_d(a)) + lora_b(lora_a(RMSNorm_d(a)))
  t = linear_i(down(GELU(g[:ff]) · g[ff:]))       exact (erf) GELU
  x = x + Mamba_l(RMSNorm(x + t))                 the residual is x

and every Mamba layer's gated RMSNorm of y · silu(z) normalises in
`ssm_ngroups` groups of d_inner / ngroups.  Invocation i and layer l
are one unit; every other layer is a unit of its own.

Departures from `modeling_zamba2.py`:
- dt is not clamped below at `time_step_min` (its plain PyTorch path
  clamps; its CUDA path, with `time_step_limit` null, does not).
- The output head is the embedding, transposed (`tie_word_embeddings`
  is not in the published config; `transformers`' default ties).
- No padding mask, cache or position offset: positions 0..S-1.
- Attention runs a batch row and `KV_BLOCK` kv heads at a time, and the
  Mamba mixer and the MLP a batch row at a time, each recomputed in the
  backward: the same values, so that one unit's working set fits beside
  the stream at the cell's size.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import ops
from reference.families import hybrid
from reference.models import Leaf, Unit, mat

#: kv heads a piece of the blocked attention
KV_BLOCK = 8


def leaves(c) -> list:
    """The Mamba layers' leaves, as the hybrid family has them, then the
    shared blocks', the adapters' and the linears'."""
    dt, d = c["dtype"], c["d_model"]
    H, KV, hd, ff = c["num_heads"], c["num_kv_heads"], c["head_dim"], \
        c["d_ff"]
    nb, n, r = c["num_shared_blocks"], len(c["shared_block_layers"]), \
        c["adapter_rank"]
    b = ("shared_blocks",)
    return [lf for lf in hybrid.leaves(c) if lf.path[0] == "layers"] + [
            mat(b + ("attn", "wq"), (nb, 2 * d, H * hd), dt, stacked=True),
            mat(b + ("attn", "wk"), (nb, 2 * d, KV * hd), dt, stacked=True),
            mat(b + ("attn", "wv"), (nb, 2 * d, KV * hd), dt, stacked=True),
            mat(b + ("attn", "wo"), (nb, H * hd, d), dt, stacked=True),
            mat(b + ("mlp", "gate_up"), (nb, d, 2 * ff), dt, stacked=True),
            mat(b + ("mlp", "down"), (nb, ff, d), dt, stacked=True),
            Leaf(b + ("norm1",), (nb, 2 * d), dt, "ones", stacked=True),
            Leaf(b + ("norm2",), (nb, d), dt, "ones", stacked=True),
            mat(("adapters", "lora_a"), (n, d, r), dt, stacked=True),
            mat(("adapters", "lora_b"), (n, r, 2 * ff), dt, stacked=True),
            mat(("linears",), (n, d, d), dt, stacked=True)]


def _by_rows(fn, x, *args):
    """fn(x[b:b+1], *args) for each batch row b, concatenated; under
    grad each row's intermediates are recomputed in the backward."""
    if not torch.is_grad_enabled():
        return torch.cat([fn(x[b:b + 1], *args) for b in range(x.shape[0])])
    return torch.cat([checkpoint(fn, x[b:b + 1], *args, use_reentrant=False)
                      for b in range(x.shape[0])])


def grouped_gated_norm(c, y, z, w):
    """RMSNorm of y · silu(z) in ssm_ngroups groups of its last dim."""
    h = y * F.silu(z)
    g = c["ssm_ngroups"]
    hg = h.reshape(*h.shape[:-1], g, h.shape[-1] // g)
    return ops.rms_norm(hg, w.reshape(g, -1), c["norm_eps"]) \
        .reshape(h.shape)


def _mixer(u, c, p, prec):
    """Mamba2 mixer of u (B, S, d), already normed: `ops.mamba`'s, its
    gated norm grouped."""
    B, S, _ = u.shape
    di = c["ssm_expand"] * c["d_model"]
    g, ds, hd = c["ssm_ngroups"], c["ssm_state"], c["ssm_head_dim"]
    nh = di // hd
    proj = prec.mm(u, p["in_proj"])
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * g * ds]
    dt = F.softplus(proj[..., 2 * di + 2 * g * ds:] + p["dt_bias"])
    xbc = F.silu(ops.causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :di].reshape(B, S, nh, hd)
    Bm = xbc[..., di:di + g * ds].reshape(B, S, g, ds)
    Cm = xbc[..., di + g * ds:].reshape(B, S, g, ds)
    y = ops.ssd(xs, dt, -torch.exp(p["A_log"]), Bm, Cm, c["ssm_chunk"])
    y = (y + p["D"][:, None] * xs).reshape(B, S, di)
    return prec.mm(grouped_gated_norm(c, y, z, p["out_norm"]),
                   p["out_proj"])


def mamba(c, p, x, t, prec):
    """x + Mamba(RMSNorm(x + t)): layer p's mixer input gets t, its
    residual is x."""
    h = ops.rms_norm(x if t is None else x + t, p["norm"], c["norm_eps"])
    return x + _by_rows(_mixer, h, c, p["mixer"], prec)


def _mlp(h, c, blk, ad, prec):
    gu = prec.mm(h, blk["mlp"]["gate_up"]) \
        + prec.mm(prec.mm(h, ad["lora_a"]), ad["lora_b"])
    gate, up = gu.chunk(2, dim=-1)
    return prec.mm(F.gelu(gate) * up, blk["mlp"]["down"])


def shared_block(c, blk, ad, lin, x, e, prec):
    """t of one invocation: the block on concat(x, e), then its linear."""
    B, S, _ = x.shape
    H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    p, eps, th = blk["attn"], c["norm_eps"], c["rope_theta"]
    h = ops.rms_norm(torch.cat([x, e], dim=-1), blk["norm1"], eps)
    # (hd / 2)^-1/2 = √2 · hd^-1/2, the scale ops.attention applies
    q = ops.rope(prec.mm(h, p["wq"]).reshape(B, S, H, hd), th) * math.sqrt(2)
    k = ops.rope(prec.mm(h, p["wk"]).reshape(B, S, KV, hd), th)
    v = prec.mm(h, p["wv"]).reshape(B, S, KV, hd)
    o = ops.attention(q, k, v, KV_BLOCK)
    a = prec.mm(o.reshape(B, S, H * hd), p["wo"])
    h = ops.rms_norm(a, blk["norm2"], eps)
    return prec.mm(_by_rows(_mlp, h, c, blk, ad, prec), lin)


def hybrid_unit(c, ps, x, e, prec):
    blk, ad, lin, p = ps
    return mamba(c, p, x, shared_block(c, blk, ad, lin, x, e, prec), prec)


def mamba_unit(c, ps, x, e, prec):
    (p,) = ps
    return mamba(c, p, x, None, prec)


def units(c) -> list:
    at = {l: i for i, l in enumerate(c["shared_block_layers"])}
    out = []
    for l in range(c["num_layers"]):
        if l in at:
            i = at[l]
            out.append(Unit(hybrid_unit, (
                (("shared_blocks",), i % c["num_shared_blocks"]),
                (("adapters",), i), (("linears",), i), (("layers",), l))))
        else:
            out.append(Unit(mamba_unit, ((("layers",), l),)))
    return out


def invocation_flops(c, seq: int) -> float:
    """One invocation a token: q, k, v from 2d, o, the causal scores, the
    gated MLP, the adapter and the linear."""
    d, H, KV, hd, ff, r = (c["d_model"], c["num_heads"], c["num_kv_heads"],
                           c["head_dim"], c["d_ff"], c["adapter_rank"])
    attn = 2 * 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d \
        + 2 * 2 * (seq * 0.5) * H * hd
    mlp = 2 * d * ff * 3
    return attn + mlp + 2 * d * r + 2 * r * 2 * ff + 2 * d * d


def flops_per_token(c, seq: int) -> float:
    return c["num_layers"] * hybrid.mamba_flops(c) \
        + len(c["shared_block_layers"]) * invocation_flops(c, seq)
