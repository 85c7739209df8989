"""dense: a GQA transformer, a layer each of norm, attention, norm,
gated MLP, the layers stacked under "dense_layers"."""
from __future__ import annotations

from reference import ops
from reference.models import Leaf, Unit, mat


def attn_block(prefix, c, dt, L=None):
    """The leaves of one attention + MLP block, L of them stacked."""
    d, H, KV, hd, ff = (c["d_model"], c["num_heads"], c["num_kv_heads"],
                        c["head_dim"], c["d_ff"])
    lead, st = ((), False) if L is None else ((L,), True)
    return [
        mat(prefix + ("attn", "wq"), lead + (d, H * hd), dt, stacked=st),
        mat(prefix + ("attn", "wk"), lead + (d, KV * hd), dt, stacked=st),
        mat(prefix + ("attn", "wv"), lead + (d, KV * hd), dt, stacked=st),
        mat(prefix + ("attn", "wo"), lead + (H * hd, d), dt, stacked=st),
        mat(prefix + ("mlp", "wi"), lead + (d, ff), dt, stacked=st),
        mat(prefix + ("mlp", "wo"), lead + (ff, d), dt, stacked=st),
        mat(prefix + ("mlp", "wg"), lead + (d, ff), dt, stacked=st),
        Leaf(prefix + ("norm1",), lead + (d,), dt, "ones", stacked=st),
        Leaf(prefix + ("norm2",), lead + (d,), dt, "ones", stacked=st),
    ]


def block(c, ps, x, e, prec):
    (p,) = ps
    x = x + ops.gqa(c, p["attn"], ops.rms_norm(x, p["norm1"], c["norm_eps"]),
                    prec)
    return x + ops.gated_mlp(p["mlp"], ops.rms_norm(x, p["norm2"],
                                                    c["norm_eps"]), prec)


def gqa_flops(c, ctx_len: float) -> float:
    H, KV, hd, d = c["num_heads"], c["num_kv_heads"], c["head_dim"], \
        c["d_model"]
    proj = 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d
    score = 2 * 2 * (ctx_len * 0.5) * H * hd          # causal: half the pairs
    return proj + score


def mlp_flops(c) -> float:
    return 2 * c["d_model"] * c["d_ff"] * (3 if c["activation"] == "silu"
                                           else 2)


def leaves(c) -> list:
    return attn_block(("dense_layers",), c, c["dtype"], c["num_layers"])


def units(c) -> list:
    return [Unit(block, ((("dense_layers",), i),))
            for i in range(c["num_layers"])]


def flops_per_token(c, seq: int) -> float:
    return c["num_layers"] * (gqa_flops(c, seq) + mlp_flops(c))
