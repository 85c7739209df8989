"""hybrid: Mamba2 layers, stacked under "layers", and one attention +
MLP block of the dense family ("shared_attn", its weights shared)
applied before every `attn_every`-th layer."""
from __future__ import annotations

from reference import ops
from reference.families import dense
from reference.models import Leaf, Unit, mat


def mamba_block(c, ps, x, e, prec):
    (p,) = ps
    return x + ops.mamba(c, p["mixer"], ops.rms_norm(x, p["norm"],
                                                    c["norm_eps"]), prec)


def mamba_flops(c) -> float:
    d = c["d_model"]
    di = c["ssm_expand"] * d
    g, ds, hd = c["ssm_ngroups"], c["ssm_state"], c["ssm_head_dim"]
    nh, Q = di // hd, c["ssm_chunk"]
    proj = 2 * d * (2 * di + 2 * g * ds + nh) + 2 * di * d
    ssd = (2 * Q * g * ds              # C·Bᵀ within the chunk
           + 2 * Q * nh * hd           # M·X
           + 2 * nh * hd * ds          # chunk state
           + 2 * nh * hd * ds)         # the state read back
    return proj + ssd


def leaves(c) -> list:
    dt, d, L = c["dtype"], c["d_model"], c["num_layers"]
    di = c["ssm_expand"] * d
    g, ds = c["ssm_ngroups"], c["ssm_state"]
    nh, W = di // c["ssm_head_dim"], c["conv_width"]
    conv = di + 2 * g * ds
    m = ("layers", "mixer")
    return [Leaf(("layers", "norm"), (L, d), dt, "ones", stacked=True),
            mat(m + ("in_proj",), (L, d, 2 * di + 2 * g * ds + nh), dt,
                stacked=True),
            mat(m + ("conv_w",), (L, W, conv), dt, 0.5, stacked=True),
            Leaf(m + ("conv_b",), (L, conv), dt, "zeros", stacked=True),
            Leaf(m + ("A_log",), (L, nh), "float32", "a_log", stacked=True),
            Leaf(m + ("D",), (L, nh), "float32", "ones", stacked=True),
            Leaf(m + ("dt_bias",), (L, nh), "float32", "dt_bias",
                 stacked=True),
            Leaf(m + ("out_norm",), (L, di), dt, "ones", stacked=True),
            mat(m + ("out_proj",), (L, di, d), dt, stacked=True)] \
        + dense.attn_block(("shared_attn",), c, dt)


def units(c) -> list:
    L, k = c["num_layers"], c["attn_every"]
    out = []
    for s in range(0, L, k):
        out.append(Unit(dense.block, ((("shared_attn",), None),)))
        out += [Unit(mamba_block, ((("layers",), i),))
                for i in range(s, min(s + k, L))]
    return out


def flops_per_token(c, seq: int) -> float:
    L = c["num_layers"]
    n_attn = len(range(0, L, c["attn_every"]))
    return L * mamba_flops(c) + n_attn * (dense.gqa_flops(c, seq)
                                          + dense.mlp_flops(c))
