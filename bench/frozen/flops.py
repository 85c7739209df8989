"""Model FLOPs of a step: matrix-product work, 2·m·n·k, by layer type,
per token, times the tokens (the PaLM / Megatron convention).  A frozen
copy of the program's `flops.accounting` rules for the dense and hybrid
families, read from a configuration file's "as_run" sizes, so that a
change to the program's counts cannot move `mfu.*`.

A train step is a forward and a backward of twice its work, 3 F; the
recompute of rematerialised layers is not model work and is left out.
"""
from __future__ import annotations


def _gqa(c, ctx_len: float) -> float:
    H, KV, hd, d = c["num_heads"], c["num_kv_heads"], c["head_dim"], \
        c["d_model"]
    proj = 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d
    score = 2 * 2 * (ctx_len * 0.5) * H * hd          # causal: half the pairs
    return proj + score


def _mlp(c) -> float:
    return 2 * c["d_model"] * c["d_ff"] * (3 if c["activation"] == "silu"
                                           else 2)


def _mamba(c) -> float:
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


def forward_flops(c: dict, batch: int, seq: int) -> float:
    """Matrix-product FLOPs of one forward over batch × seq tokens."""
    L, n = c["num_layers"], batch * seq
    if c["family"] == "dense":
        per_tok = L * (_gqa(c, seq) + _mlp(c))
    elif c["family"] == "hybrid":
        n_attn = len(range(0, L, c["attn_every"]))
        per_tok = L * _mamba(c) + n_attn * (_gqa(c, seq) + _mlp(c))
    else:
        raise ValueError(c["family"])
    return (per_tok + 2 * c["d_model"] * c["vocab_size"]) * n


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(c, batch, seq)
