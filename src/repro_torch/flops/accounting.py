"""Application-level FLOPs accounting (the "App MFU" side of the paper).

Counts matmul FLOPs (2mnk) per layer type, the convention shared by PaLM /
Megatron / OpenAI scaling laws (paper §IV-E).  Non-matmul (VPU) work is
tallied separately to quantify the paper's *non-tensor undercounting* term —
which is material for SSM archs (DESIGN.md §2).

Variants reproduce the production miscalculations of paper §V-C:
  exact        — correct per-layer-type accounting
  naive_moe    — assumes experts operate at the full hidden dim, ignoring
                 latent down-projection (the 288-GPU case: ~3x inflation)
  naive_hybrid — counts every layer as attention + dense MLP (the hybrid
                 Mamba case: Mamba/MoE layers miscounted)

All figures are per *global* step for a (cfg, shape) cell.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig, ShapeSpec


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Per-expert slot count of a routing group (the MoE layer's
    capacity rule), counted because slots are computed whether full or
    not."""
    c = int(tokens_per_group * cfg.top_k / cfg.num_experts
            * cfg.capacity_factor)
    # round to an MXU-friendly multiple where it matters, keep >= top_k
    c = max(c, cfg.top_k)
    return -(-c // 8) * 8


@dataclass
class Breakdown:
    """FLOPs by category.  mxu: matmul work; vpu: vector-unit work."""

    mxu: dict = field(default_factory=dict)
    vpu: dict = field(default_factory=dict)

    def add(self, cat: str, flops: float, unit: str = "mxu"):
        d = self.mxu if unit == "mxu" else self.vpu
        d[cat] = d.get(cat, 0.0) + flops

    @property
    def total_mxu(self) -> float:
        return sum(self.mxu.values())

    @property
    def total_vpu(self) -> float:
        return sum(self.vpu.values())

    @property
    def total(self) -> float:
        return self.total_mxu + self.total_vpu

    def scaled(self, f: float) -> "Breakdown":
        return Breakdown({k: v * f for k, v in self.mxu.items()},
                         {k: v * f for k, v in self.vpu.items()})

    def merged(self, other: "Breakdown") -> "Breakdown":
        out = Breakdown(dict(self.mxu), dict(self.vpu))
        for k, v in other.mxu.items():
            out.mxu[k] = out.mxu.get(k, 0) + v
        for k, v in other.vpu.items():
            out.vpu[k] = out.vpu.get(k, 0) + v
        return out


# ---------------------------------------------------------------------------
# per-layer forward FLOPs, per token (context length ctx for attention)
# ---------------------------------------------------------------------------
def _gqa_flops(cfg: ModelConfig, ctx_len: float, causal: bool,
               d_in: int = 0) -> dict:
    """q, k, v from inputs d_in wide (d_model when 0), o to d_model."""
    H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    eff = ctx_len * (0.5 if causal else 1.0)
    return {
        "attn_proj": 2 * (d_in or d) * (H + 2 * KV) * hd + 2 * H * hd * d,
        "attn_score": 2 * 2 * eff * H * hd,
    }


def _mla_flops(cfg: ModelConfig, ctx_len: float, causal: bool) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    eff = ctx_len * (0.5 if causal else 1.0)
    proj = (2 * d * qr + 2 * qr * H * (dn + dr)          # q path
            + 2 * d * (kvr + dr) + 2 * kvr * H * (dn + dv)  # kv path
            + 2 * H * dv * d)                            # out
    score = 2 * eff * H * (dn + dr) + 2 * eff * H * dv
    return {"attn_proj": proj, "attn_score": score}


def _mla_decode_flops(cfg: ModelConfig, ctx_len: float) -> dict:
    """Absorbed-MLA decode: attention runs in latent space (kvr + dr wide)."""
    d, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    proj = (2 * d * qr + 2 * qr * H * (dn + dr)
            + 2 * d * (kvr + dr)
            + 2 * H * dn * kvr          # absorb w_k into q
            + 2 * H * kvr * dv          # absorb w_v out of o_latent
            + 2 * H * dv * d)
    score = 2 * ctx_len * H * (kvr + dr) + 2 * ctx_len * H * kvr
    return {"attn_proj": proj, "attn_score": score}


def _mlp_flops(cfg: ModelConfig, d_ff: int, d_in: int = 0) -> float:
    d = d_in or cfg.d_model
    n_mats = 3 if cfg.activation in ("silu", "geglu") else 2
    return 2 * d * d_ff * n_mats


def _zamba2_invocation_flops(cfg: ModelConfig, ctx_len: float,
                             causal: bool) -> dict:
    """One invocation of a zamba2 shared block a token: attention from
    the 2·d-wide concat, the MLP, its adapter and its linear."""
    d, r = cfg.d_model, cfg.adapter_rank
    return {**_gqa_flops(cfg, ctx_len, causal, d_in=2 * d),
            "mlp": _mlp_flops(cfg, cfg.d_ff),
            "adapter": 2 * d * r + 2 * r * 2 * cfg.d_ff,
            "shared_linear": 2 * d * d}


def _moe_flops(cfg: ModelConfig, variant: str, executed: bool) -> dict:
    d, E = cfg.d_model, cfg.num_experts
    out = {"router": 2 * d * E}
    if variant == "naive_moe":
        # paper §V-C case 1: counter assumes experts run at full hidden width
        # (here: ignores fine-grained expert width AND latent routing) —
        # each routed expert billed as a full dense MLP of width cfg.d_ff*? .
        # The production bug billed hidden=2048 vs latent=512 (~3-4x / expert).
        out["experts"] = cfg.top_k * _mlp_flops(cfg, cfg.d_ff_expert * 4)
    else:
        pad = 1.0
        if executed:
            # capacity padding: slots are computed whether full or not
            C = capacity(cfg, 4096)
            pad = C * E / (4096 * cfg.top_k)
        out["experts"] = cfg.top_k * _mlp_flops(cfg, cfg.d_ff_expert) * pad
    if cfg.num_shared_experts:
        out["shared_experts"] = _mlp_flops(
            cfg, cfg.d_ff_expert * cfg.num_shared_experts)
    return out


def _mamba_flops(cfg: ModelConfig, decode: bool = False) -> tuple[dict, dict]:
    """Returns (mxu, vpu) per token for one Mamba2 block."""
    d, di = cfg.d_model, cfg.d_inner
    nh, hd, g, ds = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                     cfg.ssm_state)
    Q = cfg.ssm_chunk
    conv_dim = di + 2 * g * ds
    mxu = {
        "ssm_proj": 2 * d * (2 * di + 2 * g * ds + nh) + 2 * di * d,
    }
    if decode:
        # recurrent step: outer product + contraction, VPU-ish but counted
        vpu_ssd = 2 * nh * hd * ds * 3
        mxu["ssd"] = 0.0
        vpu = {"ssd_step": vpu_ssd, "conv": 2 * cfg.conv_width * conv_dim,
               "gating": 10 * di}
        return mxu, vpu
    # chunked SSD per token: CB (Q*g*ds) + M@x (Q*hd per head pair) +
    # state build + state read (outer products)
    mxu["ssd"] = (2 * Q * g * ds          # C·Bᵀ within chunk
                  + 2 * Q * nh * hd / Q * Q  # (M @ x): Q mults per out elem
                  + 2 * nh * hd * ds       # chunk-state build
                  + 2 * nh * hd * ds)      # inter-chunk read (C·h)
    vpu = {"conv": 2 * cfg.conv_width * conv_dim,
           "ssd_decay": 6 * Q * nh,        # segsum/exp decay matrices
           "gating": 10 * di}
    return mxu, vpu


# ---------------------------------------------------------------------------
# whole-model forward, per global step
# ---------------------------------------------------------------------------
def forward_flops(cfg: ModelConfig, shape: ShapeSpec, *,
                  variant: str = "exact", executed: bool = False) -> Breakdown:
    """Forward-pass FLOPs for one global batch (train/prefill kinds)."""
    B, S = shape.global_batch, shape.seq_len
    N = B * S  # tokens
    bd = Breakdown()
    L = cfg.num_layers

    def add_layer(per_tok: dict, n_layers: int, unit="mxu", tokens=N):
        for k, v in per_tok.items():
            bd.add(k, v * n_layers * tokens, unit)

    if cfg.family in ("dense", "vlm"):
        add_layer(_gqa_flops(cfg, S, True), L)
        add_layer({"mlp": _mlp_flops(cfg, cfg.d_ff)}, L)
    elif cfg.family == "moe":
        nd = cfg.first_dense_layers
        add_layer(_gqa_flops(cfg, S, True), L)
        add_layer({"mlp": _mlp_flops(cfg, cfg.d_ff * 8)}, nd)  # dense lead-in
        for k, v in _moe_flops(cfg, variant, executed).items():
            bd.add(k, v * (L - nd) * N)
    elif cfg.family == "mla_moe":
        nd = cfg.first_dense_layers
        if variant == "naive_moe":
            # §V-C: latent projections not accounted — bills full MHA
            add_layer(_gqa_flops(cfg, S, True), L)
        else:
            add_layer(_mla_flops(cfg, S, True), L)
        add_layer({"mlp": _mlp_flops(cfg, cfg.d_ff)}, nd)
        for k, v in _moe_flops(cfg, variant, executed).items():
            bd.add(k, v * (L - nd) * N)
        if cfg.mtp_depth and shape.kind == "train":
            # MTP: one extra block + head over all tokens
            mtp = Breakdown()
            for k, v in _mla_flops(cfg, S, True).items():
                mtp.add(k, v * N)
            for k, v in _moe_flops(cfg, variant, executed).items():
                mtp.add(k, v * N)
            mtp.add("mtp_proj", 2 * 2 * cfg.d_model * cfg.d_model * N)
            mtp.add("lm_head", 2 * cfg.d_model * cfg.vocab_size * N)
            bd = bd.merged(mtp)
    elif cfg.family == "ssm":
        mxu, vpu = _mamba_flops(cfg)
        add_layer(mxu, L)
        add_layer(vpu, L, unit="vpu")
    elif cfg.family == "hybrid":
        if variant == "naive_hybrid":
            # §V-C case 2: every layer billed as attention + dense MLP
            add_layer(_gqa_flops(cfg, S, True), L)
            add_layer({"mlp": _mlp_flops(cfg, cfg.d_ff)}, L)
        else:
            mxu, vpu = _mamba_flops(cfg)
            add_layer(mxu, L)
            add_layer(vpu, L, unit="vpu")
            n_attn = len(range(0, L, cfg.attn_every))
            add_layer(_gqa_flops(cfg, S, True), n_attn)
            add_layer({"mlp": _mlp_flops(cfg, cfg.d_ff)}, n_attn)
    elif cfg.family == "zamba2":
        mxu, vpu = _mamba_flops(cfg)
        add_layer(mxu, L)
        add_layer(vpu, L, unit="vpu")
        add_layer(_zamba2_invocation_flops(cfg, S, True),
                  len(cfg.shared_block_layers))
    elif cfg.family == "encdec":
        Ne = B * cfg.encoder_seq
        add_layer(_gqa_flops(cfg, cfg.encoder_seq, False), cfg.encoder_layers,
                  tokens=Ne)
        add_layer({"mlp": _mlp_flops(cfg, cfg.d_ff)}, cfg.encoder_layers,
                  tokens=Ne)
        # decoder: self + cross + mlp
        add_layer(_gqa_flops(cfg, S, True), L)
        H, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
        cross_kv = 2 * d * 2 * cfg.num_kv_heads * hd * Ne * L
        bd.add("cross_proj", cross_kv)
        add_layer({"cross_proj": 2 * d * H * hd + 2 * H * hd * d,
                   "cross_score": 2 * 2 * cfg.encoder_seq * H * hd}, L)
        add_layer({"mlp": _mlp_flops(cfg, cfg.d_ff)}, L)
    else:
        raise ValueError(cfg.family)

    if cfg.family == "vlm":
        bd.add("mm_connector", 2 * cfg.d_model ** 2 * B * cfg.num_image_tokens)

    bd.add("lm_head", 2 * cfg.d_model * cfg.vocab_size * N)
    # norms / residuals / softmax: VPU
    bd.add("norms", 12 * cfg.d_model * N * max(L, 1), "vpu")
    return bd


def train_step_flops(cfg: ModelConfig, shape: ShapeSpec, *,
                     variant: str = "exact", executed: bool = False,
                     remat: bool = True) -> Breakdown:
    """Train step = F forward + 2F backward (+F recompute when remat).

    Paper §VI-C: frameworks that miss the remat term under-report FLOPs by
    F/3 — the world-foundation-model case (26% -> 33% MFU after fixing).
    """
    fwd = forward_flops(cfg, shape, variant=variant, executed=executed)
    mult = 4.0 if (remat and executed) else 3.0
    if variant == "no_remat_accounting":
        mult = 3.0  # the buggy counter: ignores recompute even when remat on
    return fwd.scaled(mult)


def decode_step_flops(cfg: ModelConfig, shape: ShapeSpec, *,
                      variant: str = "exact") -> Breakdown:
    """One decode step (B new tokens, context length = shape.seq_len)."""
    B, S = shape.global_batch, shape.seq_len
    bd = Breakdown()
    L = cfg.num_layers

    def add(per_tok: dict, n_layers: int, unit="mxu"):
        for k, v in per_tok.items():
            bd.add(k, v * n_layers * B, unit)

    ctx = S  # decode attends to the full cache
    if cfg.family in ("dense", "vlm"):
        add(_gqa_flops(cfg, ctx, False), L)
        add({"mlp": _mlp_flops(cfg, cfg.d_ff)}, L)
    elif cfg.family == "moe":
        nd = cfg.first_dense_layers
        add(_gqa_flops(cfg, ctx, False), L)
        add({"mlp": _mlp_flops(cfg, cfg.d_ff * 8)}, nd)
        for k, v in _moe_flops(cfg, variant, False).items():
            bd.add(k, v * (L - nd) * B)
    elif cfg.family == "mla_moe":
        nd = cfg.first_dense_layers
        add(_mla_decode_flops(cfg, ctx), L)
        add({"mlp": _mlp_flops(cfg, cfg.d_ff)}, nd)
        for k, v in _moe_flops(cfg, variant, False).items():
            bd.add(k, v * (L - nd) * B)
    elif cfg.family == "ssm":
        mxu, vpu = _mamba_flops(cfg, decode=True)
        add(mxu, L)
        add(vpu, L, unit="vpu")
    elif cfg.family == "hybrid":
        mxu, vpu = _mamba_flops(cfg, decode=True)
        add(mxu, L)
        add(vpu, L, unit="vpu")
        n_attn = len(range(0, L, cfg.attn_every))
        add(_gqa_flops(cfg, ctx, False), n_attn)
        add({"mlp": _mlp_flops(cfg, cfg.d_ff)}, n_attn)
    elif cfg.family == "encdec":
        add(_gqa_flops(cfg, ctx, False), L)
        H, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
        add({"cross_proj": (2 * d * H * hd + 2 * H * hd * d
                            + 2 * d * 2 * cfg.num_kv_heads * hd
                            * cfg.encoder_seq),
             "cross_score": 2 * 2 * cfg.encoder_seq * H * hd}, L)
        add({"mlp": _mlp_flops(cfg, cfg.d_ff)}, L)
    else:
        raise ValueError(f"no decode FLOPs for the {cfg.family} family")

    bd.add("lm_head", 2 * cfg.d_model * cfg.vocab_size * B)
    bd.add("norms", 12 * cfg.d_model * B * max(L, 1), "vpu")
    return bd


def step_flops(cfg: ModelConfig, shape: ShapeSpec, **kw) -> Breakdown:
    if shape.kind == "train":
        return train_step_flops(cfg, shape, **kw)
    if shape.kind == "prefill":
        kw.pop("remat", None)
        return forward_flops(cfg, shape, **kw)
    kw.pop("remat", None)
    kw.pop("executed", None)
    return decode_step_flops(cfg, shape, **kw)


# ---------------------------------------------------------------------------
# parameter counts & the 6·N·D convention
# ---------------------------------------------------------------------------
def param_count_analytic(cfg: ModelConfig, active_only: bool = False) -> float:
    """Matmul parameter count (embeddings excluded from the 6ND convention)."""
    d, L = cfg.d_model, cfg.num_layers
    n = 0.0
    per_mlp = (3 if cfg.activation in ("silu", "geglu") else 2)

    def attn_params():
        if cfg.family == "mla_moe":
            return (d * cfg.q_lora_rank
                    + cfg.q_lora_rank * cfg.num_heads
                    * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                    + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                    + cfg.kv_lora_rank * cfg.num_heads
                    * (cfg.qk_nope_dim + cfg.v_head_dim)
                    + cfg.num_heads * cfg.v_head_dim * d)
        return d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
            + cfg.num_heads * cfg.head_dim * d

    def mamba_params():
        return d * (2 * cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
                    + cfg.ssm_nheads) + cfg.d_inner * d

    if cfg.family in ("dense", "vlm"):
        n += L * (attn_params() + per_mlp * d * cfg.d_ff)
    elif cfg.family in ("moe", "mla_moe"):
        nd = cfg.first_dense_layers
        n += L * attn_params()
        ff_dense = cfg.d_ff * (8 if cfg.family == "moe" else 1)
        n += nd * per_mlp * d * ff_dense
        e = cfg.top_k if active_only else cfg.num_experts
        n += (L - nd) * (e + cfg.num_shared_experts) \
            * per_mlp * d * cfg.d_ff_expert
        n += (L - nd) * d * cfg.num_experts  # router
    elif cfg.family == "ssm":
        n += L * mamba_params()
    elif cfg.family == "hybrid":
        n += L * mamba_params()
        n += attn_params() + per_mlp * d * cfg.d_ff  # ONE shared block
    elif cfg.family == "zamba2":
        n += L * mamba_params()
        # the shared blocks (q, k, v from 2·d), each invocation's adapter
        # and linear
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        n += cfg.num_shared_blocks * (2 * d * (H + 2 * KV) * hd + H * hd * d
                                   + per_mlp * d * cfg.d_ff)
        n += len(cfg.shared_block_layers) * (
            d * cfg.adapter_rank + cfg.adapter_rank * 2 * cfg.d_ff + d * d)
    elif cfg.family == "encdec":
        n += cfg.encoder_layers * (attn_params() + per_mlp * d * cfg.d_ff)
        n += L * (attn_params() * 2 + per_mlp * d * cfg.d_ff)
    n += d * cfg.vocab_size  # lm head
    return n


def model_flops_6nd(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per global step."""
    if shape.kind == "decode":
        tokens = shape.global_batch
        return 2 * param_count_analytic(cfg, active_only=True) * tokens
    tokens = shape.global_batch * shape.seq_len
    mult = 6 if shape.kind == "train" else 2
    return mult * param_count_analytic(cfg, active_only=True) * tokens
