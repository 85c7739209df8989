"""Model/shape configuration system.

Every assigned architecture is a `ModelConfig` (exact published numbers) plus a
`smoke()` reduction of the same family for CPU tests.  Input shapes are the four
assigned (seq_len, global_batch, kind) cells; `input_specs()` and
`cache_specs()` give meta-device stand-ins (no allocation) and
`make_inputs()` the seeded inputs themselves.  The fleet path reads the
configs to derive step FLOPs and job profiles.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  Families:

    dense    -- GQA transformer (llama/qwen/granite/nemotron)
    moe      -- fine-grained MoE w/ shared experts (deepseek-moe)
    mla_moe  -- MLA attention + MoE + MTP (deepseek-v3)
    ssm      -- Mamba2 / SSD, attention-free
    hybrid   -- Mamba2 backbone + periodic shared attention (zamba2-7b)
    zamba2   -- Mamba2 backbone + shared transformer blocks invoked before
                the layers `shared_block_layers` names (Zamba2-7B-Instruct)
    encdec   -- encoder-decoder (whisper; conv frontend stubbed)
    vlm      -- dense backbone + patch-embedding stub frontend (phi-3-vision)
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # deepseek: leading dense MLP layers

    # --- MLA (deepseek-v3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0  # multi-token-prediction blocks

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    attn_every: int = 0  # hybrid: shared attention block every N layers
    ssm_grouped_norm: bool = False  # the gated RMSNorm in ssm_ngroups groups

    # --- zamba2: shared blocks invoked before the layers named ---
    shared_block_layers: tuple = ()  # invocation i runs before layer [i]
    num_shared_blocks: int = 0       # invocation i uses block i mod this
    adapter_rank: int = 0            # invocation i's own LoRA on gate_up

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper 30s audio -> 1500 frames (stub frontend)

    # --- vlm (phi-3-vision) ---
    num_image_tokens: int = 0

    # --- misc ---
    qk_norm: bool = False
    activation: str = "silu"  # silu | gelu | relu2 | geglu
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # remat policy: "nothing" | "dots" | "none"
    remat: str = "nothing"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived ----
    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k is runnable (SSM/hybrid: O(1)-state decode)."""
        return self.family in ("ssm", "hybrid")

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False  # pure full-attention archs skip long-context decode
        return True

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.num_experts:
            kw.update(num_experts=4, top_k=2, d_ff_expert=32,
                      num_shared_experts=min(self.num_shared_experts, 1),
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.q_lora_rank or self.kv_lora_rank:
            kw.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
                      qk_nope_dim=8, v_head_dim=16, head_dim=16)
        if self.mtp_depth:
            kw.update(mtp_depth=1)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
        if self.attn_every:
            kw.update(attn_every=2, num_layers=4)
        if self.shared_block_layers:
            # the block reads concat(x, e): heads of 2·d / H, as published;
            # two invocations a block, so a block's gradient sums over
            # several
            kw.update(num_layers=5, shared_block_layers=(1, 2, 3, 4),
                      adapter_rank=8,
                      head_dim=2 * kw["d_model"] // kw["num_heads"])
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=16)
        if self.num_image_tokens:
            kw.update(num_image_tokens=4)
        return replace(self, name=self.name + "-smoke", **kw)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # import side-effect registers each arch
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe_16b, deepseek_v3_671b, qwen3_4b, nemotron_4_340b,
        granite_3_2b, llama3_2_3b, whisper_small, phi_3_vision_4_2b,
        mamba2_780m, zamba2_7b, zamba2_7b_instruct,
    )


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins, no allocation)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors standing in for every model input of one (arch, shape)
    cell, in the reference's order, shapes and dtypes.

    train/prefill : tokens + labels (+ frontend stubs)
    decode        : one new token per sequence + the KV/SSM caches at seq_len
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f = getattr(torch, cfg.dtype)

    if shape.kind in ("train", "prefill"):
        # VLM: image patches occupy the first num_image_tokens positions of the
        # assigned seq_len, so total sequence length stays exactly S.
        S_txt = S - cfg.num_image_tokens if cfg.family == "vlm" else S
        specs = {"tokens": _meta((B, S_txt), i32)}
        if shape.kind == "train":
            specs["labels"] = _meta((B, S), i32)
        if cfg.family == "vlm":
            # modality frontend is a STUB: precomputed patch embeddings
            specs["patch_embeds"] = _meta((B, cfg.num_image_tokens,
                                           cfg.d_model), f)
        if cfg.family == "encdec":
            # conv frontend stub: precomputed mel-frame embeddings
            specs["frame_embeds"] = _meta((B, cfg.encoder_seq, cfg.d_model), f)
        return specs

    # ---- decode: one new token against caches of length S ----
    specs = {"tokens": _meta((B, 1), i32), "cache_index": _meta((), i32)}
    specs.update(cache_specs(cfg, B, S, f))
    if cfg.family == "encdec":
        specs["encoder_out"] = _meta((B, cfg.encoder_seq, cfg.d_model), f)
    return specs


def cache_specs(cfg: ModelConfig, B: int, S: int, dt) -> dict:
    """Decode-cache meta tensors (stacked over layers); `dt` is the KV and
    conv caches' dtype, the SSM state is always float32."""
    L = cfg.num_layers
    specs: dict = {}
    if cfg.family in ("dense", "moe", "mla_moe", "vlm", "encdec", "hybrid"):
        if cfg.family == "mla_moe":
            # MLA compressed cache: latent c_kv + decoupled rope key
            specs["kv_cache"] = _meta(
                (L, B, S, cfg.kv_lora_rank + cfg.qk_rope_dim), dt)
        else:
            nl = (len(range(0, L, cfg.attn_every)) if cfg.family == "hybrid"
                  else L)
            for name in ("k_cache", "v_cache"):
                specs[name] = _meta((nl, B, S, cfg.num_kv_heads,
                                     cfg.head_dim), dt)
    if cfg.family in ("ssm", "hybrid"):
        specs["ssm_state"] = _meta((L, B, cfg.ssm_nheads, cfg.ssm_head_dim,
                                    cfg.ssm_state), torch.float32)
        specs["conv_state"] = _meta(
            (L, B, cfg.conv_width - 1,
             cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state), dt)
    return specs


def make_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                device=None) -> dict:
    """Materialized inputs on `device` (the card unless "cpu" is named):
    the reference's NumPy draws in the reference's order, so both packages
    get the same values bitwise.  Floats go f64 -> f32 -> the model dtype,
    as the reference's cast does with 64-bit mode off."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if not s.dtype.is_floating_point:
            if k == "cache_index":
                a = np.asarray(min(shape.seq_len - 1, 7))
            else:
                a = rng.integers(0, cfg.vocab_size, s.shape)
            t = torch.from_numpy(a.astype(np.int32))
        else:
            a = rng.standard_normal(s.shape) * 0.02
            t = torch.from_numpy(a.astype(np.float32)).to(s.dtype)
        out[k] = t.to(device)
    return out
