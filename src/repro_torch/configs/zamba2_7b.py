"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 backbone + shared attention blocks."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14_336,          # shared-attention block MLP width
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,      # -> 112 SSD heads
    ssm_ngroups=2,
    ssm_chunk=256,
    conv_width=4,
    attn_every=6,         # shared attention block applied every 6 layers
))
