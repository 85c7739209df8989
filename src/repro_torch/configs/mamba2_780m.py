"""Mamba2-780M [arXiv:2405.21060; unverified] — SSD (state-space duality), attention-free."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,      # -> 48 SSD heads
    ssm_ngroups=1,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
))
