"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B family; unverified] — small llama3, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128_256,
    tie_embeddings=True,
    activation="silu",
    rope_theta=500_000.0,
))
