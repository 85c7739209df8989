"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base; hf] — dense, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    tie_embeddings=True,
    activation="silu",
))
