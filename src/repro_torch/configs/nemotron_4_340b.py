"""Nemotron-4-340B [arXiv:2402.16819; unverified] — dense, GQA kv=8, squared-ReLU."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab_size=256_000,
    activation="relu2",   # squared ReLU, non-gated MLP
    rope_theta=10_000.0,
))
