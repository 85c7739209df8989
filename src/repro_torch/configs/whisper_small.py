"""Whisper-small [arXiv:2212.04356; unverified] — enc-dec; conv frontend is a STUB
(input_specs provides precomputed 1500-frame embeddings)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    activation="gelu",
))
