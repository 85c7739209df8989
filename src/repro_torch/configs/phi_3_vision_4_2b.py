"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf] — phi3-mini
backbone; CLIP patch frontend is a STUB (input_specs provides patch embeddings)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    num_image_tokens=576,   # 24x24 CLIP-L patch grid (stubbed)
    activation="silu",
))
