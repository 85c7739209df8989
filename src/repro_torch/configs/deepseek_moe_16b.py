"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — fine-grained MoE, 2 shared + 64 routed top-6."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,            # per-expert FFN width (fine-grained)
    vocab_size=102_400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    first_dense_layers=1,  # layer 0 is a dense MLP (d_ff = 4*... use 10944)
    activation="silu",
))
