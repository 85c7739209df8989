"""DeepSeek-V3 671B [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed top-8, MTP."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,      # MLA: all heads share one compressed latent cache
    d_ff=18_432,           # dense-MLP width for the first_dense_layers
    vocab_size=129_280,
    num_experts=256,
    num_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    first_dense_layers=3,
    # MLA geometry (paper table 1)
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,          # qk_nope + qk_rope
    mtp_depth=1,
    activation="silu",
))
