"""Zamba2-7B-Instruct [hf:Zyphra/Zamba2-7B-Instruct config.json; the
layer equations of transformers 4.57.6 `models/zamba2/modeling_zamba2.py`]
-- 81 Mamba2 layers and two shared transformer blocks, invoked 13 times.

Invocation i, before Mamba layer l = shared_block_layers[i], uses block
i mod 2, its own adapter and its own linear; x is the stream, e the
embedding's output:

  t = linear_i(MLP_i(RMSNorm(attention(RMSNorm(concat(x, e))))))
  x = x + Mamba_l(RMSNorm(x + t))

with attention from the 7,168-wide concat into 32 heads of 224 (scale
(224/2)^-1/2), the MLP's gate_up plus invocation i's LoRA (rank 128),
gated exact GELU, and each Mamba2 gated RMSNorm over its 2 groups.
The embeddings are tied (`transformers`' default: the config names no
`tie_word_embeddings`)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b-instruct",
    family="zamba2",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,         # attention_head_dim: 2 · 3,584 / 32
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,      # -> 112 SSD heads
    ssm_ngroups=2,
    ssm_chunk=256,
    conv_width=4,
    ssm_grouped_norm=True,
    # the published hybrid_layer_ids and num_mem_blocks
    shared_block_layers=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_shared_blocks=2,
    adapter_rank=128,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    norm_eps=1e-5,
))
