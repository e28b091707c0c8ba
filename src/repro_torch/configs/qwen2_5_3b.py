"""Qwen2.5 3B — dense GQA decoder with QKV bias.

Assigned spec: 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
[hf:Qwen/Qwen2.5-0.5B family card]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    mlp_act="swiglu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)
