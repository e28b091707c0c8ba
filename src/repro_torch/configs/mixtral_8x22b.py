"""Mixtral 8x22B — sparse MoE with sliding-window attention.

Assigned spec: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, SWA. [arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    moe_layer_period=1,      # every layer is MoE
    sliding_window=4096,     # Mixtral-style SWA
    rope_theta=1e6,
    mlp_act="swiglu",
    source="arXiv:2401.04088",
)
